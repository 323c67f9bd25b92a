"""Training launcher.

Counterpart of `repro/launch/train.py`: the model of `--arch` (or its
smoke config) with CIM-aware projections (`--cim-mode fakequant`), trained
with AdamW on `SyntheticLM` batches.  It runs on CUDA by default and
raises without a card; `--device cpu` runs it on the host, with the
kernels' plain versions.  `--attn-impl pallas` puts the attention on the
hand-written flash kernels (the JAX package's name for its Pallas
kernels), `jnp` on the plain attention.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
      --steps 20 --cim-mode fakequant --attn-impl pallas

The decoder-stack families train: dense, moe (the loss adds
`steps.AUX_LOSS_WEIGHT` times the load-balance loss, printed as aux
beside the CE) and vlm (on text tokens alone, as the JAX launcher's
batches carry no prefix); so do the ssm (mamba2) and hybrid
(recurrentgemma) families, and the audio family (whisper-medium) on
the JAX package's own audio train batch (`repro/launch/specs.py`):
seeded frame embeddings (batch, seq_len, d_model), drawn at step s as
`jax.random.normal(fold_in(PRNGKey(seed), s), ...)` (`audio_frames`),
and tokens and labels of min(max_target_len, seq_len // 8).  (The JAX
launcher feeds it token-only batches, which turn its cross-attention
into self-attention over the labels: ROADMAP Queue 3, reference fault
12.)

`--cim-noise` trains under the post-silicon noise model
(`NoiseConfig()`), with step s drawing under fold_in(key(--seed), s).
The ssm and hybrid families refuse it: their forward takes no noise key
(ValueError, JAX's forward's own).

`--compress-grads` passes each step's gradients through the
error-feedback int8 round trip (`optim/compression.py`; the state gains
"err").  `--ckpt-dir D` runs the steps under the fault-tolerant driver
(`runtime/fault_tolerance.TrainDriver`): a checkpoint every
`--ckpt-every` steps (default 25) and at the end, in JAX's stacked
logical layout (`convert.train_state_to_numpy`), so the JAX package's
`load_checkpoint` restores it and the reverse; a run finds the newest
checkpoint in D and resumes from it.  Each step's noise key is still
fold_in(key(--seed), step), a step run again after a restart included.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.noise_model import NO_NOISE, NoiseConfig, draw_normal
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault_tolerance import FTConfig, TrainDriver


def resolve_device(name: str) -> torch.device:
    """The device a launcher runs on; CUDA must be there when asked
    for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the host")
    return dev


def build(args, n_layers: Optional[int] = None):
    """(cfg, state, step_fn, batch_fn) for the parsed arguments.
    `n_layers` cuts the config's depth before the weights are drawn (a
    state too large to checkpoint at full depth), as serve.build's."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    noise = NoiseConfig() if args.cim_noise else NO_NOISE
    cfg = cfg.replace(cim=CIMConfig(mode=args.cim_mode, max_gamma=2.0**16,
                                    noise=noise),
                      attn_impl=args.attn_impl)
    audio = cfg.family == "audio"
    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=audio_tokens(cfg, args.seq_len) if audio else args.seq_len,
        global_batch=args.batch))

    def batch_fn(step: int):
        toks, labels = data.batch_at(step)
        batch = {"tokens": torch.from_numpy(toks).long().to(dev),
                 "labels": torch.from_numpy(labels).long().to(dev)}
        if audio:
            batch["encoder_frames"] = audio_frames(
                cfg, args.batch, args.seq_len, args.seed, step, dev)
        return batch

    step_fn = make_train_step(
        cfg, AdamWConfig(lr=args.lr), total_steps=args.steps,
        warmup=min(20, args.steps // 10 + 1),
        compress_grads=args.compress_grads)
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed),
        compress_grads=args.compress_grads)
    return cfg, state, step_fn, batch_fn


def make_driver(args, state, step_fn, batch_fn, fault_injector=None,
                keep: int = 3):
    """(driver, run) for `--ckpt-dir`: a TrainDriver keeping the newest
    `keep` checkpoints, which hold JAX's stacked layout, and whose
    restarts build new tensors on the state's device; run() -> (state,
    history) drives the --steps steps.  The driver calls its step with
    (state, (step, batch)), so each step's noise key comes from the step
    it runs."""
    dev = tree_leaves(state["params"])[0].device
    driver = TrainDriver(
        FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 keep=keep),
        lambda st, sb: step_fn(st, sb[1], step_key(args, sb[0])),
        lambda step: (step, batch_fn(step)), state_template=state,
        to_host=convert.train_state_to_numpy,
        from_host=lambda host: convert.train_state_from_numpy(host, dev))
    return driver, lambda: driver.run(state, args.steps,
                                      fault_injector=fault_injector)


def audio_tokens(cfg, seq_len: int) -> int:
    """The decoder length of an audio train batch over `seq_len` frames
    (`repro/launch/specs.py`): min(max_target_len, seq_len // 8)."""
    return min(cfg.max_target_len, seq_len // 8)


def audio_frames(cfg, batch: int, seq_len: int, seed: int, step: int,
                 device) -> torch.Tensor:
    """Step `step`'s frame embeddings (batch, seq_len, d_model) float32:
    jax.random.normal(fold_in(PRNGKey(seed), step), ...), bit for bit
    (the draw kernel on the card)."""
    return draw_normal(prng.fold_in(prng.key(seed), step),
                       (batch, seq_len, cfg.d_model), device)


def step_key(args, step: int):
    """Step `step`'s noise key, fold_in(key(--seed), step), or None when
    --cim-noise is off (a host tensor: keys never wait on the card)."""
    if not args.cim_noise:
        return None
    return prng.fold_in(prng.key(args.seed), step)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cim-mode", default="bypass",
                    choices=["bypass", "fakequant"])
    ap.add_argument("--cim-noise", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/restart through the fault-tolerant "
                    "driver, in this directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--attn-impl", default="jnp", choices=["jnp", "pallas"],
                    help="pallas: the flash kernels; jnp: plain attention")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, state, step_fn, batch_fn = build(args)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M cim={cfg.cim.mode} "
          f"noise={cfg.cim.noise.enabled} attn={cfg.attn_impl} "
          f"device={args.device}")
    if args.ckpt_dir:
        driver, run = make_driver(args, state, step_fn, batch_fn)
        state, history = run()
        print(f"final loss={history[-1].loss:.4f} "
              f"(restarts={driver.restarts})")
        return
    t0 = time.time()
    for step in range(args.steps):
        state, metrics = step_fn(state, batch_fn(step), step_key(args, step))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"aux={float(metrics['aux']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
