"""Fault-tolerant ~100M-param pretraining on the PyTorch port: trains an
OLMo-style model for a few hundred steps on the synthetic LM stream with
checkpoint/restart, then kills itself twice mid-run to prove recovery.

Counterpart of `examples/fault_tolerant_pretrain.py`.  The driver is the
training launcher's (`launch/train.make_driver`: JAX's on-disk checkpoint
format, restarts that build new tensors on the state's device), the one
chip_smoke.py's `ft_train` phase runs; the weights are drawn from
`repro_torch.core.prng` (JAX's threefry bit for bit), so on the CPU this
prints `examples/fault_tolerant_pretrain.py`'s parameter count and step
accounting.

  PYTHONPATH=src python examples/torch_fault_tolerant_pretrain.py \\
      [--steps 300] [--d-model 512 --layers 8] [--device cpu]

Runs on the card unless `--device` names another device.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault_tolerance import make_fault_injector


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ft_pretrain"))
    ap.add_argument("--device", default="cuda")
    return ap


def run(args, faults: bool = True):
    """(state, history, driver, n_params) of the run `args` describes,
    with the two injected faults or without them; prints the model's
    size first."""
    dev = torch.device(args.device)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    cfg = get_config("olmo_1b").replace(
        n_layers=args.layers, d_model=args.d_model,
        n_heads=8, n_kv_heads=8, d_ff=4 * args.d_model,
        vocab_size=8192, cim=CIMConfig(mode="bypass"), remat=False)
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq_len,
                                    global_batch=args.batch))

    def batch_fn(step):
        toks, labels = data.batch_at(step)
        return {"tokens": torch.from_numpy(toks).long().to(dev),
                "labels": torch.from_numpy(labels).long().to(dev)}

    step_fn = make_train_step(cfg, AdamWConfig(lr=3e-4),
                              total_steps=args.steps, warmup=30)
    state = init_train_state(cfg, prng.key(0, dev))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"model: {n_params/1e6:.0f}M params "
          f"({args.layers}L x {args.d_model})")
    targs = train.parser().parse_args(
        ["--arch", "olmo-1b", "--steps", str(args.steps), "--ckpt-dir",
         args.ckpt_dir, "--ckpt-every", "50"])
    injector = make_fault_injector({args.steps // 3: 1,
                                    2 * args.steps // 3: 1}) if faults \
        else None
    driver, go = train.make_driver(targs, state, step_fn, batch_fn,
                                   fault_injector=injector)
    state, hist = go()
    return state, hist, driver, n_params


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    state, hist, driver, n_params = run(args)
    first = np.mean([h.loss for h in hist[:20]])
    last = np.mean([h.loss for h in hist[-20:]])
    print(f"steps={len(hist)} restarts={driver.restarts} "
          f"loss {first:.3f} -> {last:.3f}")
    assert driver.restarts == 2 and last < first
    print("fault-tolerant pretraining: OK")
    return {"state": state, "history": hist, "restarts": driver.restarts,
            "first": float(first), "last": float(last)}


if __name__ == "__main__":
    main()
