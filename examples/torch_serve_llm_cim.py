"""Serve a smoke-scale LLM with CIM-quantized weights on the PyTorch port:
batched prefill + decode through the KV cache, bypass-vs-CIM agreement.

Counterpart of `examples/serve_llm_cim.py`.  The weights and the prompt
are drawn from `repro_torch.core.prng` (JAX's threefry bit for bit), so on
the CPU this prints `examples/serve_llm_cim.py`'s samples.

  PYTHONPATH=src python examples/torch_serve_llm_cim.py --arch granite-8b \\
      [--device cpu]

Runs on the card unless `--device` names another device.
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as tf
from repro_torch.runtime import program_cache_stats

MODES = ("bypass", "fakequant", "engine")


def generate(cfg, params, prompt: torch.Tensor, gen_len: int) -> torch.Tensor:
    """Greedy tokens (B, gen_len + 1): the prefill's next token, then
    gen_len decode steps through the KV cache."""
    cache = tf.init_cache(cfg, prompt.shape[0],
                          max_len=prompt.shape[1] + gen_len + 8,
                          device=prompt.device)
    with torch.no_grad():
        logits, cache, _ = tf.forward(cfg, params, prompt, cache=cache)
        tok = torch.argmax(logits[:, -1:], -1)
        step = make_serve_step(cfg)
        out = [tok]
        for _ in range(gen_len):
            tok, cache = step(params, cache, tok)
            out.append(tok)
    return torch.cat(out, dim=1)


def serve_modes(base, params, prompt: torch.Tensor, gen_len: int,
                modes=MODES) -> dict:
    """{mode: (tokens, seconds)} of `generate` under each CIM mode, with
    the line the JAX example prints for each."""
    out = {}
    for mode in modes:
        cfg = base.replace(cim=CIMConfig(mode=mode, max_gamma=2.0**16))
        t0 = time.time()
        gen = generate(cfg, params, prompt, gen_len)
        if gen.device.type == "cuda":
            torch.cuda.synchronize(gen.device)
        dt = time.time() - t0
        out[mode] = (gen, dt)
        print(f"{mode:10s}: {gen_len * prompt.shape[0] / dt:7.1f} tok/s   "
              f"sample={gen[0, :10].tolist()}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    key = prng.key(0, dev)
    base = get_smoke_config(args.arch)
    params = tf.init_params(base, key)
    prompt = prng.randint(key, (args.batch, 16), 0, base.vocab_size).long()

    # "engine" decodes through the compiled-program runtime: the first step
    # builds the program set, every later step is a cache hit
    out = serve_modes(base, params, prompt, args.gen_len)
    print(f"engine program cache: {program_cache_stats()}")
    return out


if __name__ == "__main__":
    main()
