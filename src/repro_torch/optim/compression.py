"""Error-feedback int8 gradient compression.

Counterpart of `repro/optim/compression.py`: each leaf of a gradient
tree is quantized to int8 codes with one float32 scale a leaf; the
quantization residual is carried in an error buffer and added back the
next step (Karimireddy et al., 2019).  On a data-parallel mesh the codes
are what the all-reduce would move.

The chain is the one the JAX source writes, in float32, as it runs
eagerly: `scale = max(max|g + err|, 1e-12) / 127` and `gf / scale` are
IEEE divides (both divisors are device tensors: PyTorch's CUDA divide by
a host scalar multiplies by its reciprocal), `torch.round` rounds half
to even as `jnp.round` does, and `gf - q * scale` rounds twice, with no
fused multiply-add.  XLA's jit contracts that subtraction into an FMA and
turns `/ 127` into a multiply (ROADMAP Queue 3, reference fault 13), so
the port is held to JAX under `jax.disable_jit()`.

A gradient tree is a tree of dicts and lists (`optim/adamw.tree_leaves`
order) or the list of its leaves; the error buffer is a tree of float32
tensors on the leaves' devices.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

CODE_MAX = 127.0
SCALE_FLOOR = 1e-12


def init_error_buffer(params) -> Any:
    """A float32 zero tensor like each leaf, on the leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 codes, the float32 0-d scale, the new error)."""
    gf = g.to(torch.float32) + err
    dev = gf.device
    floor = torch.tensor(SCALE_FLOOR, dtype=torch.float32, device=dev)
    top = torch.tensor(CODE_MAX, dtype=torch.float32, device=dev)
    scale = torch.maximum(torch.amax(torch.abs(gf)), floor) / top
    q = torch.clamp(torch.round(gf / scale), -CODE_MAX, CODE_MAX).to(
        torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def compress(grads, err_buf):
    """Quantize a gradient tree: (codes, scales, new error), each a tree
    shaped like `grads`; `err_buf` holds a leaf for each of its leaves."""
    out = [compress_leaf(g, e) for g, e in zip(tree_leaves(grads),
                                               tree_leaves(err_buf))]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


@torch.no_grad()
def decompress(codes, scales):
    """Each leaf's codes times its scale, as float32."""
    return tree_unflatten(codes, [
        q.to(torch.float32) * s
        for q, s in zip(tree_leaves(codes), tree_leaves(scales))])


def compressed_grads(grads, err_buf):
    """The round trip a train step makes: quantize (the all-reduce would
    move the int8 codes), then dequantize.  -> (gradients, new error)."""
    codes, scales, new_err = compress(grads, err_buf)
    return decompress(codes, scales), new_err
