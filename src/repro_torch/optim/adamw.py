"""AdamW (+ global-norm clipping) over parameter trees.

Counterpart of `repro/optim/adamw.py`, arithmetic for arithmetic (not
`torch.optim.AdamW`, which orders the update differently).  A tree is
nested dicts and lists of tensors; leaves are visited in JAX's order
(dict keys sorted, lists in order).  The state mirrors the params:
{"m": tree, "v": tree, "step": int32 scalar tensor}.

Unlike the JAX package's pure update, `adamw_update` writes the new
params and moments into their tensors in place: at OLMo-1B scale the
params, grads and both moments are 19 GB in float32, and a second copy
of each would not fit beside the activations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts and lists, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """`fn` applied to every leaf, in a tree of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def tree_unflatten(template, leaves: Sequence[Any]):
    """A tree shaped like `template` holding `leaves` in `tree_leaves`'
    order (JAX's `treedef.unflatten`)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(t) for t in node]
        return next(it)
    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf."""
    total = 0
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return [g * scale for g in grads], norm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0,
                 decay_mask: Optional[Any] = None) -> Tuple[Any, dict, dict]:
    """One AdamW step: clip `grads` (a tree like `params`, or its leaves
    in order) by global norm, then update the moments and params in place.
    `decay_mask` is a tree of bools like `params` (default: leaves with 2
    or more dimensions).  Returns (params, state, metrics)."""
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    g_leaves, gnorm = clip_by_global_norm(g_leaves, cfg.grad_clip)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=stepf.device)
    if decay_mask is None:
        decay_mask = tree_map(lambda p: p.dim() >= 2, params)
    masks = tree_leaves(decay_mask)
    for p, g, m, v, wd in zip(p_leaves, g_leaves, tree_leaves(state["m"]),
                              tree_leaves(state["v"]), masks):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if wd:
            u = u + cfg.weight_decay * p
        p.copy_(p - lr * u)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
