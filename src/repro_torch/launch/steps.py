"""Step builders: train, prefill and serve.

Counterpart of `repro/launch/steps.py`.  The training state is
{"params": tree, "opt": {"m", "v", "step"}}, plus "err" (a float32 tree
like the params) under gradient compression; a train step computes the
loss and its gradients with autograd, passes them through the
error-feedback int8 round trip when asked (`optim/compression.py`), then
AdamW updates the state in place (`optim/adamw.py`) and returns it with
the step's metrics, as device tensors (reading one waits for the card).  The prefill and serve
steps run the LM forward for serving; the serve step's KV cache is
written in place and returned.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import compression as gc
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.optim.schedules import cosine_schedule

AUX_LOSS_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits (B, S, V) in any float dtype."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(lse - ll)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            key: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token CE plus AUX_LOSS_WEIGHT times the MoE load-balance
    loss (zero for every family but moe), and its parts {"ce",
    "aux"}.  batch["prefix_embeds"] (vlm) and batch["encoder_frames"]
    pass through to forward; for vlm the prefix positions' logits are
    sliced off before the CE.  `key` seeds the CIM noise model when
    cfg.cim.noise is enabled (the JAX package's loss_fn takes none and
    so trains clean under --cim-noise; the port threads it, see ROADMAP
    Queue 3)."""
    kwargs = {k: batch[k] for k in ("prefix_embeds", "encoder_frames")
              if k in batch}
    logits, _, aux = tf.forward(cfg, params, batch["tokens"], key=key,
                                **kwargs)
    if cfg.family == "vlm" and "prefix_embeds" in batch:
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
    ce = cross_entropy(logits, batch["labels"])
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    total_steps: int = 10000, warmup: int = 100,
                    compress_grads: bool = False):
    """Returns train_step(state, batch, key=None) -> (state, metrics).

    The state is updated in place and returned; metrics are {"loss",
    "ce", "aux", "grad_norm", "lr"} as detached device tensors.  `key` is
    the step's noise key (the launcher passes fold_in(key(seed),
    step)).  With `compress_grads` the gradients go through
    `compression.compressed_grads` with state["err"], which takes the new
    error, before AdamW."""

    def train_step(state, batch, key=None):
        params = state["params"]
        leaves = tree_leaves(params)
        loss, parts = loss_fn(cfg, params, batch, key)
        # a leaf the loss does not reach (the ABN params in bypass mode)
        # gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        if compress_grads:
            grads, new_err = gc.compressed_grads(
                grads, tree_leaves(state["err"]))
            state["err"] = tree_unflatten(state["err"], new_err)
        lr_scale = cosine_schedule(state["opt"]["step"], warmup, total_steps)
        _, new_opt, om = adamw_update(
            params, grads, state["opt"], opt_cfg, lr_scale,
            decay_mask=tf.stacked_decay_mask(params))
        state["opt"] = new_opt
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return state, metrics

    return train_step


def train_state(params: Dict, compress_grads: bool = False) -> Dict:
    """A fresh training state over `params`, whose leaves become leaf
    tensors that require grad; with `compress_grads`, a zeroed error
    buffer under "err"."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if compress_grads:
        state["err"] = gc.init_error_buffer(params)
    return state


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     compress_grads: bool = False) -> Dict:
    """Params from `generator` (on its device), zeroed AdamW moments and,
    with `compress_grads`, a zeroed error buffer."""
    return train_state(tf.init_params(cfg, generator), compress_grads)


def make_prefill_step(cfg: ModelConfig):
    """Returns prefill_step(params, batch) -> the last position's logits
    (B, V) of batch["tokens"] (B, S), without a cache.  The vlm and audio
    inputs, batch["prefix_embeds"] / ["encoder_frames"], pass through to
    forward."""
    def prefill_step(params, batch):
        kwargs = {k: batch[k] for k in ("prefix_embeds", "encoder_frames")
                  if k in batch}
        logits, _, _ = tf.forward(cfg, params, batch["tokens"], **kwargs)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, cache, tokens (B, 1)) -> (next tokens
    (B, 1) int64, the greedy argmax of the last logits, and the cache,
    advanced in place)."""
    def serve_step(params, cache, tokens):
        logits, new_cache, _ = tf.forward(cfg, params, tokens, cache=cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        return nxt[:, None], new_cache
    return serve_step
