"""Model assembly for the dense decoder family (OLMo, and any pre-norm
decoder with GQA attention and a gated MLP).

Counterpart of the dense path of `repro/models/transformer.py`: the same
parameter tree and forward, as functions over a dict of tensors.  Where
the JAX package stacks the layers along a leading axis and scans over
them, the port keeps `params["layers"]` as a list of per-layer dicts and
loops; with `cfg.remat` each layer runs under `torch.utils.checkpoint`
(non-reentrant), which recomputes its forward in the backward, as
`jax.checkpoint` does.  Every projection runs through
`core.cim_layers.cim_linear_apply`.

`forward(key=)` seeds the CIM noise model of every projection, folded
as the JAX package folds it (fold_in(key, layer), then 0/1 for the
attention and MLP banks, then one fold per projection); a checkpointed
layer's recompute redraws the same noise from the same key.

Not ported: the moe, hybrid, ssm, vlm and audio families, the KV caches
and decode, and the "dots" remat policy.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.cim_layers import init_cim_linear
from repro_torch.models import common as cm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported (dense only)")


def _attn_cfg(cfg: ModelConfig) -> cm.AttnConfig:
    return cm.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        window=cfg.sliding_window, rope_theta=cfg.rope_theta,
        impl=cfg.attn_impl)


def _init_decoder_layer(cfg: ModelConfig,
                        generator: torch.Generator) -> Dict:
    dev = generator.device
    return {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "attn": cm.init_attention(generator, _attn_cfg(cfg), cfg.cim),
        "mlp": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                           cfg.cim),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """The parameter tree for `cfg` on the generator's device: the
    embedding, one dict per layer under "layers", the final norm and, if
    the head is untied, "lm_head"."""
    _check_family(cfg)
    d = cfg.d_model
    dev = generator.device
    params: Dict = {
        "embed": (d ** -0.5) * torch.randn(
            (cfg.vocab_size, d), generator=generator, device=dev),
        "final_norm": cm.init_norm(d, cfg.norm_type, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_cim_linear(generator, d, cfg.vocab_size)
    params["layers"] = [_init_decoder_layer(cfg, generator)
                        for _ in range(cfg.n_layers)]
    return params


def stacked_decay_mask(params: Dict) -> Dict:
    """Weight-decay mask of AdamW as the JAX package forms it: a leaf is
    decayed when it has 2 or more dimensions *as JAX stores it*, and JAX
    stacks each per-layer leaf along a leading layer axis.  So every
    per-layer leaf (the ABN gains and offsets and the norm scales
    included) is decayed, as is the embedding; the final norm is not."""
    def mark(node, stacked: bool):
        if isinstance(node, dict):
            return {k: mark(v, stacked or k == "layers")
                    for k, v in node.items()}
        if isinstance(node, list):
            return [mark(v, stacked) for v in node]
        return node.dim() + int(stacked) >= 2
    return mark(params, False)


def _decoder_layer(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                   positions: torch.Tensor,
                   key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-norm decoder layer (attention + MLP); `key` seeds the noise
    of its projections (fold_in(key, 0) the attention bank, 1 the MLP)."""
    k_attn = k_ffn = None
    if key is not None:
        k_attn, k_ffn = prng.fold_in(key, 0), prng.fold_in(key, 1)
    h = cm.apply_norm(p["ln1"], x, cfg.norm_type)
    x = x + cm.attention_block(p["attn"], h, _attn_cfg(cfg), cfg.cim,
                               positions=positions, key=k_attn)
    h = cm.apply_norm(p["ln2"], x, cfg.norm_type)
    return x + cm.mlp_block(p["mlp"], h, cfg.cim, cfg.mlp_act, key=k_ffn)


def _decoder_stack(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                   positions: torch.Tensor,
                   key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layers in order (JAX's lax.scan over stacked params); with
    cfg.remat each layer is checkpointed and recomputed in the backward.
    Layer i's noise key is fold_in(key, i)."""
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {cfg.remat_policy!r} is not ported (full only)")
    for i, p in enumerate(params["layers"]):
        lkey = None if key is None else prng.fold_in(key, i)
        if cfg.remat:
            new_x = checkpoint(_decoder_layer, cfg, p, x, positions, lkey,
                               use_reentrant=False)
        else:
            new_x = _decoder_layer(cfg, p, x, positions, lkey)
        x = new_x.to(x.dtype)
    return x


def embed_tokens(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token-id lookup into the embedding table, cast to the model compute
    dtype."""
    return params["embed"][tokens].to(_dtype(cfg))


def lm_logits(cfg: ModelConfig, params: Dict,
              x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied embedding or a bypass-mode lm_head:
    always digital)."""
    x = cm.apply_norm(params["final_norm"], x, cfg.norm_type)
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return x @ params["lm_head"]["w"].to(x.dtype)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, S, V) in the compute dtype for tokens (B, S); positions
    default 0..S-1.  `key` (a host `core/prng` key) seeds the CIM noise
    model of the projections when cfg.cim.noise is enabled.  (The JAX
    package's forward also returns a cache and the MoE aux loss; the
    dense family without a cache has neither.)"""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _decoder_stack(cfg, params, x, positions, key)
    return lm_logits(cfg, params, x)
