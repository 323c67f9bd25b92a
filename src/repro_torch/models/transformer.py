"""Model assembly for the decoder-stack families: dense (OLMo, and any
pre-norm decoder with GQA attention and a gated MLP), moe (the same
attention with a top-k expert FFN, `models/moe.py`) and vlm (the dense
decoder behind a prefix of precomputed patch embeddings).

Counterpart of the decoder-stack path of `repro/models/transformer.py`:
the same parameter tree and forward, as functions over a dict of
tensors.  Where the JAX package stacks the layers along a leading axis
and scans over them, the port keeps `params["layers"]` as a list of
per-layer dicts and loops; with `cfg.remat` each layer of a cache-free
forward runs under `torch.utils.checkpoint` (non-reentrant), which
recomputes its forward in the backward, as `jax.checkpoint` does.  Every
projection runs through `core.cim_layers.cim_linear_apply`, every expert
bank through `moe._expert_gemm`.

`forward(..., cache=)` decodes over a KV cache and returns JAX's
`(logits, new_cache, aux)`: aux is the MoE load-balance loss summed over
the layers in float32 in layer order (JAX's scan carry; 0 for dense and
vlm).  The caches keep the JAX package's stacked layout, {"pos",
"layers": {"kv": {"k", "v", "idx"}}} with a leading layer axis, so layer
i's rings are views of one slab each; the rings are written in place, and
a returned cache aliases the one passed in (`init_cache` for static
batches, `init_slot_cache` / `write_slot_cache` / `free_slot_cache` for
in-flight batching).  `forward(prefix_embeds=)` (vlm) puts the prefix
before the token embeddings; positions then run over the longer
sequence.

`forward(key=)` seeds the CIM noise model of every projection, folded
as the JAX package folds it (fold_in(key, layer), then 0/1 for the
attention and FFN banks, then one fold per projection or bank, and per
expert in engine mode); a checkpointed layer's recompute redraws the
same noise from the same key.

Not ported: the hybrid, ssm and audio families (and with them forward's
`encoder_frames`), and the "dots" remat policy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.cim_layers import init_cim_linear
from repro_torch.models import common as cm
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.sharding import BATCH, TP, shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


DECODER_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported (the decoder-stack "
            f"families {DECODER_FAMILIES} are; ROADMAP Queue 1, the other "
            f"model families)")


def _attn_cfg(cfg: ModelConfig) -> cm.AttnConfig:
    return cm.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        window=cfg.sliding_window, rope_theta=cfg.rope_theta,
        impl=cfg.attn_impl)


def _init_decoder_layer(cfg: ModelConfig,
                        generator: torch.Generator) -> Dict:
    dev = generator.device
    p = {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "attn": cm.init_attention(generator, _attn_cfg(cfg), cfg.cim),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff,
                            cfg.moe_experts, cfg.cim)
    else:
        p["mlp"] = cm.init_mlp(generator, cfg.d_model, cfg.d_ff,
                               cfg.gated_mlp, cfg.cim)
    return p


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
                   positions: torch.Tensor, cache: Optional[Dict] = None,
                   key: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """One pre-norm decoder layer (attention + MLP or MoE FFN) -> (x, new
    layer cache {"kv": ...} or None, aux: the MoE load-balance loss, a
    float32 zero for an MLP); `key` seeds the noise of its projections
    (fold_in(key, 0) the attention bank, 1 the FFN)."""
    k_attn = k_ffn = None
    if key is not None:
        k_attn, k_ffn = prng.fold_in(key, 0), prng.fold_in(key, 1)
    h = cm.apply_norm(p["ln1"], x, cfg.norm_type)
    attn_out, new_kv = cm.attention_block(
        p["attn"], h, _attn_cfg(cfg), cfg.cim, positions=positions,
        cache=None if cache is None else cache["kv"], key=k_attn)
    x = x + attn_out
    h = cm.apply_norm(p["ln2"], x, cfg.norm_type)
    if cfg.family == "moe":
        ffn_out, aux = moe_block(
            p["moe"], h, n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, cim=cfg.cim,
            act=cfg.mlp_act, key=k_ffn)
    else:
        ffn_out = cm.mlp_block(p["mlp"], h, cfg.cim, cfg.mlp_act, key=k_ffn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + ffn_out
    return x, (None if cache is None else {"kv": new_kv}), aux


def _decoder_stack(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Dict] = None,
                   key: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """The layers in order (JAX's lax.scan over stacked params) -> (x,
    new stacked layer cache or None, aux summed in float32 in layer
    order, as JAX's scan carry).  Layer i reads slice i of each stacked
    cache leaf (a view, written in place); the new cursors are stacked
    back.  Without a cache and with cfg.remat each layer is checkpointed
    and recomputed in the backward.  Layer i's noise key is fold_in(key,
    i)."""
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {cfg.remat_policy!r} is not ported (full only)")
    kv = None if cache is None else cache["kv"]
    idxs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["layers"]):
        lkey = None if key is None else prng.fold_in(key, i)
        lc = None if kv is None else {"kv": {
            "k": kv["k"][i], "v": kv["v"][i], "idx": kv["idx"][i]}}
        if cfg.remat and lc is None:
            new_x, _, a = checkpoint(_decoder_layer, cfg, p, x, positions,
                                     None, lkey, use_reentrant=False)
        else:
            new_x, nc, a = _decoder_layer(cfg, p, x, positions, lc, lkey)
            if nc is not None:
                idxs.append(nc["kv"]["idx"])
        x = new_x.to(x.dtype)
        aux = aux + a
    if kv is None:
        return x, None, aux
    return x, {"kv": {"k": kv["k"], "v": kv["v"],
                      "idx": torch.stack(idxs)}}, aux


def embed_tokens(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token-id lookup into the embedding table, cast to the model compute
    dtype."""
    emb = shard(params["embed"], TP, None)
    return shard(emb[tokens].to(_dtype(cfg)), BATCH, None, None)


def lm_logits(cfg: ModelConfig, params: Dict,
              x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied embedding, a bypass-mode lm_head, or
    deploy-quantized serving weights: always digital)."""
    x = cm.apply_norm(params["final_norm"], x, cfg.norm_type)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    elif "w" in params["lm_head"]:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    else:
        head = params["lm_head"]
        logits = x @ (head["w_q"].to(x.dtype) * head["w_scale"].to(x.dtype))
    return shard(logits, BATCH, None, TP)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            key: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """(logits (B, S, V) in the compute dtype, new_cache, aux_loss) for
    tokens (B, S).

    positions default to 0..S-1, or with a cache to cache["pos"] + 0..S-1
    (in-flight decode passes its per-slot (B, 1) positions).  new_cache
    is None without a cache; with one it is {"pos": pos + S, "layers":
    ...}, whose K/V rings are the cache's own, written in place.  aux is
    the MoE load-balance loss summed over the layers (float32; zero for
    the dense and vlm families).  `prefix_embeds` (B, P, D), the vlm
    family's patch embeddings, go before the token embeddings, and S
    counts them (so do the logits and positions); another family raises
    ValueError on them, and `encoder_frames` (audio) raise
    NotImplementedError.  `key` (a host `core/prng` key) seeds the CIM
    noise model of the projections when cfg.cim.noise is enabled."""
    _check_family(cfg)
    if encoder_frames is not None:
        raise NotImplementedError(
            "encoder_frames (the audio family, ROADMAP Queue 1, the other "
            "model families) are not ported")
    if prefix_embeds is not None and cfg.family != "vlm":
        raise ValueError(f"prefix_embeds are the vlm family's input, not "
                         f"the {cfg.family!r} family's")
    x = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
        if cache is not None:
            positions = cache["pos"] + positions
    x, new_inner, aux = _decoder_stack(
        cfg, params, x, positions,
        None if cache is None else cache["layers"], key)
    logits = lm_logits(cfg, params, x)
    new_cache = (None if cache is None
                 else {"pos": cache["pos"] + s, "layers": new_inner})
    return logits, new_cache, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kv_cache_len(cfg: ModelConfig, max_len: int, window: int) -> int:
    if window > 0:
        return min(max_len, window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """Decode cache {"pos": 0-d int32, "layers": {"kv": {"k", "v" (L,
    batch, len, n_kv, head_dim), "idx" (L,) int32}}} for the decoder-
    stack families, zeroed; len is max_len, or the sliding window if
    shorter."""
    _check_family(cfg)
    length = _kv_cache_len(cfg, max_len, cfg.sliding_window)
    shape = (cfg.n_layers, batch, length, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": {"kv": {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "idx": torch.zeros((cfg.n_layers,), dtype=torch.int32,
                                   device=device)}}}


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> Dict:
    """Slot-mapped decode cache for in-flight (continuous) batching:
    {"pos": (slots,) per-slot positions, "layers": {"kv": stacked
    common.init_slot_kv_cache}}, every slot on its own ring cursor."""
    _check_family(cfg)
    length = _kv_cache_len(cfg, max_len, cfg.sliding_window)
    shape = (cfg.n_layers, slots, length, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((slots,), dtype=torch.int32, device=device),
            "layers": {"kv": {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "idx": torch.zeros((cfg.n_layers, slots), dtype=torch.int32,
                                   device=device)}}}


def write_slot_cache(cache: Dict, slot: int, prefill: Dict) -> Dict:
    """Admit a prefilled request into slot `slot` of a slot-mapped cache:
    copy the batch-1 `prefill` cache's K/V rings, per-layer cursors and
    position into the slot; every other slot is left as it was.  Writes
    in place: the returned cache aliases `cache`."""
    pkv, kv = prefill["layers"]["kv"], cache["layers"]["kv"]
    kv["k"][:, slot] = pkv["k"][:, 0].to(kv["k"].dtype)
    kv["v"][:, slot] = pkv["v"][:, 0].to(kv["v"].dtype)
    kv["idx"][:, slot] = pkv["idx"]
    cache["pos"][slot] = prefill["pos"]
    return {"pos": cache["pos"], "layers": {"kv": dict(kv)}}


def free_slot_cache(cache: Dict, slot: int) -> Dict:
    """Retire the request in slot `slot`: reset its cursors and position
    only (its K/V rows stay until the next admission overwrites them;
    per-row masks keep them from every other row).  Writes in place: the
    returned cache aliases `cache`."""
    kv = cache["layers"]["kv"]
    kv["idx"][:, slot] = 0
    cache["pos"][slot] = 0
    return {"pos": cache["pos"], "layers": {"kv": dict(kv)}}
