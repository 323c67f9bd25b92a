"""Model assembly for the decoder-stack families: dense (OLMo, and any
pre-norm decoder with GQA attention and a gated MLP), moe (the same
attention with a top-k expert FFN, `models/moe.py`), vlm (the dense
decoder behind a prefix of precomputed patch embeddings) and ssm (a
stack of Mamba-2 mixers, `models/mamba2.py`); and the hybrid family
(Griffin blocks of two RG-LRU layers and one local-attention layer,
`models/rglru.py`, then a tail of RG-LRU layers); and the audio family
(Whisper: a bidirectional encoder over precomputed frame embeddings,
then a decoder of causal self-attention, cross-attention over the
encoder states and an MLP, with learned decoder positions).

Counterpart of the decoder-stack path of `repro/models/transformer.py`:
the same parameter tree and forward, as functions over a dict of
tensors.  Where the JAX package stacks the layers along a leading axis
and scans over them, the port keeps `params["layers"]` as a list of
per-layer dicts and loops (the hybrid family: `params["blocks"]`, a list
of {"rec1", "rec2", "attn"} dicts, and `params["tail"]`, a list of
RG-LRU layers, present when the depth is not a multiple of 3; the
audio family: `params["enc_layers"]` and `params["layers"]`, the
decoder's); with `cfg.remat` each layer (hybrid: each block and each
tail layer) of a cache-free forward runs under `torch.utils.checkpoint`
(non-reentrant), which recomputes its forward in the backward, as
`jax.checkpoint` does.  `cfg.remat_policy` "dots" saves the outputs of
the matrix products without batch dimensions and recomputes the rest
(JAX's `dots_with_no_batch_dims_saveable`); any other policy saves
nothing ("full").  As in JAX, the policy applies to the decoder and ssm
stacks; the hybrid and audio stacks run "full" whatever it says.  Every
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
in-flight batching).  The ssm and hybrid caches hold the recurrent
states beside (hybrid) or instead of (ssm) the rings, in JAX's stacked
layout too: a cached call of one token is JAX's O(1) state update, and
a cached call of more tokens runs the same recurrence as the cache-free
forward from the cached state (JAX's state branch does not: ROADMAP
Queue 3, reference fault 11).  The audio cache holds each decoder
layer's self-attention ring of `max_target_len` slots and its
cross-attention K/V, "xkv", which a prefill with `encoder_frames`
writes in place (JAX replaces the leaf) and each decode step reads.
In-flight (slot-mapped) caches are for the attention-cache families
only, as in JAX.  `forward(prefix_embeds=)`
(vlm) puts the prefix before the token embeddings; positions then run
over the longer sequence.

`forward(key=)` seeds the CIM noise model of every projection, folded
as the JAX package folds it (fold_in(key, layer), then 0/1 for the
attention and FFN banks, then one fold per projection or bank, and per
expert in engine mode); a checkpointed layer's recompute redraws the
same noise from the same key.  The hybrid, ssm and audio families take
no key (ValueError), as JAX's forward refuses one.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.cim_layers import init_cim_linear
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as m2
from repro_torch.models import rglru as rg
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.sharding import BATCH, TP, shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


DECODER_FAMILIES = ("dense", "moe", "vlm")     # the attention-cache ones
FAMILIES = DECODER_FAMILIES + ("ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the "
                         f"families are {FAMILIES}")


def _attn_cfg(cfg: ModelConfig, *, window: int = 0, causal: bool = True,
              use_rope: bool = True) -> cm.AttnConfig:
    return cm.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        window=window, causal=causal, rope_theta=cfg.rope_theta,
        use_rope=use_rope, impl=cfg.attn_impl)


def _init_decoder_layer(cfg: ModelConfig,
                        generator: torch.Generator) -> Dict:
    dev = generator.device
    p = {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "attn": cm.init_attention(
            generator, _attn_cfg(cfg, window=cfg.sliding_window), cfg.cim),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff,
                            cfg.moe_experts, cfg.cim)
    else:
        p["mlp"] = cm.init_mlp(generator, cfg.d_model, cfg.d_ff,
                               cfg.gated_mlp, cfg.cim)
    return p


def _init_ssm_layer(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    return {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type,
                            device=generator.device),
        "mixer": m2.init_mamba2_layer(
            generator, cfg.d_model, expand=cfg.ssm_expand,
            headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
            conv_width=cfg.conv_width, cim=cfg.cim),
    }


def _init_rec_layer(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    dev = generator.device
    return {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "rec": rg.init_rglru_block(generator, cfg.d_model,
                                   cfg.lru_width or cfg.d_model,
                                   cfg.conv_width, cfg.cim),
        "mlp": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                           cfg.cim),
    }


def _init_local_attn_layer(cfg: ModelConfig,
                           generator: torch.Generator) -> Dict:
    dev = generator.device
    return {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "attn": cm.init_attention(
            generator, _attn_cfg(cfg, window=cfg.local_window), cfg.cim),
        "mlp": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                           cfg.cim),
    }


def _init_enc_layer(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    dev = generator.device
    return {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "attn": cm.init_attention(
            generator, _attn_cfg(cfg, causal=False, use_rope=False),
            cfg.cim),
        "mlp": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                           cfg.cim),
    }


def _init_xdec_layer(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    dev = generator.device
    return {
        "ln1": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln_x": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm_type, device=dev),
        "attn": cm.init_attention(generator, _attn_cfg(cfg, use_rope=False),
                                  cfg.cim),
        "xattn": cm.init_attention(
            generator, _attn_cfg(cfg, causal=False, use_rope=False),
            cfg.cim),
        "mlp": cm.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                           cfg.cim),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """The parameter tree for `cfg` on the generator's device: the
    embedding, one dict per layer under "layers" (hybrid: one
    {"rec1", "rec2", "attn"} dict per block of 3 under "blocks" and,
    when the depth leaves a remainder, its RG-LRU layers under "tail";
    audio: the encoder's layers under "enc_layers", the decoder's, with
    cross-attention "xattn" and its norm "ln_x", under "layers", the
    encoder's final norm "enc_norm" and the learned decoder positions
    "pos_dec" (max_target_len, d_model), 0.01 x normal), the final norm
    and, if the head is untied, "lm_head"."""
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
    if cfg.family == "hybrid":
        nb, tail = divmod(cfg.n_layers, 3)
        params["blocks"] = [{"rec1": _init_rec_layer(cfg, generator),
                             "rec2": _init_rec_layer(cfg, generator),
                             "attn": _init_local_attn_layer(cfg, generator)}
                            for _ in range(nb)]
        if tail:
            params["tail"] = [_init_rec_layer(cfg, generator)
                              for _ in range(tail)]
        return params
    if cfg.family == "audio":
        params["enc_layers"] = [_init_enc_layer(cfg, generator)
                                for _ in range(cfg.encoder_layers)]
        params["layers"] = [_init_xdec_layer(cfg, generator)
                            for _ in range(cfg.n_layers)]
        params["enc_norm"] = cm.init_norm(d, cfg.norm_type, device=dev)
        params["pos_dec"] = 0.01 * torch.randn(
            (cfg.max_target_len, d), generator=generator, device=dev)
        return params
    init_layer = (_init_ssm_layer if cfg.family == "ssm"
                  else _init_decoder_layer)
    params["layers"] = [init_layer(cfg, generator)
                        for _ in range(cfg.n_layers)]
    return params


# the subtrees whose leaves JAX stacks along a leading layer (or block) axis
STACKED_KEYS = ("layers", "blocks", "tail", "enc_layers")


def stacked_decay_mask(params: Dict) -> Dict:
    """Weight-decay mask of AdamW as the JAX package forms it: a leaf is
    decayed when it has 2 or more dimensions *as JAX stores it*, and JAX
    stacks each per-layer leaf along a leading layer axis ("layers", the
    hybrid family's "blocks" and "tail", the audio family's
    "enc_layers").  So every per-layer leaf
    (the ABN gains and offsets, the norm scales, and the recurrent
    layers' biases, Lambda, A_log and the like included) is decayed, as
    is the embedding; the final norm is not."""
    def mark(node, stacked: bool):
        if isinstance(node, dict):
            return {k: mark(v, stacked or k in STACKED_KEYS)
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
        p["attn"], h, _attn_cfg(cfg, window=cfg.sliding_window), cfg.cim,
        positions=positions, cache=None if cache is None else cache["kv"],
        key=k_attn)
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


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of matrix products without batch dimensions (JAX's
    `dots_with_no_batch_dims_saveable`: `x @ w` reaches `aten.mm`, a
    batched einsum `aten.bmm`), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn, *args):
    """fn(*args) checkpointed (non-reentrant) under `policy`: "dots"
    keeps the non-batched matrix products' outputs for the backward, any
    other policy keeps nothing (JAX's "full")."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def _decoder_stack(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Dict] = None,
                   key: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """The layers in order (JAX's lax.scan over stacked params) -> (x,
    new stacked layer cache or None, aux summed in float32 in layer
    order, as JAX's scan carry).  Layer i reads slice i of each stacked
    cache leaf (a view, written in place); the new cursors are stacked
    back.  Without a cache and with cfg.remat each layer is checkpointed
    and recomputed in the backward (`_remat`).  Layer i's noise key is
    fold_in(key, i)."""
    kv = None if cache is None else cache["kv"]
    idxs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["layers"]):
        lkey = None if key is None else prng.fold_in(key, i)
        lc = None if kv is None else {"kv": {
            "k": kv["k"][i], "v": kv["v"][i], "idx": kv["idx"][i]}}
        if cfg.remat and lc is None:
            new_x, _, a = _remat(cfg.remat_policy, _decoder_layer, cfg, p,
                                 x, positions, None, lkey)
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


def _ssm_layer(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               cache: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = cm.apply_norm(p["ln1"], x, cfg.norm_type)
    out, new_state = m2.mamba2_layer(
        p["mixer"], h, cfg, cfg.cim,
        state=None if cache is None else cache["ssm"])
    return x + out, (None if cache is None else {"ssm": new_state})


def _rec_layer(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               cache: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = cm.apply_norm(p["ln1"], x, cfg.norm_type)
    out, new_state = rg.rglru_block(
        p["rec"], h, cfg.cim, state=None if cache is None else cache["rec"])
    x = x + out
    h = cm.apply_norm(p["ln2"], x, cfg.norm_type)
    x = x + cm.mlp_block(p["mlp"], h, cfg.cim, cfg.mlp_act)
    return x, (None if cache is None else {"rec": new_state})


def _local_attn_layer(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = cm.apply_norm(p["ln1"], x, cfg.norm_type)
    out, new_kv = cm.attention_block(
        p["attn"], h, _attn_cfg(cfg, window=cfg.local_window), cfg.cim,
        positions=positions, cache=None if cache is None else cache["kv"])
    x = x + out
    h = cm.apply_norm(p["ln2"], x, cfg.norm_type)
    x = x + cm.mlp_block(p["mlp"], h, cfg.cim, cfg.mlp_act)
    return x, (None if cache is None else {"kv": new_kv})


def _hybrid_block(cfg: ModelConfig, positions: torch.Tensor, p: Dict,
                  x: torch.Tensor, cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Griffin block: RG-LRU, RG-LRU, local attention."""
    c = cache or {}
    x, nc1 = _rec_layer(cfg, p["rec1"], x, c.get("rec1"))
    x, nc2 = _rec_layer(cfg, p["rec2"], x, c.get("rec2"))
    x, nc3 = _local_attn_layer(cfg, p["attn"], x, positions, c.get("attn"))
    return x, (None if cache is None
               else {"rec1": nc1, "rec2": nc2, "attn": nc3})


def _layer_slice(tree, i: int):
    """Slice i of every stacked leaf of a cache subtree (views)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _restack(old, news: list):
    """The stacked cache subtree after the layers: every leaf stacked from
    the layers' new values, but the K/V rings ("k", "v"), which the
    layers wrote in place and which stay the tensors of `old`."""
    if isinstance(old, dict):
        return {k: old[k] if k in ("k", "v")
                else _restack(old[k], [n[k] for n in news])
                for k in old}
    return torch.stack(news)


def _layer_stack(cfg: ModelConfig, fn, layers: list, x: torch.Tensor,
                 cache, policy: str = "full"
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """fn(p, x, layer cache or None) -> (x, new layer cache) over the
    layers in order (JAX's `_scan_stack`: x cast back to its dtype after
    each), with layer i's cache sliced from the stacked `cache`; without
    a cache and with cfg.remat each call is checkpointed under `policy`
    (`_remat`).  Returns (x, the stacked new cache, or None)."""
    news = []
    for i, p in enumerate(layers):
        if cache is None:
            if cfg.remat:
                new_x, _ = _remat(policy, fn, p, x, None)
            else:
                new_x, _ = fn(p, x, None)
        else:
            new_x, nc = fn(p, x, _layer_slice(cache, i))
            news.append(nc)
        x = new_x.to(x.dtype)
    if cache is None:
        return x, None
    return x, (_restack(cache, news) if news else cache)


def _recurrent_stack(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                     positions: torch.Tensor, cache: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The ssm stack (`params["layers"]`) or the hybrid one (the blocks,
    then the tail) -> (x, the new stacked layer cache or None)."""
    if cfg.family == "ssm":
        return _layer_stack(cfg, lambda p, h, c: _ssm_layer(cfg, p, h, c),
                            params["layers"], x, cache, cfg.remat_policy)
    x, new_blocks = _layer_stack(
        cfg, lambda p, h, c: _hybrid_block(cfg, positions, p, h, c),
        params["blocks"], x, None if cache is None else cache["blocks"])
    new_tail = None if cache is None else cache["tail"]
    if "tail" in params:
        x, new_tail = _layer_stack(
            cfg, lambda p, h, c: _rec_layer(cfg, p, h, c), params["tail"],
            x, new_tail)
    if cache is None:
        return x, None
    return x, {"blocks": new_blocks, "tail": new_tail}


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
    ValueError on them.  `encoder_frames` (B, T, D), the audio family's
    input, run through the encoder (train and prefill; with a cache the
    cross K/V are written into its "xkv" leaf, whose length T must be);
    a cached call without them reads "xkv".  Another family raises
    ValueError on frames, and so does an audio forward with neither
    frames nor a cache: JAX's then makes its cross-attention
    bidirectional self-attention over the tokens, so that each position
    sees the next one (ROADMAP Queue 3, reference fault 12).  `key` (a
    host `core/prng` key) seeds the CIM noise model of the projections
    when cfg.cim.noise is enabled; the ssm, hybrid and audio families
    refuse one (ValueError), as JAX's forward does."""
    _check_family(cfg)
    if key is not None and cfg.family not in DECODER_FAMILIES:
        raise ValueError(
            f"noise-keyed forward is not wired for family {cfg.family!r}")
    if prefix_embeds is not None and cfg.family != "vlm":
        raise ValueError(f"prefix_embeds are the vlm family's input, not "
                         f"the {cfg.family!r} family's")
    if encoder_frames is not None and cfg.family != "audio":
        raise ValueError(f"encoder_frames are the audio family's input, "
                         f"not the {cfg.family!r} family's")
    if cfg.family == "audio" and encoder_frames is None and cache is None:
        raise ValueError(
            "the audio family's cache-free forward needs encoder_frames "
            "(without them JAX's cross-attention attends over the tokens "
            "themselves, future ones included: ROADMAP Queue 3, reference "
            "fault 12)")
    x = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
        if cache is not None:
            positions = cache["pos"] + positions
    inner = None if cache is None else cache["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in DECODER_FAMILIES:
        x, new_inner, aux = _decoder_stack(cfg, params, x, positions, inner,
                                           key)
    elif cfg.family == "audio":
        x, new_inner = _audio_stacks(cfg, params, x, positions, inner,
                                     encoder_frames)
    else:
        x, new_inner = _recurrent_stack(cfg, params, x, positions, inner)
    logits = lm_logits(cfg, params, x)
    new_cache = (None if cache is None
                 else {"pos": cache["pos"] + s, "layers": new_inner})
    return logits, new_cache, aux


def _sinusoid(length: int, channels: int, device=None) -> torch.Tensor:
    """The encoder's fixed positions (length, channels) float32: sin, then
    cos, of position x exp(-i 9.21 / (channels / 2 - 1)), as JAX's."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(channels // 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos * torch.exp(-dim * (9.21 / (channels // 2 - 1)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _enc_layer(cfg: ModelConfig, p: Dict, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """One pre-norm encoder layer: bidirectional self-attention without
    RoPE, then the MLP."""
    hh = cm.apply_norm(p["ln1"], h, cfg.norm_type)
    out, _ = cm.attention_block(
        p["attn"], hh, _attn_cfg(cfg, causal=False, use_rope=False),
        cfg.cim, positions=positions)
    h = h + out
    hh = cm.apply_norm(p["ln2"], h, cfg.norm_type)
    return h + cm.mlp_block(p["mlp"], hh, cfg.cim, cfg.mlp_act)


def _xdec_layer(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                positions: torch.Tensor, enc: Optional[torch.Tensor],
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One pre-norm decoder layer: causal self-attention without RoPE,
    cross-attention over the encoder states `enc` (or, in a cached call
    without them, over the cache's "xkv"), then the MLP.  A cached call
    with `enc` writes the cross K/V into "xkv" in place."""
    hh = cm.apply_norm(p["ln1"], h, cfg.norm_type)
    out, nkv = cm.attention_block(
        p["attn"], hh, _attn_cfg(cfg, use_rope=False), cfg.cim,
        positions=positions, cache=None if cache is None else cache["kv"])
    h = h + out
    hh = cm.apply_norm(p["ln_x"], h, cfg.norm_type)
    out, nxkv = cm.attention_block(
        p["xattn"], hh, _attn_cfg(cfg, causal=False, use_rope=False),
        cfg.cim, positions=positions, x_kv=enc,
        cross_kv=None if (cache is None or enc is not None)
        else cache["xkv"],
        cache=None if cache is None else {})
    if cache is not None and enc is not None:
        leaf = cache["xkv"]
        if nxkv["k"].shape != leaf["k"].shape:
            raise ValueError(
                f"encoder_frames of {enc.shape[1]} frames do not fit the "
                f"cache's cross-attention K/V of {leaf['k'].shape[1]} "
                f"(init_cache's max_len)")
        leaf["k"].copy_(nxkv["k"])
        leaf["v"].copy_(nxkv["v"])
        nxkv = leaf
    h = h + out
    hh = cm.apply_norm(p["ln2"], h, cfg.norm_type)
    h = h + cm.mlp_block(p["mlp"], hh, cfg.cim, cfg.mlp_act)
    return h, (None if cache is None else {"kv": nkv, "xkv": nxkv})


def _audio_stacks(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict],
                  encoder_frames: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Whisper backbone (JAX's `_audio_forward` up to the head): the
    learned decoder positions (clipped to max_target_len - 1) added to
    the token embeddings; with frames, the encoder over frames +
    `_sinusoid` and its final norm; then the decoder stack.  Returns (x,
    the new stacked decoder cache or None)."""
    pos = torch.clamp(positions, 0, cfg.max_target_len - 1)
    x = x + params["pos_dec"][pos].to(x.dtype)
    enc = None
    if encoder_frames is not None:
        enc = encoder_frames.to(x.dtype)
        t = enc.shape[1]
        enc = enc + _sinusoid(t, cfg.d_model, device=x.device).to(x.dtype)
        enc_pos = torch.arange(t, device=x.device)
        enc, _ = _layer_stack(
            cfg, lambda p, h, c: (_enc_layer(cfg, p, h, enc_pos), None),
            params["enc_layers"], enc, None)
        enc = cm.apply_norm(params["enc_norm"], enc, cfg.norm_type)
    return _layer_stack(
        cfg, lambda p, h, c: _xdec_layer(cfg, p, h, positions, enc, c),
        params["layers"], x, cache)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kv_cache_len(cfg: ModelConfig, max_len: int, window: int) -> int:
    if window > 0:
        return min(max_len, window)
    return max_len


def _stacked(tree: Dict, n: int) -> Dict:
    """A zeroed state of n layers: each leaf of the one-layer `tree` with
    a leading axis of n, its dtype and device kept."""
    return {k: _stacked(v, n) if isinstance(v, dict)
            else torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                             device=v.device)
            for k, v in tree.items()}


def _kv_stack(cfg: ModelConfig, n: int, batch: int, length: int, dtype,
              device) -> Dict:
    shape = (n, batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": torch.zeros((n,), dtype=torch.int32, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """Decode cache {"pos": 0-d int32, "layers": ...}, zeroed, in JAX's
    stacked layout (a leading layer or block axis on every leaf):

    - dense, moe, vlm: {"kv": {"k", "v" (L, batch, len, n_kv, head_dim)
      of `dtype`, "idx" (L,) int32}}, len max_len or the sliding window
      if shorter;
    - ssm: {"ssm": {"ssm" (L, batch, H, P, N) float32, "conv" (L, batch,
      conv_width - 1, channels) float32}} (`mamba2.init_mamba2_state`);
    - hybrid: {"blocks": {"rec1": {"rec": ...}, "rec2": {"rec": ...},
      "attn": {"kv": ... (len up to the local window)}}, "tail": {"rec":
      ...} or None}, each "rec" {"h" (n, batch, width) float32, "conv"
      (n, batch, conv_width - 1, width) bfloat16}
      (`rglru.init_rglru_state`);
    - audio: {"kv": ... (len max_target_len), "xkv": {"k", "v" (L,
      batch, max_len, n_kv, head_dim) of `dtype`}}: the decoder's rings
      and the cross-attention K/V over max_len encoder frames."""
    _check_family(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family == "audio":
        kv = _kv_stack(cfg, cfg.n_layers, batch, max_len, dtype, device)
        return {"pos": pos, "layers": {
            "kv": _kv_stack(cfg, cfg.n_layers, batch, cfg.max_target_len,
                            dtype, device),
            "xkv": {"k": kv["k"], "v": kv["v"]}}}
    if cfg.family == "ssm":
        st = m2.init_mamba2_state(batch, cfg.d_model, cfg, device=device)
        return {"pos": pos, "layers": {"ssm": _stacked(st, cfg.n_layers)}}
    if cfg.family == "hybrid":
        nb, tail = divmod(cfg.n_layers, 3)
        rec = rg.init_rglru_state(batch, cfg.lru_width or cfg.d_model,
                                  cfg.conv_width, device=device)
        length = _kv_cache_len(cfg, max_len, cfg.local_window)
        blocks = {"rec1": {"rec": _stacked(rec, nb)},
                  "rec2": {"rec": _stacked(rec, nb)},
                  "attn": {"kv": _kv_stack(cfg, nb, batch, length, dtype,
                                           device)}}
        return {"pos": pos, "layers": {
            "blocks": blocks,
            "tail": {"rec": _stacked(rec, tail)} if tail else None}}
    length = _kv_cache_len(cfg, max_len, cfg.sliding_window)
    return {"pos": pos, "layers": {"kv": _kv_stack(
        cfg, cfg.n_layers, batch, length, dtype, device)}}


def init_slot_cache(cfg: ModelConfig, slots: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> Dict:
    """Slot-mapped decode cache for in-flight (continuous) batching:
    {"pos": (slots,) per-slot positions, "layers": {"kv": stacked
    common.init_slot_kv_cache}}, every slot on its own ring cursor.  The
    attention-cache families only (ValueError otherwise, as in JAX)."""
    _check_family(cfg)
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(
            f"slot-mapped decode supports attention-cache families "
            f"(dense/moe/vlm), not {cfg.family!r}")
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
