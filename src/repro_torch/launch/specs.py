"""Sharding rules and allocation-free input stand-ins for every (arch x
shape).

Counterpart of `repro/launch/specs.py`.  `param_specs` maps a parameter
tree to specs by leaf path (Megatron TP on "model", FSDP / ZeRO on
("pod", "data") along the other matrix axis, replicated elsewhere);
`input_specs` gives one step's inputs as `meta`-device tensors, the
port's `jax.ShapeDtypeStruct`, which allocate nothing.

A spec is a tuple with one entry per dimension (None, an axis name or a
tuple of names), `PartitionSpec`'s shape.  A mesh is the port's
`launch.mesh.DeviceMesh` or any object with `axis_names` and `shape` (a
size per axis name, as a tuple in `axis_names` order or a mapping).

The rules are written for JAX's stacked layout, a leading layer axis on
every leaf under "layers", "blocks", "tail" and "enc_layers".  The port
keeps one tree a layer there (a list), so a leaf of the port's tree takes
JAX's spec for the stacked leaf with the layer axis's entry dropped; a
tree in JAX's layout (a checkpoint's logical arrays) takes JAX's spec
itself.  `param_shapes` gives a config's parameter tree on the `meta`
device without drawing a number.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Placement
from repro_torch.models import transformer as tf


def P(*entries) -> Tuple:                                  # noqa: N802
    """A spec of `entries`, as PartitionSpec's `P(*entries)`."""
    return tuple(entries)


# (path regex, the spec as a function of the leaf's ndim) — first match
# wins.
# Specs are written for the *stacked* (leading layer axis) layout.
#
# 2-D weight matrices are FULLY sharded: TP ("model") on the Megatron axis
# AND FSDP/ZeRO ("pod","data") on the other matrix axis — without the FSDP
# axis, mixtral-8x22b/internvl2-76b fp32 masters + Adam moments exceed the
# memory of a device.
_FSDP = ("pod", "data")

_RULES = [
    # embeddings / lm head
    (r"embed$", lambda nd: P("model", _FSDP)),
    (r"lm_head/w(_q)?$", lambda nd: P(_FSDP, "model")),
    (r"pos_dec$", lambda nd: P(None, None)),
    # attention projections (stacked: L leading)
    (r"(attn|xattn)/w[qkv]/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), _FSDP, "model")),
    (r"(attn|xattn)/wo/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), "model", _FSDP)),
    (r"(attn|xattn)/b[qkv]$", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"(attn|xattn)/w[qkv]/abn_", lambda nd: P(*([None] * (nd - 1)), "model")),
    # MLP
    (r"mlp/w_(up|gate)/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), _FSDP, "model")),
    (r"mlp/w_down/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), "model", _FSDP)),
    (r"mlp/w_(up|gate)/abn_", lambda nd: P(*([None] * (nd - 1)), "model")),
    # MoE experts: (L, E, D, F) / (L, E, F, D); router replicated
    (r"moe/w_(up|gate)(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), _FSDP, "model")),
    (r"moe/w_down(_q)?$", lambda nd: P(*([None] * (nd - 2)), "model", _FSDP)),
    (r"moe/w_\w+_scale$", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"moe/router$", lambda nd: P()),
    # Mamba-2
    (r"mixer/in_proj/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), _FSDP, "model")),
    (r"mixer/in_proj/abn_", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"mixer/out_proj/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), "model", _FSDP)),
    (r"mixer/conv_w$", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"mixer/conv_b$", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"mixer/gate_norm$", lambda nd: P(*([None] * (nd - 1)), "model")),
    # RG-LRU
    (r"rec/w_(gelu|rnn)/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), _FSDP, "model")),
    (r"rec/w_(gelu|rnn)/abn_", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"rec/w_(a|x)$", lambda nd: P(*([None] * (nd - 2)), _FSDP, "model")),
    (r"rec/b_(a|x)$", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"rec/(conv_w|conv_b|lam)$", lambda nd: P(*([None] * (nd - 1)), "model")),
    (r"rec/w_out/w(_q)?$",
     lambda nd: P(*([None] * (nd - 2)), "model", _FSDP)),
]


def _spec_for(path: str, ndim: int) -> Tuple:
    for pat, rule in _RULES:
        if re.search(pat, path):
            return rule(ndim)
    return P()   # replicated


def _axis_sizes(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in mesh.axis_names}
    return {a: int(n) for a, n in zip(mesh.axis_names, shape)}


def _validate(spec: Tuple, shape, mesh) -> Tuple:
    """Filter spec axes that are absent from the mesh; keep the largest
    prefix of each tuple that still divides the dim (odd vocabs, tiny
    dims, missing 'pod' axis on the single-pod mesh)."""
    sizes = _axis_sizes(mesh)
    elems = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, elems):
        if e is None:
            out.append(None)
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        kept, prod = [], 1
        for a in axes:
            if a in sizes and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def param_specs(params, mesh) -> Any:
    """A tree of specs matching `params`, in JAX's stacked layout or the
    port's per-layer one."""
    def one(path, leaf, per_layer):
        nd = len(leaf.shape)
        if per_layer:
            spec = _spec_for(path, nd + 1)
            spec = (spec + (None,) * (nd + 1 - len(spec)))[1:]
        else:
            spec = _spec_for(path, nd)
        return _validate(spec, tuple(leaf.shape), mesh)

    def walk(node, path, per_layer):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k),
                            per_layer) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if path.split("/")[-1] in tf.STACKED_KEYS:
                return [walk(t, path, True) for t in node]
            return [walk(t, f"{path}/{i}" if path else str(i), per_layer)
                    for i, t in enumerate(node)]
        return one(path, node, per_layer)
    return walk(params, "", False)


def tree_shardings(spec_tree, mesh):
    """A `Placement` on `mesh` for every spec of `spec_tree`."""
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [tree_shardings(v, mesh) for v in spec_tree]
    if spec_tree is None:
        return None
    return Placement(mesh, tuple(spec_tree))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# input specs (meta-device tensors: never allocate)
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator `init_params` reads as lying on the `meta` device, so
    every parameter it builds is a meta tensor (torch.Generator itself
    has no meta device; the meta kernels draw nothing)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Dict:
    """`models/transformer.init_params(cfg, ...)`'s tree as meta tensors
    (shapes and dtypes, no storage): JAX's `jax.eval_shape` of
    init_params."""
    return tf.init_params(cfg, _MetaGenerator())


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Stand-ins for one step's inputs.

    train  : tokens/labels (B, S) (+ modality stubs)
    prefill: tokens (B, S)
    decode : tokens (B, 1) + cache
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16

    if shape.kind == "train":
        if cfg.family == "audio":
            lt = min(cfg.max_target_len, s // 8)
            return {"encoder_frames": _meta((b, s, cfg.d_model), bf16),
                    "tokens": _meta((b, lt), i32),
                    "labels": _meta((b, lt), i32)}
        if cfg.family == "vlm":
            st = s - cfg.vision_tokens
            return {"prefix_embeds": _meta((b, cfg.vision_tokens,
                                            cfg.d_model), bf16),
                    "tokens": _meta((b, st), i32),
                    "labels": _meta((b, st), i32)}
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}

    if shape.kind == "prefill":
        if cfg.family == "audio":
            lt = min(cfg.max_target_len, 448)
            return {"encoder_frames": _meta((b, s, cfg.d_model), bf16),
                    "tokens": _meta((b, lt), i32)}
        if cfg.family == "vlm":
            st = s - cfg.vision_tokens
            return {"prefix_embeds": _meta((b, cfg.vision_tokens,
                                            cfg.d_model), bf16),
                    "tokens": _meta((b, st), i32)}
        return {"tokens": _meta((b, s), i32)}

    if shape.kind == "decode":
        cache = tf.init_cache(cfg, b, max_len=s, device="meta")
        return {"tokens": _meta((b, 1), i32), "cache": cache}

    raise ValueError(shape.kind)


def batch_specs(inputs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Specs for the input tree."""
    ba = batch_axes(mesh)

    def spec_of(p, leaf):
        nd = len(leaf.shape)
        if p.startswith("cache"):
            if re.search(r"/k$|/v$", p) and nd == 5:
                # (L, B, S, G, hd): seq-sharded over model
                sp = P(None, ba, "model", None, None)
            elif re.search(r"/ssm$", p) and nd == 5:
                sp = P(None, ba, "model", None, None)
            elif re.search(r"/conv$", p) and nd == 4:
                sp = P(None, ba, None, "model")
            elif re.search(r"/h$", p) and nd == 3:
                sp = P(None, ba, "model")
            else:
                sp = P()
        elif nd >= 2:
            sp = P(ba, *([None] * (nd - 1)))
        else:
            sp = P()
        return _validate(sp, tuple(leaf.shape), mesh)

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(t, f"{path}/{i}" if path else str(i))
                    for i, t in enumerate(node)]
        return spec_of(path, node)
    return walk(inputs, "")
