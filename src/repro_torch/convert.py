"""Parameters of the JAX package, as numpy arrays, into the port's tensors.

The layouts match, so nothing is transposed: each CIM layer is
{"w": (K, N) with K in (kh, kw, c_in) order for a conv, "abn_log_gamma":
(N,), "abn_beta": (N,)}.  `params_from_numpy` converts layer params;
`decode_lm_from_numpy` builds a whole in-flight decode model from the fp32
masters of its projections, so both packages can serve the same weights;
`train_params_from_numpy` turns the JAX LM parameter tree into the
port's, so both packages can train the same weights
(`train_state_from_numpy` the whole train state, and
`train_state_to_numpy` back again: the layout a checkpoint holds), and
`deploy_params_from_numpy` does the same for the deploy-quantized tree
(int8 codes kept as int8); `cache_from_numpy` turns a JAX decode cache
into the port's (the same stacked layout, dtypes kept);
`key_from_numpy` turns JAX key data into the port's PRNG key, so both
draw the same noise.  The MoE family's stacked (L, E, D, F) expert banks,
router and per-expert ABN cross over like every other per-layer leaf;
`moe_params_from_numpy` converts one `init_moe` tree on its own.  The
hybrid family's stacked "blocks" (each of "rec1", "rec2", "attn") and
"tail" unstack as "layers" does, and its cache's "tail" may be None; so
does the audio family's "enc_layers", and its cache's cross-attention
K/V "xkv" cross over like the rings.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import host_tree
from repro_torch.models.transformer import STACKED_KEYS
from repro_torch.optim.adamw import tree_leaves

LAYER_KEYS = ("w", "abn_log_gamma", "abn_beta")

Layer = Mapping[str, object]


def _layer(p: Layer, device) -> Dict[str, torch.Tensor]:
    missing = [k for k in LAYER_KEYS if k not in p]
    if missing:
        raise ValueError(f"layer params lack {missing}")
    return {k: torch.from_numpy(np.array(p[k], dtype=np.float32)).to(device)
            for k in LAYER_KEYS}


def params_from_numpy(params: Union[Mapping[str, Layer], Sequence[Layer]],
                      device="cpu") -> Union[Dict[str, Dict], List[Dict]]:
    """float32 tensors on `device` from array-like layer params.

    `params` is a name-keyed dict of layers (as `init_lenet` returns) or a
    positional list of them (as `lenet_params_list` returns); the result
    has the same shape.  Arrays are copied, never shared."""
    if isinstance(params, Mapping):
        return {name: _layer(p, device) for name, p in params.items()}
    return [_layer(p, device) for p in params]


BLOCK_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


def decode_lm_from_numpy(embed, blocks: Sequence[Mapping[str, Layer]], *,
                         n_heads: int, window: int = 16,
                         rope_theta: float = 10000.0, r_in: int = 4,
                         r_w: int = 2,
                         points: Optional[Mapping[str, Sequence]] = None,
                         cfg=None, device=None):
    """A port `CIMDecodeLM` serving the given fp32 masters.

    Args:
      embed: (vocab, d) tied embedding.
      blocks: one mapping per transformer block with the layers "q", "k",
        "v" (d -> d each), "o" (d -> d), "gate", "up" (d -> d_ff each) and
        "down" (d_ff -> d), each {"w", "abn_log_gamma", "abn_beta"}.
      n_heads, window, rope_theta: the model's attention geometry.
      r_in, r_w: the base operating point.
      points: other operating points over the same masters, each one
        (r_in, r_w) pair or four in (qkv, o, gate_up, down) order.
      cfg: the programs' `runtime.engine.EngineConfig` (its `noise` makes
        a noisy model); None is the default config.
      device: where the model runs (None means CUDA, as compile_program).
    Returns:
      The bound `repro_torch.runtime.scheduler.CIMDecodeLM`.
    """
    from repro_torch.runtime.scheduler import CIMDecodeLM
    masters = []
    for i, blk in enumerate(blocks):
        missing = [k for k in BLOCK_KEYS if k not in blk]
        if missing:
            raise ValueError(f"block {i} lacks {missing}")
        lay = {k: _layer(blk[k], "cpu") for k in BLOCK_KEYS}
        masters.append({"qkv": {k: lay[k] for k in ("q", "k", "v")},
                        "o": [lay["o"]],
                        "gate_up": {k: lay[k] for k in ("gate", "up")},
                        "down": [lay["down"]]})
    emb = torch.from_numpy(np.array(embed, dtype=np.float32))
    return CIMDecodeLM.from_masters(
        emb, masters, n_heads=n_heads, window=window, rope_theta=rope_theta,
        r_in=r_in, r_w=r_w, cfg=cfg, points=dict(points) if points else None,
        device=device)


def _array_to_tensor(a, device) -> torch.Tensor:
    """A copy of a numpy (or ml_dtypes bfloat16) array as a tensor of the
    same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _lm_tree_from_numpy(tree: Mapping, leaf) -> Dict:
    """The port's LM tree from the JAX package's: per-layer slices of the
    stacked leaves under "layers" ("blocks" and "tail" for the hybrid
    family), every other leaf through `leaf`.  A stacked leaf may be a
    numpy array or a tensor (sliced where it lies)."""
    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        return leaf(node)

    def layer(node, i):
        if isinstance(node, Mapping):
            return {k: layer(v, i) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            node = np.asarray(node)
        return leaf(node[i])

    def depth(node):
        if isinstance(node, Mapping):
            return next((d for d in map(depth, node.values())
                         if d is not None), None)
        return node.shape[0] if isinstance(node, torch.Tensor) \
            else np.asarray(node).shape[0]

    out = {k: convert(v) for k, v in tree.items() if k not in STACKED_KEYS}
    for k in STACKED_KEYS:
        if k in tree:
            n = depth(tree[k])
            out[k] = [layer(tree[k], i) for i in range(n or 0)]
    return out


def train_params_from_numpy(tree: Mapping, device="cpu") -> Dict:
    """The port's LM parameter tree (`models/transformer.init_params`)
    from the JAX package's (`repro.models.transformer.init_params`, leaves
    as numpy arrays).

    The JAX tree stacks each per-layer leaf along a leading layer axis
    under "layers" (the hybrid family: a block axis under "blocks" and a
    layer axis under "tail"; the audio family: the encoder's under
    "enc_layers" too); the port keeps one dict per layer (block)
    there, so leaf i of the result's list is slice i of each stacked
    leaf.  Every
    other leaf keeps its shape.  Leaves (numpy arrays or tensors)
    become float32 tensors on `device`, copied, never shared.  The whole
    train state converts with `train_state_from_numpy`."""
    return _lm_tree_from_numpy(tree, _float32_leaf(device))


def _float32_leaf(device):
    """A float32 copy of a numpy array or a tensor, on `device`."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=device, dtype=torch.float32,
                                 copy=True)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return leaf


def train_state_from_numpy(tree: Mapping, device="cpu") -> Dict:
    """The port's train state (`launch/steps.train_state`) from JAX's
    logical one: {"params", "opt": {"m", "v", "step"}} and, under
    gradient compression, "err", each tree stacked as JAX stores it
    (leaves numpy arrays, as a checkpoint holds them, or tensors).  The
    params, moments and error become float32 tensors on `device`, copied,
    the params leaf tensors that require grad; "opt/step" an int32 0-d
    tensor.  The inverse of `train_state_to_numpy`."""
    leaf = _float32_leaf(device)
    state = {"params": _lm_tree_from_numpy(tree["params"], leaf),
             "opt": {"m": _lm_tree_from_numpy(tree["opt"]["m"], leaf),
                     "v": _lm_tree_from_numpy(tree["opt"]["v"], leaf),
                     "step": torch.tensor(int(tree["opt"]["step"]),
                                          dtype=torch.int32,
                                          device=device)}}
    if "err" in tree:
        state["err"] = _lm_tree_from_numpy(tree["err"], leaf)
    for p in tree_leaves(state["params"]):
        p.requires_grad_(True)
    return state


def _stacked_to_numpy(layers: Sequence) -> Mapping:
    """One per-layer tree a layer -> the tree of leaves stacked along a
    new leading axis, each written once into a host array (the
    device-to-host copies finish before this returns)."""
    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        first = nodes[0]
        out = torch.empty((len(nodes),) + tuple(first.shape),
                          dtype=first.dtype)
        for i, t in enumerate(nodes):
            out[i].copy_(t.detach())
        return out.numpy()
    return stack(list(layers))


def _lm_tree_to_numpy(tree: Mapping) -> Dict:
    """JAX's LM tree (numpy leaves) from the port's: the per-layer lists
    under "layers", "blocks", "tail" and "enc_layers" stacked along a
    leading layer axis, every other leaf copied.  The inverse of
    `train_params_from_numpy` (dtypes kept)."""
    out = {k: host_tree(v) for k, v in tree.items()
           if k not in STACKED_KEYS}
    for k in STACKED_KEYS:
        if k in tree and len(tree[k]):
            out[k] = _stacked_to_numpy(tree[k])
    return out


def train_state_to_numpy(state: Mapping) -> Dict:
    """JAX's logical train state from the port's, as numpy arrays: the
    params, moments and error buffer stacked (`_lm_tree_to_numpy`),
    "opt/step" an int32 0-d array.  The checkpoint's layout: a state the
    port's launcher saves restores with the JAX package's
    `load_checkpoint` and JAX's template, and the reverse through
    `train_state_from_numpy`."""
    out = {"params": _lm_tree_to_numpy(state["params"]),
           "opt": {"m": _lm_tree_to_numpy(state["opt"]["m"]),
                   "v": _lm_tree_to_numpy(state["opt"]["v"]),
                   "step": host_tree(state["opt"]["step"]).astype(
                       np.int32)}}
    if "err" in state:
        out["err"] = _lm_tree_to_numpy(state["err"])
    return out


def deploy_params_from_numpy(tree: Mapping, device="cpu") -> Dict:
    """As train_params_from_numpy, for a tree from the JAX package's
    `quantize_params_for_serving`: each leaf keeps its dtype (the int8
    weight codes "w_q", the float32 scales and everything else)."""
    return _lm_tree_from_numpy(tree, lambda a: _array_to_tensor(a, device))


MOE_KEYS = ("router", "w_gate", "w_up", "w_down", "abn_log_gamma",
            "abn_beta")


def moe_params_from_numpy(tree: Mapping, device="cpu") -> Dict:
    """The port's `models/moe.init_moe` tree from the JAX package's (one
    block: router (D, E), w_gate / w_up (E, D, F), w_down (E, F, D), ABN
    (E, D)), as float32 tensors on `device`, copied, never shared."""
    missing = [k for k in MOE_KEYS if k not in tree]
    if missing:
        raise ValueError(f"moe params lack {missing}")
    return {k: torch.from_numpy(np.array(tree[k], dtype=np.float32)).to(
        device) for k in MOE_KEYS}


def cache_from_numpy(tree: Mapping, device="cpu") -> Dict:
    """The port's decode cache (`models/transformer.init_cache` /
    `init_slot_cache`) from the JAX package's, leaves as numpy arrays.
    The layouts match (stacked along a leading layer axis, the hybrid
    family's blocks nested), so each leaf is copied with its dtype
    (bfloat16 K/V and RG-LRU conv states stay bfloat16, the recurrent
    states float32); a None subtree (a hybrid cache without a tail)
    stays None."""
    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        if node is None:
            return None
        return _array_to_tensor(node, device)
    return convert(tree)


def key_from_numpy(key_data) -> torch.Tensor:
    """The port's PRNG key (`core/prng`: a (..., 2) int64 host tensor of
    uint32 words) from JAX key data: a raw uint32 key such as
    `jax.random.PRNGKey(s)`, or `jax.random.key_data` of a typed key, as
    numpy."""
    a = np.asarray(key_data)
    if a.shape[-1:] != (2,) or a.dtype.kind not in "ui":
        raise ValueError(f"JAX key data is a (..., 2) uint32 array, got "
                         f"{a.dtype} {a.shape}")
    return torch.from_numpy(a.astype(np.uint32).astype(np.int64))
