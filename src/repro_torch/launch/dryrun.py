"""Dry run: walk every (arch x shape x mesh) cell's step on the meta device
and record its memory, operations and bytes.

Counterpart of `repro/launch/dryrun.py`.  The JAX package lowers and
compiles each cell's step for a production mesh of 256 or 512 placeholder
devices and reads XLA's memory, cost and collective analysis; the port
builds the same step at full size on the `meta` device (the state from
`specs.param_shapes`, the inputs from `specs.input_specs`: no number is
drawn and no byte allocated) and runs it once under
`trace_analysis.OpStream`, which sums the step's aten ops and the port
kernels' recorded work as they stream by.

Meshes: "card" (the default) is the layout the port runs, one H100, and
its `argument_size_in_bytes` is the whole state and inputs; "single"
(16 x 16, ("data", "model")) and "multi" (2 x 16 x 16, ("pod", "data",
"model")) are mesh *shapes* handed to `specs.param_specs` /
`batch_specs`, and their `argument_size_in_bytes` is per device: each
leaf's bytes over the product of the mesh axes its spec names.  The port
places nothing across cards and has no SPMD partitioner, so `flops`,
`hbm_bytes` and the temporary memory are always the whole step's on one
device and `collectives` is null, not zero.  `jax_compat.py` and
`make_production_mesh` are XLA's and have no counterpart.

A cell whose step reads a value on the host (`float(t)`, `.item()`, a
flash offset that lives on the device) cannot be walked on meta tensors:
it is recorded as an error naming the read, as JAX's `run_cell` records
an exception; no value is guessed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k [--mesh card|single|multi]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Results land in experiments/dryrun_torch/<arch>_<shape>_<mesh>[_tag].json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.hw import H100_SXM
from repro_torch.launch import specs, steps, trace_analysis
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig

ALIAS = {a: a for a in ARCH_IDS}
ALIAS.update({
    "phi3.5-moe-42b-a6.6b": "phi35_moe", "mixtral-8x22b": "mixtral_8x22b",
    "minitron-4b": "minitron_4b", "qwen2-7b": "qwen2_7b",
    "olmo-1b": "olmo_1b", "granite-8b": "granite_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-76b": "internvl2_76b", "mamba2-1.3b": "mamba2_1_3b",
    "whisper-medium": "whisper_medium",
})

PRETTY = {v: k for k, v in ALIAS.items() if k != v}

OUT_DIR = "experiments/dryrun_torch"
MESH_KINDS = ("card", "single", "multi")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its shape alone: what `specs` reads of a mesh."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


# the JAX package's production meshes (`make_production_mesh`)
PRODUCTION_MESHES = {
    "single": MeshShape(("data", "model"), (16, 16)),
    "multi": MeshShape(("pod", "data", "model"), (2, 16, 16)),
}

NOTE = ("collectives null: the port has no SPMD partitioner; flops, "
        "hbm_bytes and temp_size_in_bytes are the whole step's on one "
        "device; on the single and multi meshes argument_size_in_bytes "
        "is per device, from the specs")


def cell_config(arch: str, cim_mode: str = "bypass", attn_impl: str = "jnp",
                remat_policy: str = "full") -> ModelConfig:
    """`arch`'s config as a dry-run cell runs it (JAX's run_cell)."""
    return get_config(arch).replace(
        cim=CIMConfig(mode=cim_mode, max_gamma=2.0**16),
        attn_impl=attn_impl, remat_policy=remat_policy)


def _materialize(tree, device: torch.device, gen: torch.Generator,
                 vocab: int):
    """Real tensors on `device` for a tree of meta input stand-ins:
    integer leaves tokens below `vocab`, float leaves normals."""
    if isinstance(tree, dict):
        return {k: _materialize(v, device, gen, vocab)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, device, gen, vocab) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.is_floating_point():
        return torch.randn(tree.shape, generator=gen, device=device,
                           dtype=torch.float32).to(tree.dtype)
    return torch.randint(0, vocab, tree.shape, generator=gen,
                         device=device, dtype=tree.dtype)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, device="meta", *,
               compress_grads: bool = False, seed: int = 0
               ) -> Tuple[Callable[[], Any], Dict[str, Any]]:
    """(fn, args) of one cell's step: `fn()` runs it once on `args`, the
    tree of its state and inputs - the train step on {"state", "batch"},
    the prefill step on {"params", "batch"}, the decode step on
    {"params", "cache", "tokens"} (deploy-quantized params in deploy
    mode, as JAX's run_cell).  On `meta` the params come from
    `specs.param_shapes` and the inputs from `specs.input_specs`; on
    another device they are drawn from `seed` (weights by
    `init_params`, tokens below the vocabulary, the decode cache
    zeroed)."""
    device = torch.device(device)
    inputs = specs.input_specs(cfg, shape)
    if device.type == "meta":
        params = specs.param_shapes(cfg)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tf.init_params(cfg, gen)
        cache = (tf.init_cache(cfg, shape.global_batch, max_len=shape.seq_len,
                               device=device)
                 if shape.kind == "decode" else None)
        inputs = _materialize({k: v for k, v in inputs.items()
                               if k != "cache"}, device, gen,
                              cfg.vocab_size)
        if cache is not None:
            inputs["cache"] = cache
    if shape.kind == "train":
        state = steps.train_state(params, compress_grads)
        step = steps.make_train_step(cfg, AdamWConfig(),
                                     compress_grads=compress_grads)
        return (lambda: step(state, inputs)), {"state": state,
                                               "batch": inputs}
    if shape.kind == "decode" and cfg.cim.mode == "deploy":
        from repro_torch.core.cim_layers import quantize_params_for_serving
        params = quantize_params_for_serving(params, cfg.cim.r_w)
    if shape.kind == "prefill":
        prefill = steps.make_prefill_step(cfg)

        def run_prefill():
            with torch.no_grad():
                return prefill(params, inputs)
        return run_prefill, {"params": params, "batch": inputs}
    serve = steps.make_serve_step(cfg)

    def run_decode():
        with torch.no_grad():
            return serve(params, inputs["cache"], inputs["tokens"])
    return run_decode, {"params": params, "cache": inputs["cache"],
                        "tokens": inputs["tokens"]}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _sharded_bytes(tree, spec_tree, sizes: Dict[str, int]) -> int:
    """Per-device bytes of `tree` under `spec_tree` (the same structure,
    a spec tuple at each leaf): each leaf's bytes over the product of the
    sizes of the axes its spec names."""
    if isinstance(tree, torch.Tensor):
        parts = 1
        for e in spec_tree:
            for a in _axes(e):
                parts *= sizes[a]
        nbytes = tree.numel() * tree.element_size()
        if nbytes % parts:
            raise ValueError(f"a leaf of {tuple(tree.shape)} does not split "
                             f"over {spec_tree}")
        return nbytes // parts
    if isinstance(tree, dict):
        return sum(_sharded_bytes(v, spec_tree[k], sizes)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_sharded_bytes(v, s, sizes)
                   for v, s in zip(tree, spec_tree))
    return 0


def argument_bytes_per_device(args: Dict[str, Any], mesh) -> int:
    """`argument_size_in_bytes` of a cell's `args` (build_cell's tree) on
    a mesh of `mesh`'s shape: params, the AdamW moments and the error
    buffer by `specs.param_specs`, the step counter replicated, the
    inputs by `specs.batch_specs`."""
    sizes = specs._axis_sizes(mesh)
    total = 0
    for name, tree in args.items():
        if name == "state":
            pspec = specs.param_specs(tree["params"], mesh)
            sspec = {"params": pspec,
                     "opt": {"m": pspec, "v": pspec, "step": ()}}
            if "err" in tree:
                sspec["err"] = pspec
            total += _sharded_bytes(tree, sspec, sizes)
        elif name == "params":
            total += _sharded_bytes(tree, specs.param_specs(tree, mesh),
                                    sizes)
        elif name == "batch":
            total += _sharded_bytes(tree, specs.batch_specs(tree, mesh),
                                    sizes)
        else:                               # decode's cache and tokens
            sub = {name: tree}
            total += _sharded_bytes(sub, specs.batch_specs(sub, mesh), sizes)
    return total


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_kind: str = "card",
                 *, compress_grads: bool = False) -> Dict[str, Any]:
    """Walk one cell on the meta device: the result's "memory", "flops",
    "hbm_bytes", "hbm_bytes_fused", "fits_card", "ops", "kernels" and
    "off_meta" (module docstring)."""
    fn, args = build_cell(cfg, shape, "meta", compress_grads=compress_grads)
    walk = trace_analysis.analyze(fn, args)
    memory = {k: walk[k] for k in ("argument_size_in_bytes",
                                   "output_size_in_bytes",
                                   "alias_size_in_bytes",
                                   "temp_size_in_bytes")}
    fits = (memory["argument_size_in_bytes"] + memory["temp_size_in_bytes"]
            < H100_SXM.hbm_bytes)
    if mesh_kind != "card":
        memory["argument_size_in_bytes"] = argument_bytes_per_device(
            args, PRODUCTION_MESHES[mesh_kind])
    return {"memory": memory, "flops": walk["flops"],
            "hbm_bytes": walk["hbm_bytes"],
            "hbm_bytes_fused": walk["hbm_bytes_fused"],
            "fits_card": fits, "ops": walk["ops"],
            "kernels": walk["kernels"], "off_meta": walk["off_meta"],
            "collectives": None, "note": NOTE}


def run_cell(arch: str, shape_name: str, mesh_kind: str = "card", *,
             cim_mode: str = "bypass", out_dir: Optional[str] = OUT_DIR,
             attn_impl: str = "jnp", tag: str = "",
             remat_policy: str = "full",
             compress_grads: bool = False) -> Dict[str, Any]:
    """One cell, as JAX's run_cell: "skipped" with JAX's reason where
    `shape_applicable` rejects it, else "ok" with the walk's result or
    "error" with the exception; written under `out_dir` (None: not
    written)."""
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh {mesh_kind!r} is not one of {MESH_KINDS}")
    cfg = cell_config(arch, cim_mode, attn_impl, remat_policy)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg.name, shape_name, cfg.family)
    result: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
        "cim_mode": cim_mode, "kind": shape.kind, "attn_impl": attn_impl,
        "remat_policy": remat_policy, "compress_grads": compress_grads,
        "tag": tag,
    }
    if not ok:
        result["status"] = "skipped"
        result["reason"] = why
        _dump(result, out_dir)
        return result
    t0 = time.time()
    try:
        result.update(analyze_cell(cfg, shape, mesh_kind,
                                   compress_grads=compress_grads))
        result["status"] = "ok"
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["walk_s"] = round(time.time() - t0, 2)
    _dump(result, out_dir)
    return result


def _dump(result: Dict[str, Any], out_dir: Optional[str]) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    tag = "" if result.get("cim_mode", "bypass") == "bypass" else \
        f"_{result['cim_mode']}"
    if result.get("attn_impl", "jnp") != "jnp":
        tag += f"_{result['attn_impl']}"
    if result.get("tag"):
        tag += f"_{result['tag']}"
    name = (f"{ALIAS.get(result['arch'], result['arch'])}"
            f"_{result['shape']}_{result['mesh']}{tag}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1, default=str)


def summary(r: Dict[str, Any]) -> str:
    """One cell's line: status, flops, fits_card and the walk's seconds."""
    extra = ""
    if r["status"] == "ok":
        mem = r["memory"]
        args_b, temp_b = (mem["argument_size_in_bytes"],
                          mem["temp_size_in_bytes"])
        extra = (f" flops={r['flops']:.3e} args={args_b:.3e}B "
                 f"temp={temp_b:.3e}B fits_card={r['fits_card']} "
                 f"walk={r['walk_s']}s")
    elif r["status"] == "error":
        extra = " " + r.get("error", "")[:160]
    return (f"[{r['mesh']:6s}] {ALIAS.get(r['arch'], r['arch']):20s} "
            f"{r['shape']:12s} {r['status']}{extra}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="card", choices=list(MESH_KINDS))
    ap.add_argument("--cim-mode", default="bypass",
                    choices=["bypass", "fakequant", "deploy"])
    ap.add_argument("--attn-impl", default="jnp", choices=["jnp", "pallas"])
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape (the default where --arch and "
                         "--shape are not given)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = (list(ARCH_IDS) if args.all or args.arch is None
             else [ALIAS.get(args.arch, args.arch)])
    shapes = (list(SHAPES) if args.all or args.shape is None
              else [args.shape])
    results = []
    for arch in archs:
        for shape in shapes:
            r = run_cell(arch, shape, args.mesh, cim_mode=args.cim_mode,
                         attn_impl=args.attn_impl, tag=args.tag,
                         remat_policy=args.remat_policy,
                         compress_grads=args.compress_grads,
                         out_dir=args.out)
            results.append(r)
            print(summary(r), flush=True)
    return results


if __name__ == "__main__":
    main()
