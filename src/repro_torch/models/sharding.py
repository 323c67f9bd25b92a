"""Mesh-aware sharding helpers of the model code.

Counterpart of `repro/models/sharding.py`.  Model code annotates
activations and params with *logical* specs through `shard(...)`; axes
the ambient mesh lacks are dropped, so the same model runs with no mesh
and on every mesh the port can place.  The ambient mesh is a
`launch.mesh.DeviceMesh` set by the `use_mesh` context manager (JAX's
`jax.sharding.use_mesh`); with none set the mesh is empty.

A spec is a tuple with one entry per tensor dimension: None (not
partitioned), an axis name, or a tuple of axis names.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import DeviceMesh

# logical axis groups
BATCH = ("pod", "data")     # pure data-parallel axes
TP = "model"                # tensor-parallel axis

AxisEl = Union[None, str, Sequence[str]]

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make `mesh` the ambient mesh inside the block (nests; the outer
    mesh comes back on exit)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_mesh() -> Optional[DeviceMesh]:
    """The ambient mesh, or None outside every `use_mesh` block."""
    return _AMBIENT[-1] if _AMBIENT else None


def _filter(el: AxisEl, names) -> AxisEl:
    if el is None:
        return None
    if isinstance(el, str):
        return el if el in names else None
    kept = tuple(a for a in el if a in names)
    return kept if kept else None


def mesh_spec(*elems: AxisEl, shape: Optional[Sequence[int]] = None
              ) -> Optional[Tuple[AxisEl, ...]]:
    """The spec with axes absent from the ambient mesh dropped, or None
    without a mesh; if `shape` is given, axes whose product does not
    divide the corresponding dim are dropped too (keeping the largest
    prefix of axes that still divides)."""
    mesh = get_mesh()
    if mesh is None or mesh.empty:
        return None
    names = set(mesh.axis_names)
    filtered = [_filter(e, names) for e in elems]
    if shape is not None:
        for i, e in enumerate(filtered):
            if e is None or i >= len(shape):
                continue
            axes = (e,) if isinstance(e, str) else tuple(e)
            prod = 1
            for a in axes:
                prod *= mesh.axis_size(a)
            if shape[i] % prod != 0:
                kept = []
                prod = 1
                for a in axes:
                    if shape[i] % (prod * mesh.axis_size(a)) == 0:
                        kept.append(a)
                        prod *= mesh.axis_size(a)
                filtered[i] = tuple(kept) if kept else None
    return tuple(filtered)


def shard(x: torch.Tensor, *elems: AxisEl) -> torch.Tensor:
    """Constrain `x` to the logical spec on the ambient mesh.

    The identity with no mesh, and for a mesh whose partitions all sit on
    one device - the only layout one card has, where every partition of
    the tensor is already where its consumer runs.  The port does not
    place model tensors across cards (the engine's multi-macro schedule
    places its own partitions), so a spec on an ambient mesh that spans
    several devices raises NotImplementedError rather than leave the
    tensor unplaced."""
    spec = mesh_spec(*elems, shape=tuple(x.shape))
    if spec is None or get_mesh().folded:
        return x
    if all(e is None for e in spec):
        return x
    raise NotImplementedError(
        f"placing a model tensor across the devices of "
        f"{get_mesh().devices} (spec {spec}) is not ported; fold the mesh "
        f"onto one device")


def axis_size(name: str) -> int:
    """Partitions along `name` on the ambient mesh (1 without a mesh or
    where the mesh lacks the axis)."""
    mesh = get_mesh()
    if mesh is None or mesh.empty:
        return 1
    return mesh.axis_size(name)
