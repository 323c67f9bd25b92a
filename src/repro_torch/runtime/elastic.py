"""Elastic mesh management: rebuild the mesh from whatever devices exist.

Counterpart of `repro/runtime/elastic.py`.  Checkpoints hold logical
arrays (`checkpoint/ckpt.py`), so scaling a job up or down between
restarts is: rebuild the mesh -> put the logical arrays on the new
placements (`reshard_tree`) -> continue.  `choose_mesh_shape` keeps the
model axis as close to the requested tensor-parallel degree as the
device count allows and gives the rest to data (then pod) parallelism.

The meshes are `launch/mesh.py`'s.  The port places a whole array on one
device: on a mesh folded onto one device every partition is already
where its consumer runs, so `reshard_tree` puts each leaf there; a mesh
that spans devices raises NotImplementedError, as
`models/sharding.shard` does.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh, Placement, make_mesh
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

__all__ = ["choose_mesh_shape", "make_mesh", "replicated", "reshard_tree"]


def choose_mesh_shape(n_devices: int, tp: int = 16, pods: int = 1
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(mesh shape, axis names) for `n_devices`: the model axis the
    largest divisor of `tp` that divides the count, the rest to data, or
    to (pod, data) when `pods` divides it."""
    tp = math.gcd(tp, n_devices)
    rest = n_devices // tp
    if pods > 1 and rest % pods == 0:
        return (pods, rest // pods, tp), ("pod", "data", "model")
    return (rest, tp), ("data", "model")


def _place(x, placement: Placement) -> torch.Tensor:
    """A new tensor holding `x` (a numpy array or a tensor, dtype kept) on
    the device of a folded mesh."""
    mesh: DeviceMesh = placement.mesh
    if len(placement.spec) > np.ndim(x):
        raise ValueError(f"spec {placement.spec} has more entries than the "
                         f"array's {np.ndim(x)} dimensions")
    if not mesh.folded:
        raise NotImplementedError(
            f"placing an array across the devices of {mesh.devices} (spec "
            f"{placement.spec}) is not ported; fold the mesh onto one "
            f"device")
    dev = mesh.devices[0]
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, copy=True)
    return torch.from_numpy(np.array(x)).to(dev)


def reshard_tree(tree, placements):
    """Put a logical tree (numpy arrays or tensors) onto `placements`, a
    tree of `Placement`s shaped like it: new tensors, dtypes kept."""
    leaves = tree_leaves(tree)
    where = tree_leaves(placements)
    if len(where) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(where)} "
                         f"placements")
    return tree_unflatten(tree, [_place(x, p) for x, p in zip(leaves, where)])


def replicated(mesh: DeviceMesh) -> Placement:
    """Every dimension unpartitioned on `mesh`."""
    return Placement(mesh, ())
