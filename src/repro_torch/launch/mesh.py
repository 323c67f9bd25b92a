"""Device meshes of the port: which device runs each partition.

Counterpart of `repro/launch/mesh.py`.  JAX hands shard_map a
`jax.sharding.Mesh`; the port's mesh is an explicit object, a tuple of
`torch.device`s (one per partition, row-major over `shape`) plus axis
names, and the code that partitions work (the sharded engine schedule,
`flash_attention_sharded`) runs each partition on its device.

Placement:

  * default - the first D visible CUDA devices, or the one CPU when the
    program runs on the host.  Asking for more devices than are visible
    raises ValueError.
  * folded - all D partitions on one named device
    (`ShardingConfig(fold_onto=...)`, or `fold_onto=` here).  This is the
    port's counterpart of XLA's
    `--xla_force_host_platform_device_count=N`, with which the JAX
    package fakes a bank of devices on one host: the partitions run one
    after another on the one device, each on its own share of the work,
    so a one-card machine (or the CPU) runs the multi-macro schedule.  It
    is never taken silently: an unfolded mesh that needs more devices
    than are visible raises.

The production meshes of the JAX package (`make_production_mesh`, 256 or
512 TPU chips) are not ported.

Functions, not module-level constants: importing this module touches no
device state.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """D partitions over named axes: `devices[i]` runs partition i, in
    row-major order over `shape` (one entry per name in `axis_names`)."""
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} holds "
                             f"{math.prod(self.shape)} partitions, got "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        """Number of partitions."""
        return len(self.devices)

    @property
    def empty(self) -> bool:
        """True for a mesh of no partitions."""
        return self.size == 0

    @property
    def folded(self) -> bool:
        """Whether every partition sits on one device."""
        return len(set(self.devices)) <= 1

    def axis_size(self, name: str) -> int:
        """Partitions along `name` (1 for an axis the mesh lacks)."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a logical array goes: a mesh and a spec, one entry per
    dimension (None, an axis name or a tuple of them; JAX's
    `NamedSharding(mesh, PartitionSpec(...))`).  A spec shorter than the
    array leaves the trailing dimensions unpartitioned."""
    mesh: DeviceMesh
    spec: Tuple = ()


def _device(dev: DeviceLike) -> torch.device:
    """A concrete device: "cuda" names the current card."""
    d = torch.device("cuda" if dev is None else dev)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available to place a "
                               "mesh on")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(platform: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices a default placement draws from: every CUDA device for
    "cuda", the one host for "cpu"."""
    if platform == "cpu":
        return (torch.device("cpu"),)
    if platform != "cuda":
        raise ValueError(f"no default placement on {platform!r}")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              platform: str = "cuda",
              fold_onto: DeviceLike = None) -> DeviceMesh:
    """A mesh of `shape` over `axis_names`: the first prod(shape) visible
    devices of `platform`, or every partition on `fold_onto` when given.
    Raises ValueError (naming the devices) when fewer are visible."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if fold_onto is not None:
        devs = (_device(fold_onto),) * n
    else:
        vis = visible_devices(platform)
        if n > len(vis):
            raise ValueError(
                f"the mesh wants {n} devices but {len(vis)} {platform} "
                f"devices are visible; fold the partitions onto one "
                f"device (ShardingConfig(fold_onto=...)) to run them "
                f"there")
        devs = vis[:n]
    return DeviceMesh(devices=devs, shape=shape,
                      axis_names=tuple(str(a) for a in axis_names))


@functools.lru_cache(maxsize=64)
def _engine_mesh(devices: int, axis: str, platform: str,
                 fold_onto: Optional[torch.device]) -> DeviceMesh:
    return make_mesh((devices,), (axis,), platform=platform,
                     fold_onto=fold_onto)


def make_engine_mesh(devices: int = 0, axis: str = "macro", *,
                     device: DeviceLike = None,
                     fold_onto: DeviceLike = None) -> DeviceMesh:
    """1-D mesh for the CIM engine's sharded multi-macro dispatch
    (runtime.engine.ShardingConfig).

    `devices=0` takes every visible device of the platform of `device`
    (the program's device, default CUDA; outputs gather there).  With
    `fold_onto` every partition sits on that device, which must be the
    program's device (its bound weights live there).  Raises ValueError
    when an unfolded mesh asks for more devices than are visible."""
    dev = _device(device)
    fold = None if fold_onto is None else _device(fold_onto)
    if fold is not None and fold != dev:
        raise ValueError(f"partitions folded onto {fold} but the program "
                         f"runs on {dev}: fold onto the program's device")
    n = devices if devices > 0 else len(visible_devices(dev.type))
    return _engine_mesh(n, str(axis), dev.type, fold)


def make_host_mesh() -> DeviceMesh:
    """Whatever this host offers, as ("data", "model") = (n, 1): every
    visible card, or the one CPU where there is none."""
    platform = "cuda" if torch.cuda.is_available() else "cpu"
    n = len(visible_devices(platform))
    return make_mesh((n, 1), ("data", "model"), platform=platform)
