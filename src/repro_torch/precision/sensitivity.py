"""Offline per-layer precision/noise sensitivity calibration (adaptive
precision serving, layer 1 of 3).

Counterpart of `repro/precision/sensitivity.py`.  The paper's headline is
*workload-adaptive* 1-to-8b operation: peak efficiency scales 0.15-8
POPS/W with computing precision.  Exploiting that per layer needs to
know, for every layer, how much output quality is lost by dropping that
layer to each (r_in, r_w) point.  This module measures exactly that: hold
every other layer at the 8b-class base point, drop one layer to one grid
point, and record the quality delta of the final outputs vs. the
all-base reference - logit MSE and top-1 agreement, averaged over
Monte-Carlo noise trials when the config models noise, or a single clean
run otherwise.

Parameters, inputs and trial keys come from the threefry PRNG
(`core/prng`) exactly as the JAX package draws them, so a calibration's
outputs equal JAX's bit for bit.  The logit MSE is the mean of the
float32 squared differences, summed in float64 and rounded to float32
(XLA sums in float32 in its own order, so the two agree within a few
ulps - 1e-6 relative - and exactly on the base point's 0); the top-1
agreement is exact.  The programs run on `device` (CUDA by default) and
every draw lands there; each run binds its per-call params, as the JAX
package's `run` does.

Profiles persist in a versioned on-disk JSON cache with the JAX
package's format and degradation contract: schema-versioned file, atomic
tmp+rename writes, and corrupt/stale state degrading to a fresh
calibration with one `ProfileCacheWarning` - never an error.  A file one
package wrote is a hit for the other.

Two network shapes are supported transparently:

* **chained** specs (layer i's n == layer i+1's k): one program end to
  end; the quality delta is measured at the final logits.
* **independent** specs (e.g. a decode block's qkv/o/gate_up/down
  projections, which never chain): each layer is its own single-layer
  program with its own input, and the delta is measured at that layer's
  output.  This is the mode the serving ladder for `CIMDecodeLM` uses.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mapping, prng
from repro_torch.runtime import engine as rt
from repro_torch.runtime.program import (Device, compile_program,
                                         resolve_device)

SCHEMA_VERSION = 1

# statuses ProfileCache.get can report for a key
HIT, MISS, INVALID = "hit", "miss", "invalid"

# the canonical monotone precision chain, cheapest to most precise; the
# planner upgrades layers along this order, so it must be sorted by
# bit-serial cost (r_in * r_w phases).  The last entry is the base point.
PRECISION_CHAIN: Tuple[Tuple[int, int], ...] = (
    (1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (8, 4))

BASE_POINT: Tuple[int, int] = (8, 4)

# calibration sweeps actually executed (cache-hit observability)
CALIBRATION_RUNS = {"n": 0}


class ProfileCacheWarning(UserWarning):
    """A profile cache file or entry was unusable; calibration re-ran."""


def default_profile_path() -> str:
    """The profile cache location: $REPRO_PRECISION_PROFILES or
    ~/.cache/repro-cim/sensitivity.json."""
    env = os.environ.get("REPRO_PRECISION_PROFILES")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-cim",
                        "sensitivity.json")


def profile_key(specs: Sequence[mapping.LayerSpec], cfg: rt.EngineConfig,
                points: Sequence[Tuple[int, int]], n_trials: int,
                batch: int, seed: int, label: str = "") -> str:
    """The string key one calibration run is stored under.

    Encodes everything the measured deltas depend on: per-layer tile
    geometry and reference precision, the swept points, trial count,
    batch extent, PRNG seed, whether noise was modeled, and the device
    count (`cfg.sharding`'s, 1 without one).  Distinct *numeric* noise
    operating points at one geometry should distinguish themselves via
    `label`.  The string equals the JAX package's."""
    devices = (cfg.sharding.resolve_devices()
               if cfg.sharding is not None else 1)
    geo = "+".join(
        f"m{s.m}k{s.k}n{s.n}r{s.r_in}x{s.r_w}x{s.r_out}"
        + ("conv" if s.conv is not None else "dense") for s in specs)
    pts = "-".join(f"{a}x{b}" for a, b in points)
    return (f"{label}|{geo}|p{pts}|t{int(n_trials)}|b{int(batch)}"
            f"|s{int(seed)}|nz{int(cfg.noise.enabled)}|d{int(devices)}")


@dataclasses.dataclass(frozen=True)
class LayerSensitivity:
    """One layer's measured quality deltas across the precision grid.

    `entries` holds one (r_in, r_w, logit_mse, top1_agreement) tuple per
    swept point: the MSE of the network outputs (and the fraction of
    rows whose argmax agrees) vs. the all-base reference when only this
    layer runs at (r_in, r_w)."""
    index: int
    entries: Tuple[Tuple[int, int, float, float], ...]

    def delta(self, point: Tuple[int, int]) -> float:
        """Logit MSE vs. the base reference at one (r_in, r_w) point."""
        for ri, rw, mse, _ in self.entries:
            if (ri, rw) == tuple(point):
                return mse
        raise ValueError(f"layer {self.index} was not calibrated at "
                         f"{tuple(point)}")

    def agreement(self, point: Tuple[int, int]) -> float:
        """Top-1 agreement fraction vs. the base reference at one point."""
        for ri, rw, _, agree in self.entries:
            if (ri, rw) == tuple(point):
                return agree
        raise ValueError(f"layer {self.index} was not calibrated at "
                         f"{tuple(point)}")


@dataclasses.dataclass(frozen=True)
class SensitivityProfile:
    """A network's full per-layer precision sensitivity table.

    `points` is the swept chain in planner (cheapest-first) order with
    the base point last; `layers[i]` holds layer i's deltas.  `n_trials`
    records the Monte-Carlo trial count (1 for a clean, noise-free
    calibration); `chained` records whether the deltas were measured at
    the final logits of one chained program or per-layer on independent
    programs."""
    base: Tuple[int, int]
    points: Tuple[Tuple[int, int], ...]
    n_trials: int
    chained: bool
    layers: Tuple[LayerSensitivity, ...]

    def delta(self, layer: int, point: Tuple[int, int]) -> float:
        """Layer `layer`'s logit-MSE delta at one (r_in, r_w) point."""
        return self.layers[layer].delta(point)

    def agreement(self, layer: int, point: Tuple[int, int]) -> float:
        """Layer `layer`'s top-1 agreement at one (r_in, r_w) point."""
        return self.layers[layer].agreement(point)

    def max_total_delta(self) -> float:
        """The worst-case additive delta: every layer at the cheapest
        point.  Budget fractions are expressed against this scale."""
        return float(sum(l.delta(self.points[0]) for l in self.layers))

    def to_dict(self) -> dict:
        """JSON-serializable form (the profile-cache entry payload)."""
        return {
            "base": list(self.base),
            "points": [list(p) for p in self.points],
            "n_trials": int(self.n_trials),
            "chained": bool(self.chained),
            "layers": [{"index": l.index,
                        "entries": [list(e) for e in l.entries]}
                       for l in self.layers],
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "SensitivityProfile":
        """Inverse of to_dict (raises KeyError/TypeError on bad shape -
        the cache validates before calling this)."""
        return cls(
            base=tuple(int(v) for v in raw["base"]),
            points=tuple(tuple(int(v) for v in p) for p in raw["points"]),
            n_trials=int(raw["n_trials"]),
            chained=bool(raw["chained"]),
            layers=tuple(
                LayerSensitivity(
                    index=int(l["index"]),
                    entries=tuple(
                        (int(e[0]), int(e[1]), float(e[2]), float(e[3]))
                        for e in l["entries"]))
                for l in raw["layers"]))


def _valid_entry(entry) -> bool:
    if not isinstance(entry, dict):
        return False
    try:
        prof = SensitivityProfile.from_dict(entry)
    except (KeyError, TypeError, ValueError, IndexError):
        return False
    return bool(prof.layers) and all(l.entries for l in prof.layers)


class ProfileCache:
    """One sensitivity-profile cache file (the TuneCache contract).

    `degraded` is True when the file was corrupt or schema-mismatched:
    the cache then answers INVALID for every key and refuses writes, so a
    bad file can neither crash calibration nor grow.  `stats` counts
    hits/misses/invalid lookups."""

    def __init__(self, path: str, entries: Optional[Dict] = None,
                 degraded: bool = False):
        self.path = path
        self.entries: Dict[str, dict] = dict(entries or {})
        self.degraded = degraded
        self.stats = {"hits": 0, "misses": 0, "invalid": 0, "writes": 0}

    @classmethod
    def load(cls, path: str) -> "ProfileCache":
        """Read the cache file; unreadable/corrupt/stale state warns once
        and returns a degraded cache instead of raising."""
        if not os.path.exists(path):
            return cls(path)
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"sensitivity profile cache {path} is unreadable ({e}); "
                "re-calibrating", ProfileCacheWarning, stacklevel=2)
            return cls(path, degraded=True)
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            warnings.warn(
                f"sensitivity profile cache {path} has schema "
                f"{raw.get('schema') if isinstance(raw, dict) else '?'} "
                f"(expected {SCHEMA_VERSION}); re-calibrating",
                ProfileCacheWarning, stacklevel=2)
            return cls(path, degraded=True)
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(
                f"sensitivity profile cache {path} has no entries table; "
                "re-calibrating", ProfileCacheWarning, stacklevel=2)
            return cls(path, degraded=True)
        return cls(path, entries=entries)

    def get(self, key: str) -> Tuple[str, Optional[SensitivityProfile]]:
        """Look one key up: (HIT, profile), (MISS, None) - calibrate and
        store - or (INVALID, None) - warn and calibrate fresh."""
        if self.degraded:
            self.stats["invalid"] += 1
            return INVALID, None
        entry = self.entries.get(key)
        if entry is None:
            self.stats["misses"] += 1
            return MISS, None
        if not _valid_entry(entry):
            self.stats["invalid"] += 1
            warnings.warn(
                f"sensitivity profile entry {key!r} in {self.path} is "
                "invalid; re-calibrating", ProfileCacheWarning,
                stacklevel=2)
            return INVALID, None
        self.stats["hits"] += 1
        return HIT, SensitivityProfile.from_dict(entry)

    def put(self, key: str, profile: SensitivityProfile) -> None:
        """Record one calibrated profile (no-op on a degraded cache)."""
        if self.degraded:
            return
        self.entries[key] = profile.to_dict()
        self.stats["writes"] += 1

    def save(self) -> None:
        """Atomically persist the entries (tmp + rename); degraded caches
        never write.  Directory creation is implicit."""
        if self.degraded:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"schema": SCHEMA_VERSION, "entries": self.entries},
                      fh, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


def _is_chain(specs: Sequence[mapping.LayerSpec]) -> bool:
    if any(s.conv is not None for s in specs):
        return True                       # conv nets only plan chained
    return all(specs[i + 1].k == specs[i].n
               for i in range(len(specs) - 1))


def _input_for(spec: mapping.LayerSpec, batch: int,
               key: torch.Tensor) -> torch.Tensor:
    if spec.conv is not None:
        shape = (batch,) + spec.conv.spatial_in
    else:
        shape = (batch, spec.k)
    return torch.relu(prng.normal(key, shape)) + 0.1


def _trials(prog, params, x, key: torch.Tensor, n: int,
            noisy: bool) -> torch.Tensor:
    if not noisy:
        return prog.run(params, x)[None]
    keys = prng.split(key, n)
    return torch.stack([prog.run(params, x, k) for k in keys])


def _metrics(var: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(logit MSE, top-1 agreement) of `var` against `ref`: the float32
    squared differences summed in float64, the mean rounded to float32;
    the agreement as JAX computes it, count / rows in float32."""
    sq = (var - ref) ** 2
    mse = float(np.float32(float(sq.double().sum()) / sq.numel()))
    hits = int((torch.argmax(var, dim=-1)
                == torch.argmax(ref, dim=-1)).sum())
    rows = var.numel() // var.shape[-1]
    return mse, float(np.float32(hits) / np.float32(rows))


def calibrate(specs: Sequence[mapping.LayerSpec],
              cfg: rt.EngineConfig = rt.EngineConfig(), *,
              points: Sequence[Tuple[int, int]] = PRECISION_CHAIN,
              base: Tuple[int, int] = BASE_POINT,
              n_trials: int = 4, batch: int = 8, seed: int = 0,
              activations: Optional[Sequence[str]] = None,
              pools: Optional[Sequence[int]] = None,
              cache_path: Optional[str] = None,
              label: str = "", device: Device = None) -> SensitivityProfile:
    """Measure (or fetch from the profile cache) a network's per-layer
    precision sensitivity.

    For each layer i and each point p in `points`: run the network with
    every layer at `base` except layer i at p, and record the logit MSE
    and top-1 agreement vs. the all-base reference.  One fp32 parameter
    set (initialized from the base program) is shared across every
    variant, so the deltas isolate quantization/noise, not weights.
    Under a noise-enabled cfg each measurement averages `n_trials`
    seeded Monte-Carlo trials (the same trial keys for variant and
    reference); clean configs run once.

    Args:
      specs: the network's LayerSpecs.  A chained list (k_{i+1} == n_i)
        calibrates end-to-end at the final logits; non-chaining specs
        (e.g. decode-block projections) calibrate per layer on
        independent single-layer programs.
      cfg: shared EngineConfig (noise model, macro).
      points: the swept (r_in, r_w) chain, cheapest first; `base` is
        appended if absent.
      base: the reference precision every non-dropped layer runs at.
      n_trials: Monte-Carlo trials per measurement (noise configs only).
      batch: calibration batch extent.
      seed: PRNG seed for params, inputs and noise trials (part of the
        cache key - same seed, same profile, in either package).
      activations/pools: per-layer epilogues for chained networks
        (plan_network defaults).
      cache_path: profile cache file; None uses default_profile_path(),
        "" disables persistence for this call.
      label: free-form cache-key prefix (distinguish numeric noise
        operating points at one geometry).
      device: where the calibration programs run and the draws land;
        None means CUDA (and raises without a card), "cpu" the host.
    Returns:
      The calibrated (or cached) SensitivityProfile.
    """
    specs = tuple(specs)
    if not specs:
        raise ValueError("calibrate needs at least one LayerSpec")
    dev = resolve_device(device)
    base = (int(base[0]), int(base[1]))
    points = tuple((int(a), int(b)) for a, b in points)
    if base not in points:
        points = points + (base,)
    key_str = profile_key(specs, cfg, points, n_trials, batch, seed, label)
    cache = None
    if cache_path != "":
        cache = ProfileCache.load(
            default_profile_path() if cache_path is None else cache_path)
        status, prof = cache.get(key_str)
        if status == HIT:
            return prof
    CALIBRATION_RUNS["n"] += 1
    noisy = cfg.noise.enabled
    trials = int(n_trials) if noisy else 1
    if trials < 1:
        raise ValueError(f"n_trials must be >= 1, got {n_trials}")
    key = prng.key(seed, device=dev)
    mc_key = prng.fold_in(key, 2)
    chained = _is_chain(specs)
    layers = []
    if chained:
        base_specs = tuple(
            dataclasses.replace(s, r_in=base[0], r_w=base[1])
            for s in specs)
        ref_prog = compile_program(base_specs, cfg,
                                   activations=activations, pools=pools,
                                   device=dev)
        params = list(ref_prog.init_params(prng.fold_in(key, 0)))
        x = _input_for(specs[0], batch, prng.fold_in(key, 1))
        ref = _trials(ref_prog, params, x, mc_key, trials, noisy)
        for i in range(len(specs)):
            entries = []
            for p in points:
                var_specs = (base_specs[:i]
                             + (dataclasses.replace(
                                 base_specs[i], r_in=p[0], r_w=p[1]),)
                             + base_specs[i + 1:])
                prog = compile_program(var_specs, cfg,
                                       activations=activations,
                                       pools=pools, device=dev)
                out = _trials(prog, params, x, mc_key, trials, noisy)
                mse, agree = _metrics(out, ref)
                entries.append((p[0], p[1], mse, agree))
            layers.append(LayerSensitivity(index=i,
                                           entries=tuple(entries)))
    else:
        for i, spec in enumerate(specs):
            base_spec = dataclasses.replace(spec, r_in=base[0],
                                            r_w=base[1])
            ref_prog = compile_program((base_spec,), cfg, device=dev)
            params = list(ref_prog.init_params(prng.fold_in(key, 10 + i)))
            x = _input_for(spec, batch, prng.fold_in(key, 50 + i))
            ref = _trials(ref_prog, params, x, mc_key, trials, noisy)
            entries = []
            for p in points:
                prog = compile_program(
                    (dataclasses.replace(base_spec, r_in=p[0],
                                         r_w=p[1]),), cfg, device=dev)
                out = _trials(prog, params, x, mc_key, trials, noisy)
                mse, agree = _metrics(out, ref)
                entries.append((p[0], p[1], mse, agree))
            layers.append(LayerSensitivity(index=i,
                                           entries=tuple(entries)))
    prof = SensitivityProfile(base=base, points=points, n_trials=trials,
                              chained=chained, layers=tuple(layers))
    if cache is not None:
        cache.put(key_str, prof)
        cache.save()
    return prof
