"""Versioned on-disk autotune cache (winners persist, plans stay one-shot).

Counterpart of `repro/tuner/cache.py`, with a file of its own: the port's
winners are Hopper route tiles, which mean nothing to the JAX package,
and the JAX package's Pallas blocks nothing here.  The cache is one JSON
file: `{"schema": N, "entries": {key: entry}}`.  Keys encode everything a
winner depends on - tile geometry (m, k, n), precision (r_in, r_w,
r_out), conv/dense kind, device count, macro geometry and the card table
(`GPUSpec.name`), so another card's winner is never taken - plus the
schema version at the file level.

Degradation policy (as the JAX package's): a corrupt file, a
schema/version mismatch, or an invalid individual entry NEVER crashes
compilation - the affected layers fall back to the heuristic schedule
with a single `TuneCacheWarning`, and a degraded cache neither searches
nor writes (so a bad file cannot grow).  A *missing* entry is normal
operation: the search runs once and the winner is written back atomically
(tmp + rename).  A valid hit skips the search entirely - observable
through `search.SEARCH_COUNT`.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional, Tuple

from repro_torch.core.hw import (CIMMacroConfig, DEFAULT_MACRO, GPUSpec,
                                 H100_SXM)
from repro_torch.core.mapping import LayerSpec
from repro_torch.kernels.cim_mbiw.kernel import check_tile
from repro_torch.tuner.cost import ScheduleChoice

SCHEMA_VERSION = 1

# statuses TuneCache.get can report for a key
HIT, MISS, INVALID = "hit", "miss", "invalid"

_KINDS = (None, "col", "rows")


class TuneCacheWarning(UserWarning):
    """A cache file or entry was unusable; the heuristic schedule ran."""


def default_cache_path() -> str:
    """The cache location: $REPRO_TORCH_AUTOTUNE_CACHE or
    ~/.cache/repro-cim/autotune_torch.json."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-cim",
                        "autotune_torch.json")


def cache_key(spec: LayerSpec, devices: int,
              macro: CIMMacroConfig = DEFAULT_MACRO,
              gpu: GPUSpec = H100_SXM, *, folded: bool = False) -> str:
    """The string key one layer's winner is stored under: tile geometry,
    precision, conv/dense kind, device count (with "f" when the
    partitions are folded onto one card, which the cost prices apart),
    macro geometry and the card table.  The schema version lives at the
    file level, not in the key."""
    kind = "conv" if spec.conv is not None else "dense"
    return (f"m{spec.m}k{spec.k}n{spec.n}"
            f"r{spec.r_in}x{spec.r_w}x{spec.r_out}"
            f"{kind}d{int(devices)}{'f' if folded else ''}"
            f"g{macro.n_rows}x{macro.n_cols}@{gpu.name}")


def _entry_choice(entry, planes: int) -> Optional[ScheduleChoice]:
    """The entry's choice, or None when it is not a legal tile at
    `planes` input planes with a known shard kind."""
    if not isinstance(entry, dict) or entry.get("shard_kind", 0) \
            not in _KINDS:
        return None
    tile = tuple(entry.get(f) for f in ("route", "bm", "bn", "bk"))
    try:
        check_tile(tile, planes)
    except ValueError:
        return None
    return ScheduleChoice(*tile, shard_kind=entry["shard_kind"])


class TuneCache:
    """One autotune cache file, loaded once per compile.

    `degraded` is True when the file was corrupt or schema-mismatched: the
    cache then answers INVALID for every key and refuses writes.  `stats`
    counts hits/misses/invalid lookups (test observability)."""

    def __init__(self, path: str, entries: Optional[Dict] = None,
                 degraded: bool = False):
        self.path = path
        self.entries: Dict[str, dict] = dict(entries or {})
        self.degraded = degraded
        self.stats = {"hits": 0, "misses": 0, "invalid": 0, "writes": 0}

    @classmethod
    def load(cls, path: str) -> "TuneCache":
        """Read the cache file; any unreadable/corrupt/stale state warns
        once and returns a degraded cache (heuristic fallback, no
        searching, no writes) instead of raising."""
        if not os.path.exists(path):
            return cls(path)
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"autotune cache {path} is unreadable ({e}); falling back "
                "to heuristic schedules", TuneCacheWarning, stacklevel=2)
            return cls(path, degraded=True)
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            warnings.warn(
                f"autotune cache {path} has schema "
                f"{raw.get('schema') if isinstance(raw, dict) else '?'} "
                f"(expected {SCHEMA_VERSION}); falling back to heuristic "
                "schedules", TuneCacheWarning, stacklevel=2)
            return cls(path, degraded=True)
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(
                f"autotune cache {path} has no entries table; falling "
                "back to heuristic schedules", TuneCacheWarning,
                stacklevel=2)
            return cls(path, degraded=True)
        return cls(path, entries=entries)

    def get(self, key: str, planes: int = 1
            ) -> Tuple[str, Optional[ScheduleChoice]]:
        """Look one key up: (HIT, choice), (MISS, None) - search and
        store - or (INVALID, None) - warn and run the heuristic.  An
        entry is valid when it holds a tile a route launches at the
        layer's `planes` input planes."""
        if self.degraded:
            self.stats["invalid"] += 1
            return INVALID, None
        entry = self.entries.get(key)
        if entry is None:
            self.stats["misses"] += 1
            return MISS, None
        choice = _entry_choice(entry, planes)
        if choice is None:
            self.stats["invalid"] += 1
            warnings.warn(
                f"autotune cache entry {key!r} in {self.path} is invalid; "
                "using the heuristic schedule for that layer",
                TuneCacheWarning, stacklevel=2)
            return INVALID, None
        self.stats["hits"] += 1
        return HIT, choice

    def put(self, key: str, choice: ScheduleChoice, *, mode: str,
            total_s: float) -> None:
        """Record one winner (no-op on a degraded cache)."""
        if self.degraded:
            return
        self.entries[key] = {
            "route": choice.route, "bm": int(choice.bm),
            "bn": int(choice.bn), "bk": int(choice.bk),
            "shard_kind": choice.shard_kind, "mode": mode,
            "total_s": float(total_s),
        }
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
