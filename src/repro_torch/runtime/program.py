"""Compiled CIM programs: plan once, serve many (the deployment API).

Counterpart of `repro/runtime/program.py` on the clean single-device path:

    prog   = compile_program(specs, EngineConfig(...))   # plan once; CUDA
    params = prog.init_params(torch.Generator().manual_seed(0))
    bound  = prog.bind(params)          # weights pre-quantized, on the card
    y      = bound.serve(x)             # ragged batch -> bucketed dispatch
    ys     = bound.serve_batch([x1, x2, x3])
    prog.stats()                        # plans / dispatch shapes / buckets

* **Plan cache** - `compile_program` keys a module-level cache on
  (specs, cfg, activations, pools, buckets, device): equal programs share
  one `NetworkPlan` (planned exactly once - engine.PLAN_COUNT counts).
* **Batch bucketing** - `serve` pads the leading batch axis up to a
  power-of-two ladder rung (`BatchBuckets`).  Pad rows are copies of row
  0, re-pinned before every layer (engine._mask_pad_rows), so the dynamic
  activation-quantization statistics and every live-row bit equal an
  unpadded run.  Eager PyTorch compiles nothing per shape, but the rungs
  bound the set of dispatch shapes a later CUDA-graph capture would need;
  `stats()` counts them under the JAX package's names.
* **Weight binding** - `bind(params)` runs engine.bind_network once on the
  host (weight quantization to the odd-integer grid, ABN gamma, col-tile
  padding) and moves the products to the program's device.

A program runs on one device, CUDA by default: with no card,
`compile_program` raises rather than carry on on the CPU, and the CPU
path (the kernels' plain versions) must be asked for with device="cpu".
Per-request isolation (segments, noise ids, `isolate=True`), noise, the
LRU capacity and `SharedInputProgram` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import mapping
from repro_torch.runtime import engine as rt

Device = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class BatchBuckets:
    """Power-of-two ladder of batch bucket sizes.

    A request of leading batch extent m dispatches at the smallest rung
    `min_bucket * 2^i >= m`; with `max_bucket` set the ladder is capped
    there and larger requests pad to the next *multiple* of max_bucket.
    """
    min_bucket: int = 1
    max_bucket: int = 0

    def __post_init__(self):
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got "
                             f"{self.min_bucket}")
        if self.max_bucket and self.max_bucket < self.min_bucket:
            raise ValueError(
                f"max_bucket {self.max_bucket} < min_bucket "
                f"{self.min_bucket}")

    def bucket_for(self, m: int) -> int:
        """The padded batch extent a request of `m` rows dispatches at."""
        if m < 1:
            raise ValueError(f"batch extent must be >= 1, got {m}")
        cap = self.max_bucket
        if cap and m > cap:
            return cap * -(-m // cap)        # beyond the ladder: cap grid
        b = self.min_bucket
        while b < m:
            b *= 2
        return min(b, cap) if cap else b

    def ladder(self, max_m: int) -> Tuple[int, ...]:
        """Every distinct bucket requests of size 1..max_m can land on."""
        return tuple(sorted({self.bucket_for(m)
                             for m in range(1, max_m + 1)}))


DEFAULT_BUCKETS = BatchBuckets()

_STAT_KEYS = ("plans_built", "executables_compiled", "bucket_hits",
              "bucket_misses", "run_calls", "serve_calls")


def resolve_device(device: Device) -> torch.device:
    """The device a program runs on: CUDA unless the caller names another.
    Raises when CUDA is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "program through the kernels' plain PyTorch versions")
    return dev


def _unported(**kw) -> None:
    for name, value in kw.items():
        if value:
            raise NotImplementedError(
                f"{name} (per-request isolation) is not ported yet")


class CIMProgram:
    """An immutable compiled CIM inference artifact on one device.

    Owns one `NetworkPlan` (planned exactly once).  `run` dispatches at the
    exact batch extent, `serve` through the batch-bucket ladder; both take
    per-call params (bound on every call - use `bind` to hoist it)."""

    __slots__ = ("_plan", "_buckets", "_device", "_shapes", "_stats")

    def __init__(self, plan: rt.NetworkPlan,
                 buckets: BatchBuckets = DEFAULT_BUCKETS,
                 device: Device = None):
        object.__setattr__(self, "_plan", plan)
        object.__setattr__(self, "_buckets", buckets)
        object.__setattr__(self, "_device", resolve_device(device))
        object.__setattr__(self, "_shapes", set())
        object.__setattr__(self, "_stats",
                           {k: 0 for k in _STAT_KEYS} | {"plans_built": 1})

    def __setattr__(self, name, value):
        raise AttributeError("CIMProgram is immutable")

    def __repr__(self):
        return (f"CIMProgram({len(self._plan.layers)} layers, "
                f"buckets={self._buckets}, device={self._device})")

    @property
    def plan(self) -> rt.NetworkPlan:
        """The NetworkPlan this program executes."""
        return self._plan

    @property
    def device(self) -> torch.device:
        """The device every dispatch of this program runs on."""
        return self._device

    def init_params(self, generator: torch.Generator) -> rt.Params:
        """Distribution-aware per-layer parameters (core/cim_layers init),
        drawn on the host from `generator`."""
        return rt.init_network_params(self._plan, generator)

    def bind(self, params: rt.Params) -> "BoundProgram":
        """Pre-quantize/pack the weights on the host and move them to the
        program's device.  Returns a BoundProgram closed over the
        engine.bind_network products."""
        return BoundProgram(self, rt.bind_network(self._plan, list(params),
                                                  self._device))

    # -- dispatch ----------------------------------------------------------

    def _canon(self, x) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """Collapse leading dims to one canonical batch axis on the
        program's device."""
        x = torch.as_tensor(x).to(self._device)
        g = self._plan.layers[0].spec.conv
        if g is not None:
            if x.dim() < 4 or tuple(x.shape[-3:]) != g.spatial_in:
                raise ValueError(
                    f"input shape {tuple(x.shape)} != first conv layer's "
                    f"(..., {g.h}, {g.w}, {g.c_in})")
            return x.reshape((-1,) + tuple(x.shape[-3:])), \
                tuple(x.shape[:-3])
        k0 = self._plan.layers[0].spec.k
        if x.dim() < 1 or x.shape[-1] != k0:
            raise ValueError(
                f"input width {x.shape[-1] if x.dim() else 0} != first "
                f"layer's k={k0}")
        return x.reshape((-1, k0)), tuple(x.shape[:-1])

    def _note_dispatch(self, key: tuple, bucketed: bool) -> None:
        st = self._stats
        st["serve_calls" if bucketed else "run_calls"] += 1
        if key in self._shapes:
            if bucketed:
                st["bucket_hits"] += 1
            return
        self._shapes.add(key)
        st["executables_compiled"] += 1
        if bucketed:
            st["bucket_misses"] += 1

    def run(self, params: rt.Params, x, *,
            reference: bool = False) -> torch.Tensor:
        """Exact-shape dispatch (no bucketing).  `reference=True` runs the
        plain digital oracle of the same schedule."""
        binds = rt.bind_network(self._plan, list(params), self._device)
        xc, lead = self._canon(x)
        self._note_dispatch(("exact", xc.shape[0], False, bool(reference)),
                            bucketed=False)
        y = rt._forward(self._plan, binds, xc, reference=bool(reference))
        return y.reshape(lead + tuple(y.shape[1:]))

    def serve(self, params: rt.Params, x, *,
              reference: bool = False) -> torch.Tensor:
        """Batch-bucketed dispatch with per-call params (weights bound on
        every call - use bind(params).serve(...) to hoist it)."""
        binds = rt.bind_network(self._plan, list(params), self._device)
        return self._serve_padded(binds, False, x, bool(reference))

    def _serve_padded(self, binds, bound: bool, x,
                      reference: bool) -> torch.Tensor:
        xc, lead = self._canon(x)
        m = xc.shape[0]
        if m < 1:
            raise ValueError("cannot serve an empty batch")
        bucket = self._buckets.bucket_for(m)
        if bucket > m:
            pad = xc[:1].expand((bucket - m,) + tuple(xc.shape[1:]))
            xc = torch.cat([xc, pad], dim=0)
        self._note_dispatch(("bucket", bucket, bound, reference),
                            bucketed=True)
        y = rt._forward(self._plan, binds, xc, reference=reference,
                        m_valid=m)
        return y[:m].reshape(lead + tuple(y.shape[1:]))

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Counters of this program: plans_built (always 1),
        executables_compiled (distinct dispatch signatures: kind, batch
        extent, bound, reference), bucket_hits/bucket_misses (serve-path
        ladder lookups), run_calls/serve_calls."""
        return dict(self._stats)


class BoundProgram:
    """A CIMProgram closed over pre-quantized weights on its device.

    `serve(x)` dispatches one request through the batch-bucket ladder;
    `serve_batch([x1, ...])` concatenates requests, serves the fused batch
    once and splits the results back per request - the dynamic
    activation-quantization statistics are shared across the fused batch,
    so the result is bit-exact with `serve(concat(requests))`."""

    __slots__ = ("program", "_binds")

    def __init__(self, program: CIMProgram, binds: Tuple[Dict, ...]):
        object.__setattr__(self, "program", program)
        object.__setattr__(self, "_binds", binds)

    def __setattr__(self, name, value):
        raise AttributeError("BoundProgram is immutable")

    @property
    def plan(self) -> rt.NetworkPlan:
        """The backing program's NetworkPlan."""
        return self.program.plan

    def serve(self, x, *, segments=None, noise_ids=None,
              reference: bool = False) -> torch.Tensor:
        """Bucketed dispatch of one request through the bound weights
        (bit-exact with the unbucketed engine on the same inputs).  The
        result stays on the program's device."""
        _unported(segments=segments is not None,
                  noise_ids=noise_ids is not None)
        return self.program._serve_padded(self._binds, True, x,
                                          bool(reference))

    def reference(self, x) -> torch.Tensor:
        """The plain digital oracle of serve (bit-exact with it)."""
        return self.serve(x, reference=True)

    def serve_batch(self, requests: Sequence, *,
                    isolate: bool = False) -> List[torch.Tensor]:
        """Multi-request serving: concatenate, bucket-pad, dispatch once,
        split.  Returns one result per request, in order."""
        _unported(isolate=isolate)
        if not requests:
            return []
        xs = [torch.as_tensor(r).to(self.program.device) for r in requests]
        feat = tuple(xs[0].shape[1:])
        for i, r in enumerate(xs):
            if r.dim() != len(feat) + 1 or tuple(r.shape[1:]) != feat:
                raise ValueError(
                    f"request {i} shape {tuple(r.shape)} is not batch-major "
                    f"with feature shape {feat}")
        sizes = [r.shape[0] for r in xs]
        y = self.serve(torch.cat(xs, dim=0))
        return list(torch.split(y, sizes, dim=0))


# ---------------------------------------------------------------------------
# the global program cache
# ---------------------------------------------------------------------------

_PROGRAM_CACHE: Dict[tuple, CIMProgram] = {}
_CACHE_STATS = {"programs_built": 0, "lookups": 0, "hits": 0}


def _canonical_epilogues(n_layers: int,
                         activations: Optional[Sequence[str]],
                         pools: Optional[Sequence[int]]
                         ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """plan_network's defaulting, applied eagerly so cache keys are
    canonical (None and the equivalent explicit lists hit one entry)."""
    acts = (("relu",) * (n_layers - 1) + ("none",)
            if activations is None else tuple(activations))
    pls = (1,) * n_layers if pools is None else tuple(pools)
    return acts, pls


def compile_program(specs: Sequence[mapping.LayerSpec],
                    cfg: rt.EngineConfig = rt.EngineConfig(), *,
                    activations: Optional[Sequence[str]] = None,
                    pools: Optional[Sequence[int]] = None,
                    buckets: BatchBuckets = DEFAULT_BUCKETS,
                    device: Device = None) -> CIMProgram:
    """Compile (or fetch from the global cache) the program for a network.

    Args:
      specs: the network's (conv-tagged) LayerSpecs, in order.
      cfg: shared EngineConfig (macro, gamma settings, block sizes).
      activations/pools: per-layer epilogues (plan_network defaults).
      buckets: the serve-path batch-bucket ladder.
      device: where the program runs; None means "cuda", and raises when
        there is no card (pass device="cpu" for the host path).
    Returns:
      The cached (or freshly planned) CIMProgram.
    """
    dev = resolve_device(device)
    specs = tuple(specs)
    acts, pls = _canonical_epilogues(len(specs), activations, pools)
    key = (specs, cfg, acts, pls, buckets, str(dev))
    _CACHE_STATS["lookups"] += 1
    prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        _CACHE_STATS["hits"] += 1
        return prog
    plan = rt.plan_network(specs, cfg, acts, pls)
    prog = CIMProgram(plan, buckets, dev)
    _PROGRAM_CACHE[key] = prog
    _CACHE_STATS["programs_built"] += 1
    return prog


def program_cache_stats() -> Dict[str, int]:
    """Global program-cache counters: programs (live cached programs),
    programs_built, lookups and hits (compile_program key hits)."""
    return dict(_CACHE_STATS, programs=len(_PROGRAM_CACHE))


def clear_program_cache() -> None:
    """Drop every cached program and reset the cache counters."""
    _PROGRAM_CACHE.clear()
    for k in list(_CACHE_STATS):
        _CACHE_STATS[k] = 0
