"""Compiled CIM programs: plan once, serve many (the deployment API).

Counterpart of `repro/runtime/program.py`:

    prog   = compile_program(specs, EngineConfig(...))   # plan once; CUDA
    params = prog.init_params(torch.Generator().manual_seed(0))
    bound  = prog.bind(params)          # weights pre-quantized, on the card
    y      = bound.serve(x)             # ragged batch -> bucketed dispatch
    ys     = bound.serve_batch([x1, x2, x3])
    prog.stats()                        # plans / dispatch shapes / buckets
    prog.perf_report(point="quality")   # the macro model's projection

* **Plan cache** - `compile_program` keys a module-level LRU cache on
  (specs, cfg, activations, pools, buckets, device), and behind it a
  second LRU table on (plan, buckets, device) (`program_for_plan`): equal
  programs share one `NetworkPlan` (planned exactly once -
  engine.PLAN_COUNT counts) and one `CIMProgram`.  Both tables hold
  at most `set_program_cache_capacity` entries ($REPRO_PROGRAM_CACHE_CAP,
  512); an evicted program keeps serving wherever it is held.
* **Batch bucketing** - `serve` pads the leading batch axis up to a
  power-of-two ladder rung (`BatchBuckets`).  Pad rows are copies of row
  0, re-pinned before every layer (engine._mask_pad_rows), so the dynamic
  activation-quantization statistics and every live-row bit equal an
  unpadded run.  The rungs bound the set of dispatch keys;
  `stats()` counts them under the JAX package's names.
* **Executables** - on a CUDA device, a clean dispatch of a bound program
  (no key, no noise, not the reference) runs as a CUDA graph of
  engine._forward at the bucket extent, one per dispatch key, captured on
  the key's first call (after one eager warm-up run on a side stream,
  whose result that call returns) and replayed after it: the live rows,
  their count and the segment ids are copied into the graph's static
  buffers, and the caller gets a clone of its static output.  Every other
  dispatch runs eagerly, as a declared route: the CPU, keyed or noisy
  dispatches (their stream keys and noise terms derive on the host),
  `reference=True` (the plain oracle reads numpy), per-call params
  (`CIMProgram.run`/`serve` bind on every call) and a sharded dispatch
  whose partitions span cards.  engine.CAPTURE_COUNT counts captures
  and their host seconds (flat after warm-up); `stats()` counts
  graphs_captured, graph_replays and eager_calls.  Graphs of one device
  share one memory pool: safe because their inputs sit outside it, their
  outputs stay referenced by their executables and are cloned on return,
  and replays run one after another on the current stream.  Nothing falls
  back: a capture or replay that raises, raises.
* **Weight binding** - `bind(params)` runs engine.bind_network once on the
  host (weight quantization to the odd-integer grid, ABN gamma, col-tile
  padding) and moves the products to the program's device
  (engine.BIND_COUNT counts binds and their host seconds).
* **Bound programs of per-call params** - `bound_for(program, params)`
  is the one BoundProgram of a single-layer program over one layer's
  weights, the engine-mode layer's (`core/cim_layers`): bound on first
  sight, held as long as the weight tensor lives, and re-bound when the
  layer's tensors are replaced or changed in place (`Tensor._version`,
  `data_ptr`).  Programs of one layer at different batch buckets share
  its bind products (`engine.bind_key`), so a weight is quantized once.
  Repeated calls with the same weights replay their graphs and never
  re-bind.
* **Per-request isolation** - `serve(..., segments=)` quantizes each
  segment's rows with its own activation swing, and
  `serve_batch(..., isolate=True)` makes each request its own segment, so
  a fused request is bit-identical to serving it alone.
* **Shared-input fusion** - `SharedInputProgram` serves several
  projections of one input (Q/K/V, gate/up) as one wide program.
* **Sharded plans** (EngineConfig.sharding) serve through the same API:
  each layer's tiles or rows run across the plan's mesh partitions
  (engine._sharded_schedule), and the bucket padding composes with both
  shard kinds bit for bit.  The dispatch key carries the mesh size D.
  `bind` places each partition's share of the weights on its device
  (views of one copy when the partitions are folded onto the program's
  device).  A clean dispatch whose partitions all sit on the program's
  device is one CUDA graph like any other; one whose partitions span
  cards runs eagerly and counts in eager_calls.

* **Noise** - a program planned with `EngineConfig(noise=...)` runs the
  noise model and needs a PRNG key (`core/prng.key`) on every dispatch;
  `noise=` overrides the planned numeric terms, and `noise_ids=` key the
  thermal draws by sample identity, so `serve_batch(..., key,
  isolate=True)` is bit-identical to each request's solo serve under
  `request_noise_ids`.  A key with a NO_NOISE plan is ignored.

A program runs on one device (its partitions on its mesh), CUDA by
default: with no card,
`compile_program` raises rather than carry on on the CPU, and the CPU
path (the kernels' plain versions) must be asked for with device="cpu".
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import mapping
from repro_torch.kernels.cim_mbiw import kernel as kmod
from repro_torch.runtime import engine as rt
from repro_torch.runtime import tracing

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
              "bucket_misses", "run_calls", "serve_calls", "graphs_captured",
              "graph_replays", "eager_calls")

# stride separating per-request noise-id ranges (request_noise_ids):
# 2^20 rows per request before ids collide
NOISE_ID_STRIDE = 1 << 20


def request_noise_ids(request_index: int, rows: int) -> torch.Tensor:
    """Canonical per-row noise-identity ids of one request: (request_index,
    row) maps to `request_index * NOISE_ID_STRIDE + row` (int32, on the
    host).  Raises ValueError when the range would leave int32
    (request_index >= 2048 at the default stride)."""
    if request_index < 0:
        raise ValueError(f"request_index must be >= 0, got {request_index}")
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    base = request_index * NOISE_ID_STRIDE       # python int: no wrap
    if base + rows - 1 > 0x7FFFFFFF:
        raise ValueError(
            f"request_noise_ids({request_index}, {rows}) spans "
            f"[{base}, {base + rows}) which overflows int32; at stride "
            f"{NOISE_ID_STRIDE} only request indices < "
            f"{(0x7FFFFFFF + 1) // NOISE_ID_STRIDE} are representable")
    return torch.arange(rows, dtype=torch.int32) + base


# the dispatch-signature fields a dispatch key discriminates, under the
# JAX package's names; `executable_key` is their one constructor
EXEC_KEY_FIELDS = ("kind", "extent", "noise", "keyed", "devices", "bound",
                   "reference", "segmented", "identity", "point")


def executable_key(kind: str, extent: int, *, noise: bool, keyed: bool,
                   devices: int, bound: bool, reference: bool,
                   segmented: bool, identity: bool,
                   point: str = "") -> tuple:
    """The key of one dispatch signature: kind ("exact"/"bucket"), batch
    extent, the operand-presence flags (noise operands, PRNG key, device
    count, bound params, reference oracle, segment ids, noise-identity
    ids) and the serving operating-point tag (`point`, "" for the base
    point).  A bound program on the card holds one CUDA graph per clean
    key; `stats()` counts the distinct keys.  Keep in sync with
    EXEC_KEY_FIELDS."""
    return (kind, int(extent), bool(noise), bool(keyed), int(devices),
            bool(bound), bool(reference), bool(segmented), bool(identity),
            str(point))


def resolve_device(device: Device) -> torch.device:
    """The device a program runs on: CUDA unless the caller names another.
    Raises when CUDA is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "program through the kernels' plain PyTorch versions")
    if dev.type == "cuda" and dev.index is None:
        # name the card, as a tensor placed there names it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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

    def __hash__(self):
        return hash((self._plan, self._buckets, str(self._device)))

    def __eq__(self, other):
        return (type(other) is CIMProgram and self._plan == other._plan
                and self._buckets == other._buckets
                and self._device == other._device)

    def __repr__(self):
        return (f"CIMProgram({len(self._plan.layers)} layers, "
                f"buckets={self._buckets}, device={self._device})")

    @property
    def plan(self) -> rt.NetworkPlan:
        """The NetworkPlan this program executes."""
        return self._plan

    @property
    def cfg(self) -> rt.EngineConfig:
        """The plan's shared EngineConfig."""
        return self._plan.cfg

    @property
    def buckets(self) -> BatchBuckets:
        """The batch-bucket ladder `serve` pads requests onto."""
        return self._buckets

    @property
    def device(self) -> torch.device:
        """The device every dispatch of this program runs on."""
        return self._device

    def init_params(self, source) -> rt.Params:
        """Distribution-aware per-layer parameters (core/cim_layers init),
        drawn from a `torch.Generator` on its device, or from a
        `core/prng` key ((2,) int64) on the key's device - the JAX
        package's `init_params(key)` bit for bit."""
        return rt.init_network_params(self._plan, source)

    def perf_report(self, **kw) -> Dict[str, object]:
        """perfmodel.schedule_report of the plan, with this program's
        counters (`stats()`, the graph counters included) and bucket
        ladder echoed under report["program"].  Its times and TOPS/W
        are the IMAGINE macro model's projections, not measurements of
        the device the program runs on."""
        from repro_torch.perfmodel.macro_perf import schedule_report
        return schedule_report(self._plan, program=self, **kw)

    def bind(self, params: rt.Params) -> "BoundProgram":
        """Pre-quantize/pack the weights on the host and move them to the
        program's device.  Returns a BoundProgram closed over the
        engine.bind_network products."""
        return BoundProgram(self, rt.bind_network(self._plan, list(params),
                                                  self._device))

    # -- dispatch ----------------------------------------------------------

    def _devices(self) -> int:
        sh = self._plan.cfg.sharding
        return sh.resolve_devices() if sh is not None else 1

    def _on_one_device(self) -> bool:
        """Whether every partition of the plan runs on the program's device
        (always, for a one-device plan): the condition for a CUDA graph."""
        mesh = rt.engine_mesh(self._plan, self._device)
        return mesh is None or set(mesh.devices) == {self._device}

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

    def _canon_rows(self, v, m: int, name: str) -> Optional[torch.Tensor]:
        """Canonicalize an optional per-sample id vector (segments) against
        the collapsed batch extent `m`, onto the program's device.  Ids on
        the host are range-checked to [0, m) first."""
        if v is None:
            return None
        v = torch.as_tensor(v).reshape(-1)
        if v.shape[0] != m:
            raise ValueError(
                f"{name} has {v.shape[0]} entries for batch extent {m}")
        if v.is_floating_point() or v.is_complex():
            raise ValueError(f"{name} must hold integer ids, got {v.dtype}")
        if v.device.type == "cpu" and m and (int(v.min()) < 0
                                             or int(v.max()) >= m):
            raise ValueError(f"{name} ids must lie in [0, {m})")
        return v.to(self._device, torch.int64)

    @staticmethod
    def _canon_ids(v, m: int) -> Optional[torch.Tensor]:
        """Canonicalize optional per-sample noise ids against the batch
        extent `m`: int64 on the HOST (they only derive draw keys there),
        wrapping modulo 2^32 as JAX's int32 ids fold."""
        if v is None:
            return None
        v = torch.as_tensor(v).reshape(-1)
        if v.shape[0] != m:
            raise ValueError(
                f"noise_ids has {v.shape[0]} entries for batch extent {m}")
        if v.is_floating_point() or v.is_complex():
            raise ValueError(f"noise_ids must hold integer ids, got "
                             f"{v.dtype}")
        return v.to("cpu", torch.int64)

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

    def run(self, params: rt.Params, x, key=None, noise=None, *,
            segments=None, noise_ids=None,
            reference: bool = False) -> torch.Tensor:
        """Exact-shape dispatch (no bucketing).  `reference=True` runs the
        plain digital oracle of the same schedule; `segments`/`noise_ids`
        are optional per-sample ids (segment-wise activation quantization
        and identity-keyed noise draws - see BoundProgram.serve).  `key`
        seeds a noise-enabled plan, `noise` overrides its numeric
        terms."""
        nz = rt._dispatch_noise(self._plan, noise)
        binds = rt.bind_network(self._plan, list(params), self._device)
        xc, lead = self._canon(x)
        seg = self._canon_rows(segments, xc.shape[0], "segments")
        nid = self._canon_ids(noise_ids, xc.shape[0])
        self._note_dispatch(
            executable_key("exact", xc.shape[0], noise=nz is not None,
                           keyed=key is not None, devices=self._devices(),
                           bound=False,
                           reference=bool(reference),
                           segmented=seg is not None,
                           identity=nid is not None),
            bucketed=False)
        self._stats["eager_calls"] += 1
        y = rt._forward(self._plan, binds, xc, reference=bool(reference),
                        key=key, noise=nz, seg=seg, nids=nid)
        return y.reshape(lead + tuple(y.shape[1:]))

    def serve(self, params: rt.Params, x, key=None, noise=None, *,
              segments=None, noise_ids=None, reference: bool = False,
              point: str = "") -> torch.Tensor:
        """Batch-bucketed dispatch with per-call params (weights bound on
        every call - use bind(params).serve(...) to hoist it).  `point`
        tags the dispatch with a serving operating-point name (it joins
        the dispatch key; "" is the base point)."""
        binds = rt.bind_network(self._plan, list(params), self._device)
        return self._serve_padded(binds, None, x, key, noise,
                                  bool(reference), segments, noise_ids,
                                  point)

    def _serve_padded(self, binds, execs: Optional[Dict], x, key, noise,
                      reference: bool, segments=None, noise_ids=None,
                      point: str = "") -> torch.Tensor:
        """One bucketed dispatch.  `execs` is the bound program's table of
        captured executables (None with per-call params): a clean
        dispatch on the card replays (or captures) the graph of its key,
        every other (a sharded dispatch across cards included) runs
        engine._forward eagerly.  Under a profiler the call is the span
        "program.dispatch" (`runtime/tracing.py`) with its route
        ("replay", "capture" or "eager"), bucket and rows."""
        with tracing.span("program.dispatch") as sp:
            nz = rt._dispatch_noise(self._plan, noise)
            xc, lead = self._canon(x)
            m = xc.shape[0]
            if m < 1:
                raise ValueError("cannot serve an empty batch")
            seg = self._canon_rows(segments, m, "segments")
            nid = self._canon_ids(noise_ids, m)
            bucket = self._buckets.bucket_for(m)
            if bucket > m:
                # pad ids mirror the pad rows (copies of row 0): the pad
                # rows stay duplicates inside row 0's segment, so no
                # segment's min/max can move and live rows stay bit-exact
                if seg is not None:
                    seg = torch.cat([seg, seg[:1].expand(bucket - m)])
                if nid is not None:
                    nid = torch.cat([nid, nid[:1].expand(bucket - m)])
            ekey = executable_key("bucket", bucket, noise=nz is not None,
                                  keyed=key is not None,
                                  devices=self._devices(),
                                  bound=execs is not None,
                                  reference=reference,
                                  segmented=seg is not None,
                                  identity=nid is not None,
                                  point=str(point))
            self._note_dispatch(ekey, bucketed=True)
            st = self._stats
            if (execs is not None and self._device.type == "cuda"
                    and key is None and nz is None and not reference
                    and self._on_one_device()):
                ex = execs.get(ekey)
                sp.annotate(route="capture" if ex is None else "replay",
                            bucket=bucket, rows=m)
                if ex is None:
                    ex, y = _Executable.capture(self._plan, binds, xc,
                                                bucket, seg)
                    execs[ekey] = ex
                    st["graphs_captured"] += 1
                else:
                    y = ex.replay(xc, seg)
                    st["graph_replays"] += 1
            else:
                sp.annotate(route="eager", bucket=bucket, rows=m)
                st["eager_calls"] += 1
                if bucket > m:
                    pad = xc[:1].expand((bucket - m,)
                                        + tuple(xc.shape[1:]))
                    xc = torch.cat([xc, pad], dim=0)
                y = rt._forward(self._plan, binds, xc, reference=reference,
                                key=key, noise=nz, m_valid=m, seg=seg,
                                nids=nid)
            return y[:m].reshape(lead + tuple(y.shape[1:]))

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Counters of this program: plans_built (always 1),
        executables_compiled (distinct dispatch keys, `executable_key`),
        bucket_hits/bucket_misses (serve-path ladder lookups),
        run_calls/serve_calls, and the dispatch routes' counters:
        graphs_captured (CUDA graphs captured by the program's bound
        copies), graph_replays, and eager_calls (every dispatch that ran
        engine._forward eagerly)."""
        return dict(self._stats)


# one graph memory pool and one warm-up stream per device
_GRAPH_POOLS: Dict[torch.device, tuple] = {}
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _graph_pool(dev: torch.device) -> tuple:
    if dev not in _GRAPH_POOLS:
        _GRAPH_POOLS[dev] = torch.cuda.graph_pool_handle()
    return _GRAPH_POOLS[dev]


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


class _Executable:
    """One clean dispatch key of a bound program, captured as a CUDA
    graph of engine._forward at the bucket extent.  It owns the static
    buffers the graph reads - the rows `x` (float32, allocated outside
    the graph pool; rows past the live count are re-pinned to row 0 before
    the first layer, so whatever they hold never reaches a result), the
    live-row count `m_valid` (0-d int64) and the padded segment ids `seg`
    (int64, or None) - the static output `out`, and the cim_mbiw launches
    the capture recorded, which each replay adds to the wrapper's
    counters."""

    __slots__ = ("graph", "x", "m_valid", "seg", "out", "launches")

    def _fill(self, xc: torch.Tensor, seg: Optional[torch.Tensor]) -> None:
        self.x[:xc.shape[0]].copy_(xc)
        self.m_valid.fill_(xc.shape[0])
        if self.seg is not None:
            self.seg.copy_(seg)

    @classmethod
    def capture(cls, plan: rt.NetworkPlan, binds, xc: torch.Tensor,
                bucket: int, seg: Optional[torch.Tensor]
                ) -> Tuple["_Executable", torch.Tensor]:
        """Warm up and capture: one eager run on a side stream (it builds
        the kernels and sizes route B's workspace, and its result is
        returned as this call's), then the capture under no_grad into
        the device's shared graph pool.  Returns (the executable, the
        warm-up's bucket-extent result).  Counts in engine.CAPTURE_COUNT,
        with its host seconds."""
        t0 = time.perf_counter()
        dev = xc.device
        ex = cls()
        ex.x = torch.zeros((bucket,) + tuple(xc.shape[1:]),
                           dtype=torch.float32, device=dev)
        ex.m_valid = torch.zeros((), dtype=torch.int64, device=dev)
        ex.seg = None if seg is None else torch.zeros(
            (bucket,), dtype=torch.int64, device=dev)
        ex._fill(xc, seg)

        def forward():
            return rt._forward(plan, binds, ex.x, reference=False,
                               m_valid=ex.m_valid, seg=ex.seg)
        main, side = torch.cuda.current_stream(dev), _side_stream(dev)
        side.wait_stream(main)
        with torch.no_grad(), torch.cuda.stream(side):
            y = forward()
        main.wait_stream(side)
        y.record_stream(main)
        before = kmod.launch_counts()
        ex.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(ex.graph,
                                               pool=_graph_pool(dev)):
            ex.out = forward()
        ex.launches = {c: n - before[c]
                       for c, n in kmod.launch_counts().items()}
        # the capture counted launches that only a replay makes
        kmod.add_launches({c: -n for c, n in ex.launches.items()})
        rt.CAPTURE_COUNT["n"] += 1
        rt.CAPTURE_COUNT["s"] += time.perf_counter() - t0
        return ex, y

    def replay(self, xc: torch.Tensor,
               seg: Optional[torch.Tensor]) -> torch.Tensor:
        """Copy the inputs in, replay, count the launches, and return a
        clone of the live rows (a later replay rewrites `out`)."""
        self._fill(xc, seg)
        self.graph.replay()
        kmod.add_launches(self.launches)
        return self.out[:xc.shape[0]].clone()


class BoundProgram:
    """A CIMProgram closed over pre-quantized weights on its device.

    `serve(x)` dispatches one request through the batch-bucket ladder;
    `serve_batch([x1, ...])` concatenates requests, serves the fused batch
    once and splits the results back per request.  By default the dynamic
    activation-quantization statistics are shared across the fused batch,
    so the result is bit-exact with `serve(concat(requests))`;
    `serve_batch(..., isolate=True)` instead makes each request its own
    quantization segment, so every request is bit-identical to serving it
    alone - the contract in-flight decode (runtime/scheduler.py) rests
    on.

    On the card each clean dispatch key gets its own CUDA graph, held
    here: the capture bakes in the addresses of these bound weights."""

    __slots__ = ("program", "_binds", "_executables")

    def __init__(self, program: CIMProgram, binds: Tuple[Dict, ...]):
        object.__setattr__(self, "program", program)
        object.__setattr__(self, "_binds", binds)
        object.__setattr__(self, "_executables", {})

    def __setattr__(self, name, value):
        raise AttributeError("BoundProgram is immutable")

    @property
    def plan(self) -> rt.NetworkPlan:
        """The backing program's NetworkPlan."""
        return self.program.plan

    @property
    def executables(self) -> Tuple[tuple, ...]:
        """The dispatch keys this bound program holds a CUDA graph for."""
        return tuple(self._executables)

    def serve(self, x, key=None, noise=None, *, segments=None,
              noise_ids=None, reference: bool = False,
              point: str = "") -> torch.Tensor:
        """Bucketed dispatch of one request through the bound weights
        (bit-exact with the unbucketed engine on the same inputs, clean
        and under a fixed noise key).  The result stays on the program's
        device.

        `segments` ((B,) int ids in [0, B), optional) switches activation
        quantization to per-segment statistics: samples with different
        ids never share dynamic swing state, so a fused batch is bit-exact
        with serving each segment alone.  `noise_ids` ((B,) int, optional)
        key the thermal draws by sample identity instead of batch position
        (see request_noise_ids): together they make noisy fused serving
        bit-exact with solo serving under one key.  `point` tags the
        dispatch with the serving operating-point name ("" = base); it
        joins the dispatch key.  On the card a clean dispatch (no key, no
        noise, not the reference) replays its key's CUDA graph."""
        return self.program._serve_padded(self._binds, self._executables,
                                          x, key, noise, bool(reference),
                                          segments, noise_ids, point)

    __call__ = serve

    def reference(self, x, key=None, noise=None, *, segments=None,
                  noise_ids=None, point: str = "") -> torch.Tensor:
        """The plain digital oracle of serve (bit-exact with it)."""
        return self.serve(x, key, noise, segments=segments,
                          noise_ids=noise_ids, reference=True, point=point)

    def serve_batch(self, requests: Sequence, key=None, noise=None, *,
                    isolate: bool = False) -> List[torch.Tensor]:
        """Multi-request serving: concatenate, bucket-pad, dispatch once,
        split.

        Args:
          requests: per-request activations, each batch-major with the
            plan's feature shape - (b_i, K0) dense or (b_i, H, W, C_in)
            conv.
          key: PRNG key of a noise-enabled plan (one key for the fused
            batch; per-request noise follows each request's row offset,
            or its request_noise_ids identity under `isolate`).
          noise: optional operating-point override.
          isolate: False (default) shares the dynamic activation-
            quantization statistics across the fused batch (bit-exact with
            `serve(concat(requests))`, not with per-request serves).  True
            tags each request as its own quantization segment and, under a
            key, keys its thermal draws on request_noise_ids(i, b_i),
            making its rows bit-identical to a solo `serve(x_i, key,
            segments=zeros(b_i), noise_ids=request_noise_ids(i, b_i))`.
        Returns:
          One result per request, in order, each with its own leading b_i.
        """
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
        segments = noise_ids = None
        if isolate:
            segments = torch.repeat_interleave(
                torch.arange(len(sizes)), torch.tensor(sizes))
            if key is not None:
                noise_ids = torch.cat([request_noise_ids(i, b)
                                       for i, b in enumerate(sizes)])
        y = self.serve(torch.cat(xs, dim=0), key, noise, segments=segments,
                       noise_ids=noise_ids)
        return list(torch.split(y, sizes, dim=0))

    def stats(self) -> Dict[str, int]:
        """The backing program's counters."""
        return self.program.stats()


# ---------------------------------------------------------------------------
# bound programs of per-call params (the engine-mode layer)
# ---------------------------------------------------------------------------

def _version(t: torch.Tensor) -> Optional[int]:
    """A tensor's in-place version counter (None for an inference tensor,
    which keeps none)."""
    try:
        return t._version
    except RuntimeError:
        return None


class _WeightBinds:
    """One layer's weights as last seen by `bound_for`: weak references
    to its tensors and their (data_ptr, version) stamps, its bind
    products by (engine.bind_key, device), and its BoundProgram by
    program."""

    __slots__ = ("refs", "stamp", "binds", "bound")

    def __init__(self, tensors: Tuple[torch.Tensor, ...], on_death):
        self.refs = tuple(weakref.ref(t, on_death) if i == 0
                          else weakref.ref(t) for i, t in enumerate(tensors))
        self.stamp = tuple((t.data_ptr(), _version(t)) for t in tensors)
        self.binds: Dict[tuple, Tuple[Dict, ...]] = {}
        self.bound: Dict[CIMProgram, BoundProgram] = {}

    def current(self, tensors: Tuple[torch.Tensor, ...]) -> bool:
        """Whether these are the tensors seen, unchanged since."""
        return (all(r() is t for r, t in zip(self.refs, tensors))
                and self.stamp == tuple((t.data_ptr(), _version(t))
                                        for t in tensors))


# keyed by id() of the layer's weight tensor; an entry leaves with its
# tensor (the weakref's callback), so the table holds live weights only
_BOUND: Dict[int, _WeightBinds] = {}
_BOUND_STATS = {"binds": 0, "rebinds": 0, "hits": 0}
_LAYER_KEYS = ("w", "abn_log_gamma", "abn_beta")


def bound_for(program: CIMProgram, params: Dict[str, torch.Tensor]
              ) -> BoundProgram:
    """The BoundProgram of a single-layer `program` over one layer's
    params {"w", "abn_log_gamma", "abn_beta"}, bound once and reused.

    The first call with these tensors binds them (engine.bind_network);
    later calls return the same BoundProgram, so a clean dispatch on the
    card replays its captured graph.  If any of the three tensors was
    replaced or changed in place since (its `data_ptr` or `_version`
    moved), every bind of the weights is dropped and made anew, equal to
    a fresh bind.  Programs of the layer at other batch buckets share the
    bind products (`engine.bind_key`).  An entry lives as long as its
    weight tensor; per weight it holds one BoundProgram per program it
    served (one per batch bucket and config)."""
    if len(program.plan.layers) != 1:
        raise ValueError(f"bound_for binds a single-layer program, got "
                         f"{len(program.plan.layers)} layers")
    tensors = tuple(params[k] for k in _LAYER_KEYS)
    wid = id(tensors[0])
    entry = _BOUND.get(wid)
    if entry is not None and not entry.current(tensors):
        _BOUND_STATS["rebinds"] += 1
        entry = None
    if entry is None:
        entry = _WeightBinds(tensors, lambda _r, k=wid: _BOUND.pop(k, None))
        _BOUND[wid] = entry
    bound = entry.bound.get(program)
    if bound is not None:
        _BOUND_STATS["hits"] += 1
        return bound
    lp = program.plan.layers[0]
    bkey = (rt.bind_key(lp, program.cfg), str(program.device))
    binds = entry.binds.get(bkey)
    if binds is None:
        binds = rt.bind_network(program.plan, [params], program.device)
        entry.binds[bkey] = binds
        _BOUND_STATS["binds"] += 1
    bound = BoundProgram(program, binds)
    entry.bound[program] = bound
    return bound


def bound_cache_stats() -> Dict[str, int]:
    """Counters of `bound_for`: weights (live entries), binds (bind
    products made), rebinds (entries dropped because a tensor changed)
    and hits (calls that found their BoundProgram)."""
    return dict(_BOUND_STATS, weights=len(_BOUND))


def dispatch_stats() -> Dict[str, int]:
    """graphs_captured, graph_replays and eager_calls summed over the
    programs of the plan table (the live programs of the cache)."""
    out = {k: 0 for k in ("graphs_captured", "graph_replays",
                          "eager_calls")}
    for prog in _PLAN_PROGRAMS.values():
        st = prog.stats()
        for k in out:
            out[k] += st[k]
    return out


class SharedInputProgram:
    """N projection heads over one shared input, fused as ONE program.

    A transformer block computes several projections of the *same*
    normalized hidden state - Q/K/V from the attention input, gate/up from
    the MLP input.  On the macro these are columns of one wide GEMM: the
    activations stream through the rows once and every head's columns
    convert in the same ADC pass.  This compiles a single (k -> sum(n_i))
    layer through `compile_program` and serves every head from one
    dispatch.  The per-head slices equal per-head programs bit for bit:
    activation quantization depends only on the shared input, and
    everything weight-side is per output column."""

    __slots__ = ("program", "heads", "_offsets")

    def __init__(self, program: CIMProgram,
                 heads: Sequence[Tuple[str, int]]):
        heads = tuple((str(name), int(n)) for name, n in heads)
        if len({name for name, _ in heads}) != len(heads):
            raise ValueError(f"duplicate head names in {heads}")
        n_tot = sum(n for _, n in heads)
        if len(program.plan.layers) != 1:
            raise ValueError("shared-input fusion is a single-layer "
                             f"artifact, got {len(program.plan.layers)} "
                             "layers")
        if program.plan.layers[0].spec.n != n_tot:
            raise ValueError(
                f"program n={program.plan.layers[0].spec.n} != "
                f"sum of head widths {n_tot}")
        offsets, s = [], 0
        for _, n in heads:
            offsets.append((s, s + n))
            s += n
        object.__setattr__(self, "program", program)
        object.__setattr__(self, "heads", heads)
        object.__setattr__(self, "_offsets", tuple(offsets))

    def __setattr__(self, name, value):
        raise AttributeError("SharedInputProgram is immutable")

    @classmethod
    def compile(cls, k: int, heads: Sequence[Tuple[str, int]],
                cfg: rt.EngineConfig = rt.EngineConfig(), *,
                r_in: int, r_w: int, m: int = 8,
                buckets: BatchBuckets = DEFAULT_BUCKETS,
                device: Device = None) -> "SharedInputProgram":
        """Compile (through the global program cache) the fused program of
        `heads` - ((name, n_i), ...) projections sharing a width-k input
        at one precision point.  `m` is the planner's batch-extent hint."""
        heads = tuple((str(name), int(n)) for name, n in heads)
        n_tot = sum(n for _, n in heads)
        prog = compile_program(
            (mapping.LayerSpec(m=m, k=int(k), n=n_tot,
                               r_in=r_in, r_w=r_w),),
            cfg, activations=("none",), buckets=buckets, device=device)
        return cls(prog, heads)

    @property
    def k(self) -> int:
        """The shared input width."""
        return self.program.plan.layers[0].spec.k

    def init_params(self, source) -> Dict[str, Dict]:
        """Distribution-aware init, split per head: {name: {"w",
        "abn_log_gamma", "abn_beta"}} with w (k, n_i), from a
        `torch.Generator` or a `core/prng` key (CIMProgram.init_params)."""
        (lay,) = list(self.program.init_params(source))
        return {name: {"w": lay["w"][:, s:e],
                       "abn_log_gamma": lay["abn_log_gamma"][s:e],
                       "abn_beta": lay["abn_beta"][s:e]}
                for (name, _), (s, e) in zip(self.heads, self._offsets)}

    def bind(self, params: Dict[str, Dict]) -> "SharedInputBind":
        """Concatenate the per-head params along the output axis and bind
        once (weight quantization is per output column, so the fused bind
        equals the per-head binds column for column)."""
        missing = [name for name, _ in self.heads if name not in params]
        if missing:
            raise ValueError(f"missing head params {missing}")
        for name, n in self.heads:
            w = params[name]["w"]
            if tuple(w.shape) != (self.k, n):
                raise ValueError(
                    f"head {name!r} weight shape {tuple(w.shape)} != "
                    f"({self.k}, {n})")
        cat = {fld: torch.cat([torch.as_tensor(params[name][fld]).to("cpu")
                               for name, _ in self.heads],
                              dim=-1 if fld == "w" else 0)
               for fld in ("w", "abn_log_gamma", "abn_beta")}
        return SharedInputBind(self, self.program.bind([cat]))

    def stats(self) -> Dict[str, int]:
        """The fused program's counters."""
        return self.program.stats()


class SharedInputBind:
    """A SharedInputProgram closed over bound (pre-quantized) weights:
    `serve(x)` runs the one fused dispatch and returns {head: slice}."""

    __slots__ = ("shared", "bound")

    def __init__(self, shared: SharedInputProgram, bound: BoundProgram):
        object.__setattr__(self, "shared", shared)
        object.__setattr__(self, "bound", bound)

    def __setattr__(self, name, value):
        raise AttributeError("SharedInputBind is immutable")

    @property
    def program(self) -> CIMProgram:
        """The backing fused CIMProgram."""
        return self.shared.program

    def serve(self, x, key=None, noise=None, *, segments=None,
              noise_ids=None, reference: bool = False,
              point: str = "") -> Dict[str, torch.Tensor]:
        """One bucketed dispatch of the shared input; the result splits
        along the output axis into {head name: (..., n_i)} views.
        `segments` and `point` pass through unchanged."""
        y = self.bound.serve(x, key, noise, segments=segments,
                             noise_ids=noise_ids, reference=reference,
                             point=point)
        return {name: y[..., s:e]
                for (name, _), (s, e) in zip(self.shared.heads,
                                             self.shared._offsets)}

    __call__ = serve

    def stats(self) -> Dict[str, int]:
        """The backing program's counters."""
        return self.shared.program.stats()


# ---------------------------------------------------------------------------
# the global program cache
# ---------------------------------------------------------------------------

_PROGRAM_CACHE: "collections.OrderedDict[tuple, CIMProgram]" = \
    collections.OrderedDict()
_PLAN_PROGRAMS: "collections.OrderedDict[tuple, CIMProgram]" = \
    collections.OrderedDict()
_CACHE_STATS = {"programs_built": 0, "lookups": 0, "hits": 0,
                "evictions": 0}


def _env_capacity() -> int:
    try:
        cap = int(os.environ.get("REPRO_PROGRAM_CACHE_CAP", "512"))
    except ValueError:
        cap = 512
    return max(cap, 1)


# LRU bound on BOTH module-level tables (the precision ladder times model
# churn would otherwise grow them without limit); a mutable holder so
# tests can shrink it without patching the module global
_CACHE_CAPACITY = [_env_capacity()]


def set_program_cache_capacity(capacity: int) -> int:
    """Set the program-cache LRU capacity (entries per cache table) and
    return the previous value.  Shrinking evicts least-recently-used
    entries at once; an evicted program keeps working (its bound copies
    keep their CUDA graphs) wherever it is already held - eviction only
    means an equal future compile_program call re-plans.  The startup
    default is $REPRO_PROGRAM_CACHE_CAP (512)."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    old = _CACHE_CAPACITY[0]
    _CACHE_CAPACITY[0] = int(capacity)
    for cache in (_PROGRAM_CACHE, _PLAN_PROGRAMS):
        _trim_cache(cache)
    return old


def _trim_cache(cache) -> None:
    while len(cache) > _CACHE_CAPACITY[0]:
        cache.popitem(last=False)
        _CACHE_STATS["evictions"] += 1


def _cache_get(cache, key):
    prog = cache.get(key)
    if prog is not None:
        cache.move_to_end(key)
    return prog


def _cache_put(cache, key, prog) -> None:
    cache[key] = prog
    cache.move_to_end(key)
    _trim_cache(cache)


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
                    device: Device = None, verify: str = "off",
                    tune: str = "off",
                    tune_cache: Optional[str] = None) -> CIMProgram:
    """Compile (or fetch from the global cache) the program for a network.

    The cache key is (specs, cfg, activations, pools, buckets, device)
    plus, when tuning, (tune mode, resolved cache path), as in the JAX
    package.

    Args:
      specs: the network's (conv-tagged) LayerSpecs, in order.
      cfg: shared EngineConfig (macro, gamma settings, block sizes).
      activations/pools: per-layer epilogues (plan_network defaults).
      buckets: the serve-path batch-bucket ladder.
      device: where the program runs; None means "cuda", and raises when
        there is no card (pass device="cpu" for the host path).
      verify: cimcheck static verification of a freshly made program
        (`repro_torch.analysis.verify_program` over its bound serving
        graphs) - "strict" raises `repro_torch.analysis.CimcheckError` on
        any ERROR finding, "warn" prints the findings to stderr, "off"
        (default) skips.  A cache hit skips it (the program was checked
        then, or deliberately not); the cache key does not hold it.  It
        binds, captures and plans nothing (see `repro_torch.analysis`).
      tune: schedule autotuning - "off" (default) runs each dispatch's
        own cim_mbiw tile; "analytic" picks each layer's tile with the
        repro_torch.tuner roofline model of the card; "measure"
        additionally times the analytic top-k with CUDA events (a CUDA
        program only: on the CPU it raises ValueError, since the plain
        version ignores tiles).  Tuning is numerics-neutral: outputs are
        bit-identical to tune="off", and a layer whose search keeps the
        heuristic produces the *same* plan (hash-equal), sharing its
        program.
      tune_cache: autotune cache file; None uses
        repro_torch.tuner.default_cache_path(), "" disables persistence
        for this compile.  Corrupt/stale caches degrade to heuristic
        schedules with a TuneCacheWarning - never an error.
    Returns:
      The cached (or freshly planned) CIMProgram.  An equal plan on the
      same device shares one program (through the plan table).
    """
    if tune not in ("off", "analytic", "measure"):
        raise ValueError(
            f'tune must be "off", "analytic" or "measure", got {tune!r}')
    if verify not in ("off", "warn", "strict"):
        raise ValueError(f"unknown cimcheck mode {verify!r}; expected "
                         "'strict', 'warn' or 'off'")
    dev = resolve_device(device)
    specs = tuple(specs)
    acts, pls = _canonical_epilogues(len(specs), activations, pools)
    key = (specs, cfg, acts, pls, buckets, str(dev))
    if tune != "off":
        from repro_torch import tuner
        resolved = (tuner.default_cache_path() if tune_cache is None
                    else tune_cache)
        key = key + (tune, resolved)
    _CACHE_STATS["lookups"] += 1
    prog = _cache_get(_PROGRAM_CACHE, key)
    if prog is not None:
        _CACHE_STATS["hits"] += 1
        return prog
    if tune != "off":
        plan, _ = tuner.tune_network(specs, cfg, acts, pls, mode=tune,
                                     cache_path=resolved, device=dev)
    else:
        plan = rt.plan_network(specs, cfg, acts, pls)
    prog = program_for_plan(plan, buckets, dev)
    _cache_put(_PROGRAM_CACHE, key, prog)
    if verify != "off":
        # inline verification lints the bound serving graphs; the sweep
        # of every variant is python -m repro_torch.analysis's job
        from repro_torch.analysis import verify_program
        verify_program(prog, mode=verify, graphs="serving")
    return prog


def program_for_plan(plan: rt.NetworkPlan,
                     buckets: BatchBuckets = DEFAULT_BUCKETS,
                     device: Device = None) -> CIMProgram:
    """The cached program behind an already-built NetworkPlan on `device`
    (None means CUDA, as in compile_program); creates and caches one on
    first sight of the (plan, buckets, device)."""
    dev = resolve_device(device)
    key = (plan, buckets, str(dev))
    prog = _cache_get(_PLAN_PROGRAMS, key)
    if prog is None:
        prog = CIMProgram(plan, buckets, dev)
        _cache_put(_PLAN_PROGRAMS, key, prog)
        _CACHE_STATS["programs_built"] += 1
    return prog


def program_cache_stats() -> Dict[str, int]:
    """Global program-cache counters: programs (live programs in the plan
    table), programs_built, lookups, hits (compile_program key hits),
    evictions (LRU drops across both tables) and capacity (the LRU bound -
    set_program_cache_capacity / $REPRO_PROGRAM_CACHE_CAP)."""
    return dict(_CACHE_STATS, programs=len(_PLAN_PROGRAMS),
                capacity=_CACHE_CAPACITY[0])


def clear_program_cache() -> None:
    """Drop every cached program from both tables and reset the cache
    counters (programs already held keep working)."""
    _PROGRAM_CACHE.clear()
    _PLAN_PROGRAMS.clear()
    for k in list(_CACHE_STATS):
        _CACHE_STATS[k] = 0
