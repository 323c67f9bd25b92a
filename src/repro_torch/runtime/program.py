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
* **Per-request isolation** - `serve(..., segments=)` quantizes each
  segment's rows with its own activation swing, and
  `serve_batch(..., isolate=True)` makes each request its own segment, so
  a fused request is bit-identical to serving it alone.
* **Shared-input fusion** - `SharedInputProgram` serves several
  projections of one input (Q/K/V, gate/up) as one wide program.

A program runs on one device, CUDA by default: with no card,
`compile_program` raises rather than carry on on the CPU, and the CPU
path (the kernels' plain versions) must be asked for with device="cpu".
Noise (`noise_ids`, PRNG keys, noise overrides) arrives with the port's
noise slice and raises `NotImplementedError` until then; the program
cache has no LRU capacity yet.
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
    point).  Eager PyTorch compiles nothing per key; `stats()` counts the
    distinct keys, the set a later CUDA-graph capture would need.  Keep
    in sync with EXEC_KEY_FIELDS."""
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


def no_noise(key=None, noise=None, noise_ids=None) -> None:
    """Raise for the noise operands: noise is not ported yet."""
    for name, value in (("key", key), ("noise", noise),
                        ("noise_ids", noise_ids)):
        if value is not None:
            raise NotImplementedError(
                f"{name}: noise (PRNG keys, noise overrides, identity-keyed "
                "noise ids) arrives with the port's noise slice and is not "
                "ported yet")


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
    def buckets(self) -> BatchBuckets:
        """The batch-bucket ladder `serve` pads requests onto."""
        return self._buckets

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
        plain digital oracle of the same schedule; `segments` are optional
        per-sample segment ids (segment-wise activation quantization - see
        BoundProgram.serve)."""
        no_noise(key, noise, noise_ids)
        binds = rt.bind_network(self._plan, list(params), self._device)
        xc, lead = self._canon(x)
        seg = self._canon_rows(segments, xc.shape[0], "segments")
        self._note_dispatch(
            executable_key("exact", xc.shape[0], noise=False, keyed=False,
                           devices=1, bound=False, reference=bool(reference),
                           segmented=seg is not None, identity=False),
            bucketed=False)
        y = rt._forward(self._plan, binds, xc, reference=bool(reference),
                        seg=seg)
        return y.reshape(lead + tuple(y.shape[1:]))

    def serve(self, params: rt.Params, x, key=None, noise=None, *,
              segments=None, noise_ids=None, reference: bool = False,
              point: str = "") -> torch.Tensor:
        """Batch-bucketed dispatch with per-call params (weights bound on
        every call - use bind(params).serve(...) to hoist it).  `point`
        tags the dispatch with a serving operating-point name (it joins
        the dispatch key; "" is the base point)."""
        no_noise(key, noise, noise_ids)
        binds = rt.bind_network(self._plan, list(params), self._device)
        return self._serve_padded(binds, False, x, bool(reference), segments,
                                  point)

    def _serve_padded(self, binds, bound: bool, x, reference: bool,
                      segments=None, point: str = "") -> torch.Tensor:
        xc, lead = self._canon(x)
        m = xc.shape[0]
        if m < 1:
            raise ValueError("cannot serve an empty batch")
        seg = self._canon_rows(segments, m, "segments")
        bucket = self._buckets.bucket_for(m)
        if bucket > m:
            pad = xc[:1].expand((bucket - m,) + tuple(xc.shape[1:]))
            xc = torch.cat([xc, pad], dim=0)
            # pad ids mirror the pad rows (copies of row 0): the pad rows
            # stay duplicates inside row 0's segment, so no segment's
            # min/max can move and live rows stay bit-exact
            if seg is not None:
                seg = torch.cat([seg, seg[:1].expand(bucket - m)])
        self._note_dispatch(
            executable_key("bucket", bucket, noise=False, keyed=False,
                           devices=1, bound=bound, reference=reference,
                           segmented=seg is not None, identity=False,
                           point=str(point)), bucketed=True)
        y = rt._forward(self._plan, binds, xc, reference=reference,
                        m_valid=m, seg=seg)
        return y[:m].reshape(lead + tuple(y.shape[1:]))

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Counters of this program: plans_built (always 1),
        executables_compiled (distinct dispatch keys, `executable_key`),
        bucket_hits/bucket_misses (serve-path ladder lookups),
        run_calls/serve_calls."""
        return dict(self._stats)


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
    on."""

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

    def serve(self, x, key=None, noise=None, *, segments=None,
              noise_ids=None, reference: bool = False,
              point: str = "") -> torch.Tensor:
        """Bucketed dispatch of one request through the bound weights
        (bit-exact with the unbucketed engine on the same inputs).  The
        result stays on the program's device.

        `segments` ((B,) int ids in [0, B), optional) switches activation
        quantization to per-segment statistics: samples with different
        ids never share dynamic swing state, so a fused batch is bit-exact
        with serving each segment alone.  `point` tags the dispatch with
        the serving operating-point name ("" = base); it joins the
        dispatch key."""
        no_noise(key, noise, noise_ids)
        return self.program._serve_padded(self._binds, True, x,
                                          bool(reference), segments, point)

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
          isolate: False (default) shares the dynamic activation-
            quantization statistics across the fused batch (bit-exact with
            `serve(concat(requests))`, not with per-request serves).  True
            tags each request as its own quantization segment, making its
            rows bit-identical to a solo `serve(x_i, segments=zeros(b_i))`.
        Returns:
          One result per request, in order, each with its own leading b_i.
        """
        no_noise(key, noise)
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
        segments = None
        if isolate:
            segments = torch.repeat_interleave(
                torch.arange(len(sizes)), torch.tensor(sizes))
        y = self.serve(torch.cat(xs, dim=0), segments=segments)
        return list(torch.split(y, sizes, dim=0))

    def stats(self) -> Dict[str, int]:
        """The backing program's counters."""
        return self.program.stats()


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

    def init_params(self, generator: torch.Generator) -> Dict[str, Dict]:
        """Distribution-aware init, split per head: {name: {"w",
        "abn_log_gamma", "abn_beta"}} with w (k, n_i), on the host."""
        (lay,) = list(self.program.init_params(generator))
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
