"""Continuous in-flight batching over compiled CIM programs.

Counterpart of `repro/runtime/scheduler.py`.  `InflightScheduler` admits
and retires requests *between decode steps* of a `CIMDecodeLM`, a greedy
decode-only transformer LM whose projections all serve through compiled
CIM programs: per block a fused Q/K/V `SharedInputBind`, an O
`BoundProgram`, a fused gate/up `SharedInputBind` and a down
`BoundProgram`, with digital RMS norms, rotary embedding and ring-buffer
KV attention (the `ring_decode` kernel) between them.  Three invariants
carry it:

* **Bounded dispatch shapes** - a fused step dispatches at the
  `BatchBuckets` rung covering the highest live slot of its group.
* **Per-request numerical isolation** - every row is its own activation-
  quantization segment in every program dispatch, and every digital op of
  a step computes each row as a one-row problem (see `_per_row`), so a
  request's token stream equals decoding it alone (`decode_sequential`)
  bit for bit, whatever its batchmates, slot or arrival.
* **Gather-free slot lifecycle** - admission prefills the request into
  its slot's state rows; retirement frees the slot id and moves no data.

Mixed operating points: each `Request` names a point, a model carries a
block stack per point over the same weights (`variants`), and a step
advances one point's group (round-robin over live points); other points'
live slots ride along as padding and keep their state.

Unlike the JAX package, which updates state functionally and writes the
group's rows back, the port updates the decode state IN PLACE: a step
writes one ring slot per row and block and bumps the positions, and rows
outside the stepped group get their old slot back (at full width a row's
rings are hundreds of MB, so no slab is ever copied).  Noise (PRNG keys,
identity-keyed noise ids) is not ported yet and raises.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mapping
from repro_torch.kernels.flash_attn.ops import ring_decode_attention
from repro_torch.runtime import engine as rt
from repro_torch.runtime.program import (DEFAULT_BUCKETS, NOISE_ID_STRIDE,
                                         BatchBuckets, BoundProgram, Device,
                                         SharedInputBind, SharedInputProgram,
                                         compile_program, no_noise)

# per block: {"qkv": {"q", "k", "v"}, "o": [layer], "gate_up": {"gate",
# "up"}, "down": [layer]}, each layer {"w", "abn_log_gamma", "abn_beta"}
Masters = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class Request:
    """One decode request: a prompt plus a generation budget.

    `point` tags the serving operating point (a precision-ladder rung such
    as "quality"; "" is the model's base point): the request decodes
    through the model's blocks for that point and is only ever fused with
    same-point batchmates."""
    uid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    point: str = ""

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError("request needs a non-empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("request needs max_new_tokens >= 1")
        if not isinstance(self.point, str):
            raise ValueError("operating point must be a str tag, got "
                             f"{self.point!r}")


@dataclasses.dataclass
class RequestRecord:
    """Bookkeeping of one request's life in the scheduler (all step
    indices are scheduler-clock values; -1 means 'not yet')."""
    request: Request
    arrival_step: int
    slot: int = -1
    calls: int = 0                    # model calls made (prefill + decode)
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted_step: int = -1
    first_token_step: int = -1
    finished_step: int = -1

    @property
    def done(self) -> bool:
        """Whether the generation budget has been spent."""
        return len(self.tokens) >= self.request.max_new_tokens


class SlotMap:
    """Lowest-free-slot allocator for the in-flight batch.

    The dispatch extent is `extent()` - highest live slot + 1 - so keeping
    allocations low keeps the fused batch at the smallest bucket rung.
    Freeing a slot is O(1) bookkeeping and moves no data."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._free = list(range(capacity))    # min-heap of free slot ids
        self._live: set = set()

    def alloc(self) -> int:
        """Claim and return the lowest free slot (raises when full)."""
        if not self._free:
            raise RuntimeError("no free slot")
        s = heapq.heappop(self._free)
        self._live.add(s)
        return s

    def free(self, slot: int) -> None:
        """Release a live slot back to the pool (no data movement)."""
        self._live.remove(slot)
        heapq.heappush(self._free, slot)

    def live(self) -> Tuple[int, ...]:
        """The live slot ids, ascending."""
        return tuple(sorted(self._live))

    def extent(self) -> int:
        """Highest live slot + 1 (the fused dispatch extent), 0 if idle."""
        return max(self._live) + 1 if self._live else 0

    @property
    def n_free(self) -> int:
        """How many slots are currently free."""
        return len(self._free)


def _per_row(fn: Callable[..., torch.Tensor],
             *xs: torch.Tensor) -> torch.Tensor:
    """fn applied to each row of `xs` as a one-row problem, stacked.

    A reduction, a product or a vectorized transcendental may take another
    path (another summation order, a SIMD body against a scalar tail) at
    another number of rows; computing each row alone makes its bits
    independent of its batchmates on the CPU and on the card."""
    return torch.cat([fn(*(x[r:r + 1] for x in xs))
                      for r in range(xs[0].shape[0])])


def _rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-parametric RMS norm, strictly per row."""
    return _per_row(
        lambda t: t * torch.rsqrt(torch.mean(t * t, dim=-1, keepdim=True)
                                  + eps), x)


def _rope_row(x: torch.Tensor, pos: torch.Tensor,
              theta: float) -> torch.Tensor:
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.to(torch.float32)[:, None, None] * freq[None, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return rot if 2 * half == hd else torch.cat([rot, x[..., 2 * half:]],
                                                dim=-1)


def _rope(x: torch.Tensor, pos: torch.Tensor,
          theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of (R, H, hd) vectors at per-row positions (R,)."""
    return _per_row(lambda xr, pr: _rope_row(xr, pr, theta), x, pos)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), strictly per row."""
    return _per_row(lambda t: t * torch.sigmoid(t), x)


def _tied_logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """h @ embed.T as one (1, d) x (d, vocab) product per row: a batched
    product may pick another algorithm (split-K, another kernel) at
    another number of rows."""
    return _per_row(lambda t: t @ embed.T, h)


@dataclasses.dataclass(frozen=True)
class DecodeBlock:
    """One transformer block's bound CIM artifacts: the fused Q/K/V
    shared-input bind, the O projection, the fused gate/up bind and the
    down projection."""
    qkv: SharedInputBind
    o: BoundProgram
    gate_up: SharedInputBind
    down: BoundProgram


def _norm_point(rs) -> Tuple[Tuple[int, int], ...]:
    """One (r_in, r_w) pair, or four in (qkv, o, gate_up, down) order."""
    rs = tuple(tuple(r) if isinstance(r, (tuple, list)) else r for r in rs)
    if len(rs) == 2 and all(isinstance(r, int) for r in rs):
        rs = (rs,) * 4
    if len(rs) != 4:
        raise ValueError(
            "a point is one (r_in, r_w) pair or four pairs in "
            f"(qkv, o, gate_up, down) order, got {rs!r}")
    return tuple((int(a), int(b)) for a, b in rs)


def _point_programs(d: int, d_ff: int, rs, cfg: rt.EngineConfig,
                    buckets: BatchBuckets, device: Device) -> tuple:
    (qi, qw), (oi, ow), (gi, gw), (zi, zw) = _norm_point(rs)
    return (
        SharedInputProgram.compile(
            d, (("q", d), ("k", d), ("v", d)), cfg, r_in=qi, r_w=qw,
            buckets=buckets, device=device),
        compile_program(
            (mapping.LayerSpec(m=8, k=d, n=d, r_in=oi, r_w=ow),), cfg,
            activations=("none",), buckets=buckets, device=device),
        SharedInputProgram.compile(
            d, (("gate", d_ff), ("up", d_ff)), cfg, r_in=gi, r_w=gw,
            buckets=buckets, device=device),
        compile_program(
            (mapping.LayerSpec(m=8, k=d_ff, n=d, r_in=zi, r_w=zw),), cfg,
            activations=("none",), buckets=buckets, device=device))


class CIMDecodeLM:
    """A greedy decode-only transformer LM over bound CIM programs.

    Per block and per decode step (one new token per row):

        h1 = rms_norm(x);  q,k,v = qkv.serve(h1)     # one fused dispatch
        attn = ring-KV attention(rope(q), rope(k), v)  # ring_decode kernel
        x   += o.serve(attn)
        h2 = rms_norm(x);  g,u = gate_up.serve(h2)   # one fused dispatch
        x   += down.serve(silu(g) * u)

    with tied logits `rms_norm(x) @ embed.T` and greedy argmax.  Per-slot
    state is a dict of KV rings (rows, depth, window, H, hd) plus each
    row's absolute position.  `variants` maps operating-point tags to
    block stacks serving the same weights at other precision points;
    point "" is always the base `blocks`.  The model runs on the device of
    `embed`, which every program must share."""

    def __init__(self, embed: torch.Tensor, blocks: Sequence[DecodeBlock],
                 *, n_heads: int, window: int = 16,
                 rope_theta: float = 10000.0,
                 variants: Optional[Dict[str, Sequence[DecodeBlock]]] = None):
        embed = torch.as_tensor(embed).to(torch.float32)
        if embed.dim() != 2:
            raise ValueError(f"embed must be (vocab, d), got "
                             f"{tuple(embed.shape)}")
        d = embed.shape[1]
        if n_heads < 1 or d % n_heads:
            raise ValueError(f"d={d} not divisible into {n_heads} heads")
        if window < 1:
            raise ValueError(f"KV window must be >= 1, got {window}")
        blocks = tuple(blocks)
        if not blocks:
            raise ValueError("need at least one DecodeBlock")
        vmap: Dict[str, Tuple[DecodeBlock, ...]] = {"": blocks}
        for name, vblocks in (variants or {}).items():
            name = str(name)
            if not name:
                raise ValueError('"" names the base point; variant tags '
                                 "must be non-empty")
            vblocks = tuple(vblocks)
            if len(vblocks) != len(blocks):
                raise ValueError(
                    f"variant {name!r} has {len(vblocks)} blocks, base "
                    f"has {len(blocks)}")
            vmap[name] = vblocks
        for name, blks in vmap.items():
            for i, blk in enumerate(blks):
                if blk.qkv.shared.k != d or blk.o.plan.layers[-1].spec.n != d:
                    raise ValueError(
                        f"block {i} of point {name!r} is not d->d at d={d}")
                devs = {p.device for p in (blk.qkv.program, blk.o.program,
                                           blk.gate_up.program,
                                           blk.down.program)}
                if devs != {embed.device}:
                    raise ValueError(
                        f"block {i} of point {name!r} runs on {devs}, the "
                        f"embedding on {embed.device}")
        self.embed = embed
        self.blocks = blocks
        self.variants = vmap
        self.n_heads = n_heads
        self.window = window
        self.rope_theta = rope_theta

    @property
    def d(self) -> int:
        """Model width."""
        return self.embed.shape[1]

    @property
    def vocab(self) -> int:
        """Vocabulary size (rows of the tied embedding)."""
        return self.embed.shape[0]

    @property
    def depth(self) -> int:
        """Transformer block count."""
        return len(self.blocks)

    @property
    def device(self) -> torch.device:
        """The device the model's state and programs live on."""
        return self.embed.device

    @property
    def bound(self) -> BoundProgram:
        """A representative bound program (all programs share one
        EngineConfig and bucket ladder)."""
        return self.blocks[0].o

    @property
    def points(self) -> Tuple[str, ...]:
        """The operating-point tags this model serves (sorted; always
        includes "", the base point)."""
        return tuple(sorted(self.variants))

    def blocks_for(self, point: str) -> Tuple[DecodeBlock, ...]:
        """The block stack serving one operating point (ValueError on an
        unknown tag)."""
        try:
            return self.variants[point]
        except KeyError:
            raise ValueError(
                f"unknown operating point {point!r}; this model serves "
                f"{sorted(self.variants)}") from None

    def bound_for(self, point: str) -> BoundProgram:
        """The representative bound program of one operating point."""
        return self.blocks_for(point)[0].o

    @classmethod
    def from_masters(cls, embed: torch.Tensor, masters: Sequence[Masters],
                     *, n_heads: int, window: int = 16,
                     rope_theta: float = 10000.0, r_in: int = 4,
                     r_w: int = 2, cfg: Optional[rt.EngineConfig] = None,
                     buckets: BatchBuckets = DEFAULT_BUCKETS,
                     points: Optional[Dict[str, Sequence]] = None,
                     device: Device = None) -> "CIMDecodeLM":
        """Compile the four programs of each operating point and bind the
        same fp32 masters at every point.

        `masters` holds one dict per block: {"qkv": {"q", "k", "v"},
        "o": [layer], "gate_up": {"gate", "up"}, "down": [layer]}, each
        layer {"w", "abn_log_gamma", "abn_beta"} (host tensors; the bind
        quantizes on the host and moves the products to the device).  The
        base point is (r_in, r_w); `points` maps tags to one (r_in, r_w)
        pair or four in (qkv, o, gate_up, down) order."""
        cfg = cfg or rt.EngineConfig()
        d = embed.shape[1]
        d_ff = masters[0]["gate_up"]["gate"]["w"].shape[1]
        base = _point_programs(d, d_ff, (r_in, r_w), cfg, buckets, device)
        progs = {str(n): _point_programs(d, d_ff, rs, cfg, buckets, device)
                 for n, rs in (points or {}).items()}

        def _block(p, m):
            q, o, g, z = p
            return DecodeBlock(qkv=q.bind(m["qkv"]), o=o.bind(m["o"]),
                               gate_up=g.bind(m["gate_up"]),
                               down=z.bind(m["down"]))

        blocks = [_block(base, m) for m in masters]
        variants = {n: tuple(_block(p, m) for m in masters)
                    for n, p in progs.items()}
        dev = base[1].device
        return cls(torch.as_tensor(embed).to(dev, torch.float32), blocks,
                   n_heads=n_heads, window=window, rope_theta=rope_theta,
                   variants=variants or None)

    @classmethod
    def toy(cls, generator: torch.Generator, *, d: int = 96, depth: int = 2,
            vocab: int = 61, r_in: int = 4, r_w: int = 2,
            cfg: Optional[rt.EngineConfig] = None,
            buckets: BatchBuckets = DEFAULT_BUCKETS, n_heads: int = 4,
            window: int = 16, d_ff: int = 0,
            points: Optional[Dict[str, Sequence]] = None,
            rope_theta: float = 10000.0,
            device: Device = None) -> "CIMDecodeLM":
        """A self-contained transformer LM (compile + init + bind in one
        call) with weights drawn on the host from `generator`: per block
        the Q/K/V, O, gate/up and down masters (the base point's
        distribution-aware init), then a 0.25-scaled normal embedding.
        Every point binds the same masters."""
        cfg = cfg or rt.EngineConfig()
        if d % n_heads:
            n_heads = 1
        d_ff = d_ff or 2 * d
        qkv_p, o_p, gu_p, dn_p = _point_programs(d, d_ff, (r_in, r_w), cfg,
                                                 buckets, device)
        masters = [{"qkv": qkv_p.init_params(generator),
                    "o": o_p.init_params(generator),
                    "gate_up": gu_p.init_params(generator),
                    "down": dn_p.init_params(generator)}
                   for _ in range(depth)]
        embed = 0.25 * torch.randn((vocab, d), generator=generator,
                                   dtype=torch.float32)
        return cls.from_masters(embed, masters, n_heads=n_heads,
                                window=window, rope_theta=rope_theta,
                                r_in=r_in, r_w=r_w, cfg=cfg, buckets=buckets,
                                points=points, device=device)

    @staticmethod
    def noise_id(uid: int, call: int) -> int:
        """Deterministic noise identity of one request's `call`-th model
        call (prefill steps count)."""
        return (uid * NOISE_ID_STRIDE + call) % (1 << 31)

    @staticmethod
    def _proj_ids(noise_ids: Optional[torch.Tensor],
                  proj: int) -> Optional[torch.Tensor]:
        """Per-projection noise identities (int32 arithmetic, wrapping like
        the JAX package's): the row identity mixed with the projection
        index, a pure function of the row's own id."""
        if noise_ids is None:
            return None
        ids = torch.as_tensor(noise_ids).to(torch.int32)
        return (ids * 29 + proj) & 0x7FFFFFFF

    def init_state(self, n: int) -> Dict[str, torch.Tensor]:
        """Fresh per-slot decode state for `n` slots on the model's device:
        KV rings "k"/"v" of shape (n, depth, window, H, hd) plus each
        slot's absolute position "pos" (n,)."""
        hd = self.d // self.n_heads
        shape = (n, self.depth, self.window, self.n_heads, hd)
        dev = self.device
        return {"k": torch.zeros(shape, dtype=torch.float32, device=dev),
                "v": torch.zeros(shape, dtype=torch.float32, device=dev),
                "pos": torch.zeros((n,), dtype=torch.int64, device=dev)}

    def step_rows(self, state: Dict[str, torch.Tensor], tokens,
                  noise_ids=None, key=None, *, point: str = "",
                  commit: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One fused decode step over the first R = len(tokens) state rows.

        Updates `state` IN PLACE and returns it with the (R,) greedy next
        tokens (on the model's device).  Every row is its own quantization
        segment in every program dispatch, attention reads only the row's
        own ring, and every digital op computes each row alone, so the
        rows never interact.  `commit` ((R,) bool, optional) names the rows
        whose state advances: the others (padding of a mixed-point step)
        get their ring slot back and keep their position, so they end the
        step exactly as they began it.  `point` selects the operating
        point's block stack."""
        no_noise(key, noise_ids=noise_ids)
        blocks = self.blocks_for(point)
        dev = self.device
        tokens = torch.as_tensor(tokens).to(dev, torch.int64).reshape(-1)
        rows = tokens.shape[0]
        hd = self.d // self.n_heads
        kst, vst = state["k"], state["v"]
        pos = state["pos"][:rows]
        ar = torch.arange(rows, device=dev)
        seg = ar
        x = self.embed[tokens]                                 # (R, d)
        idx = pos % self.window                                # ring write
        if commit is not None:
            commit = torch.as_tensor(commit).to(dev, torch.bool).reshape(-1)
            saved_k = kst[ar, :, idx].clone()          # (R, depth, H, hd)
            saved_v = vst[ar, :, idx].clone()
        # absolute position of each ring slot j given the row's pos:
        # src = pos - ((pos - j) % L); slots never written sit out (< 0)
        j = torch.arange(self.window, device=dev)
        src = pos[:, None] - ((pos[:, None] - j[None, :]) % self.window)
        bias = torch.where(src < 0, -1e9, 0.0).to(torch.float32)  # (R, L)
        for b, blk in enumerate(blocks):
            h1 = _rms_norm(x)
            qkv = blk.qkv.serve(h1, segments=seg, point=point)
            q = _rope(qkv["q"].reshape(rows, self.n_heads, hd), pos,
                      self.rope_theta)
            kk = _rope(qkv["k"].reshape(rows, self.n_heads, hd), pos,
                       self.rope_theta)
            vv = qkv["v"].reshape(rows, self.n_heads, hd)
            kst[ar, b, idx] = kk
            vst[ar, b, idx] = vv
            # one block's slab of the state, passed as a strided view
            attn = ring_decode_attention(q, kst[:rows, b], vst[:rows, b],
                                         bias)
            x = x + blk.o.serve(attn.reshape(rows, self.d), segments=seg,
                                point=point)
            h2 = _rms_norm(x)
            gu = blk.gate_up.serve(h2, segments=seg, point=point)
            x = x + blk.down.serve(_silu(gu["gate"]) * gu["up"],
                                   segments=seg, point=point)
        nxt = torch.argmax(_tied_logits(_rms_norm(x), self.embed), dim=-1)
        if commit is None:
            pos += 1
        else:
            keep = commit[:, None, None, None]
            kst[ar, :, idx] = torch.where(keep, kst[ar, :, idx], saved_k)
            vst[ar, :, idx] = torch.where(keep, vst[ar, :, idx], saved_v)
            pos += commit.to(torch.int64)
        return state, nxt

    def prefill(self, request: Request, key=None,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[Dict[str, torch.Tensor], int, int]:
        """Consume a request's prompt solo (batch-1 steps) and return
        (its one-row state, first generated token, model calls made).

        With `state` (a one-row view of a larger state, as the scheduler
        passes a slot's rows) the prompt is prefilled there, in place,
        after zeroing it; otherwise into a fresh `init_state(1)`.  Either
        way the row runs identically, so admission never enters the
        equality argument."""
        no_noise(key)
        if state is None:
            state = self.init_state(1)
        else:
            for a in state.values():
                a.zero_()
        tok = None
        for t in request.prompt:
            _, nxt = self.step_rows(state, [t % self.vocab],
                                    point=request.point)
            tok = int(nxt[0])
        return state, tok, len(request.prompt)


def decode_sequential(model: CIMDecodeLM, request: Request,
                      key=None) -> List[int]:
    """The isolation baseline: decode one request entirely alone (batch-1
    prefill + batch-1 decode steps).  InflightScheduler must reproduce
    this token stream bit for bit for every request of every schedule."""
    no_noise(key)
    st, tok, _ = model.prefill(request)
    tokens = [tok]
    while len(tokens) < request.max_new_tokens:
        _, nxt = model.step_rows(st, [tokens[-1]], point=request.point)
        tokens.append(int(nxt[0]))
    return tokens


class InflightScheduler:
    """The continuous-batching decode loop over a CIMDecodeLM.

    Lifecycle per `step()`: admit pending requests into free slots (solo
    prefill into the slot's state rows), run ONE fused decode step of one
    operating point's group (round-robin over live points) at the bucket
    rung covering the group's highest slot, append each group slot's
    token, retire exhausted requests (slot free, no data movement).  Dead
    slots and other points' live slots below the extent ride along as
    padding: they are their own quantization segments and are not
    committed, so they neither perturb the group nor change."""

    def __init__(self, model: CIMDecodeLM, capacity: int = 8, key=None):
        no_noise(key)
        self.model = model
        self.key = key
        self.slots = SlotMap(capacity)
        self.state = model.init_state(capacity)   # leading axis = slot
        self.cur_tok = np.zeros((capacity,), np.int64)
        self.clock = 0
        self.pending: Deque[RequestRecord] = collections.deque()
        self.by_slot: Dict[int, RequestRecord] = {}
        self.finished: Dict[int, RequestRecord] = {}
        self.extents_seen: set = set()
        self.decode_steps = 0
        self.decode_rows = 0
        self.wall_s = 0.0
        self.points_served: Dict[str, int] = {}
        self._point_rr = 0

    def submit(self, request: Request) -> RequestRecord:
        """Queue a request (arrival stamped at the current clock); it is
        admitted at the next step() with a free slot.  Raises ValueError
        when the request's operating point is not one the model serves."""
        self.model.blocks_for(request.point)
        rec = RequestRecord(request=request, arrival_step=self.clock)
        self.pending.append(rec)
        return rec

    @property
    def n_inflight(self) -> int:
        """Live (admitted, unfinished) request count."""
        return len(self.by_slot)

    @property
    def idle(self) -> bool:
        """True when nothing is pending or in flight."""
        return not self.pending and not self.by_slot

    def _retire(self, rec: RequestRecord) -> None:
        rec.finished_step = self.clock
        self.slots.free(rec.slot)
        del self.by_slot[rec.slot]
        self.finished[rec.request.uid] = rec
        # gather-free: the slot's state rows stay until the next admission
        # overwrites them

    def _admit(self) -> None:
        while self.pending and self.slots.n_free:
            rec = self.pending.popleft()
            rec.slot = s = self.slots.alloc()
            rec.admitted_step = self.clock
            rows = {k: a[s:s + 1] for k, a in self.state.items()}
            _, tok, calls = self.model.prefill(rec.request, self.key,
                                               state=rows)
            rec.calls = calls
            rec.tokens.append(tok)
            rec.first_token_step = self.clock
            self.cur_tok[s] = tok
            self.by_slot[s] = rec
            if rec.done:              # 1-token request: in and out
                self._retire(rec)

    def step(self) -> bool:
        """One scheduler tick: admit, fused-decode ONE operating point's
        group (round-robin over live points), retire.  Returns True if a
        fused decode step ran (False on an idle tick)."""
        self._admit()
        if self.slots.extent() == 0:
            self.clock += 1
            return False
        groups: Dict[str, List[int]] = {}
        for s, rec in self.by_slot.items():
            groups.setdefault(rec.request.point, []).append(s)
        names = sorted(groups)
        pt = names[self._point_rr % len(names)]
        self._point_rr += 1
        group = sorted(groups[pt])
        extent = group[-1] + 1
        bucket = self.model.bound.program.buckets.bucket_for(extent)
        e = min(bucket, self.slots.capacity)
        commit = torch.zeros((e,), dtype=torch.bool)
        commit[group] = True
        t0 = time.perf_counter()
        rows = {k: a[:e] for k, a in self.state.items()}
        _, nxt = self.model.step_rows(
            rows, torch.from_numpy(self.cur_tok[:e]), point=pt,
            commit=commit)
        nxt = nxt.cpu().numpy()
        self.wall_s += time.perf_counter() - t0
        self.extents_seen.add(
            int(self.model.bound.program.buckets.bucket_for(e)))
        self.decode_steps += 1
        self.decode_rows += len(group)
        self.points_served[pt] = self.points_served.get(pt, 0) + 1
        self.clock += 1
        for s in group:
            rec = self.by_slot[s]
            tok = int(nxt[s])
            rec.tokens.append(tok)
            rec.calls += 1
            self.cur_tok[s] = tok
            if rec.done:
                self._retire(rec)
        return True

    def run(self, arrivals: Sequence[Tuple[int, Request]],
            max_steps: int = 100000) -> Dict[int, List[int]]:
        """Drive the loop over a timed arrival schedule: each (step,
        request) is submitted once the clock reaches `step`; runs until
        everything retires.  Returns {uid: token stream}."""
        todo = sorted(arrivals, key=lambda a: a[0])
        i = 0
        for _ in range(max_steps):
            while i < len(todo) and todo[i][0] <= self.clock:
                self.submit(todo[i][1])
                i += 1
            if i == len(todo) and self.idle:
                break
            self.step()
        else:
            raise RuntimeError(f"schedule did not drain in {max_steps} "
                               "steps")
        return {uid: list(rec.tokens)
                for uid, rec in self.finished.items()}

    def metrics(self) -> Dict[str, object]:
        """Serving metrics over the finished requests: p50/p99 end-to-end
        latency and time-to-first-token (in scheduler steps), decode
        throughput (tokens per fused step and per wall-second of fused
        steps), the distinct dispatch bucket rungs seen, and per-point
        token counts."""
        recs = list(self.finished.values())
        by_point: Dict[str, float] = {}
        for r in recs:
            p = r.request.point
            by_point[p] = by_point.get(p, 0.0) + len(r.tokens)
        lat = np.asarray([r.finished_step - r.arrival_step for r in recs]
                         or [0], np.float64)
        ttft = np.asarray([r.first_token_step - r.arrival_step
                           for r in recs] or [0], np.float64)
        toks = sum(len(r.tokens) for r in recs)
        return {
            "requests": float(len(recs)),
            "tokens": float(toks),
            "steps": float(self.clock),
            "decode_steps": float(self.decode_steps),
            "latency_steps_p50": float(np.percentile(lat, 50)),
            "latency_steps_p99": float(np.percentile(lat, 99)),
            "ttft_steps_p50": float(np.percentile(ttft, 50)),
            "ttft_steps_p99": float(np.percentile(ttft, 99)),
            "tokens_per_decode_step": float(
                self.decode_rows / max(self.decode_steps, 1)),
            "decode_wall_s": float(self.wall_s),
            "tokens_per_s": float(toks / self.wall_s) if self.wall_s
            else 0.0,
            "extents_seen": sorted(int(e) for e in self.extents_seen),
            "tokens_by_point": {k: float(v)
                                for k, v in sorted(by_point.items())},
        }
