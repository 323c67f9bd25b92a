"""The port's in-flight scheduler: per-request isolation, bit for bit.

For every request of every admit/retire schedule, the fused token stream
of `InflightScheduler.run` must equal decoding the request alone
(`decode_sequential`), for one operating point and for mixed points, with
queueing beyond capacity and one-token requests, and the fused dispatch
extents must stay on the BatchBuckets ladder.  Schedules are fuzzed with
hypothesis (or the deterministic hypofallback stand-in).  A step updates
the decode state in place, so rows outside the stepped group are checked
to come out of it untouched.  Sizes follow tests/test_scheduler.py:
d = 48, depth 2, vocab 23, window 16, on the CPU.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypofallback import given, settings, st

from repro_torch.runtime import scheduler as tsch
from repro_torch.runtime.scheduler import (CIMDecodeLM, InflightScheduler,
                                           Request, SlotMap,
                                           decode_sequential)

POINTS = ("", "throughput", "quality")
MIXED = {"throughput": (2, 1), "quality": ((4, 2), (4, 4), (2, 2), (4, 2))}
_MODELS = {}
_SOLO = {}


def _model(mixed: bool = False) -> CIMDecodeLM:
    # module-cached: every fuzz case serves the same bound programs
    if mixed not in _MODELS:
        _MODELS[mixed] = CIMDecodeLM.toy(
            torch.Generator().manual_seed(7), d=48, depth=2, vocab=23,
            r_in=4, r_w=2, points=MIXED if mixed else None, device="cpu")
    return _MODELS[mixed]


def _solo(model, req: Request):
    k = (id(model), req.uid, req.prompt, req.max_new_tokens, req.point)
    if k not in _SOLO:
        _SOLO[k] = decode_sequential(model, req)
    return _SOLO[k]


def _schedule(seed: int, n_req: int, points=("",)):
    rng = np.random.default_rng(seed)
    arrivals = []
    for uid in range(n_req):
        prompt = tuple(int(t) for t in
                       rng.integers(0, 23, size=int(rng.integers(1, 5))))
        req = Request(uid=uid, prompt=prompt,
                      max_new_tokens=int(rng.integers(1, 6)),
                      point=points[int(rng.integers(0, len(points)))])
        arrivals.append((int(rng.integers(0, 7)), req))
    return arrivals


def _check_schedule(seed, n_req, capacity, mixed=False):
    model = _model(mixed)
    arrivals = _schedule(seed, n_req, POINTS if mixed else ("",))
    sched = InflightScheduler(model, capacity=capacity)
    fused = sched.run(arrivals)
    assert set(fused) == {r.uid for _, r in arrivals}
    for _, req in arrivals:
        assert fused[req.uid] == _solo(model, req), \
            f"uid={req.uid} diverged from solo decode (seed={seed})"
    ladder = set(model.bound.program.buckets.ladder(capacity))
    assert set(sched.metrics()["extents_seen"]) <= ladder
    return sched


# ---- slot map and validation ------------------------------------------------

def test_slotmap_lowest_free_and_extent():
    s = SlotMap(4)
    assert [s.alloc() for _ in range(3)] == [0, 1, 2]
    assert s.extent() == 3 and s.n_free == 1
    s.free(1)
    assert s.extent() == 3            # retirement moves no one
    assert s.alloc() == 1             # lowest free slot is reused first
    s.free(0), s.free(1), s.free(2)
    assert s.extent() == 0 and s.live() == ()
    with pytest.raises(KeyError):
        s.free(3)
    [s.alloc() for _ in range(4)]
    with pytest.raises(RuntimeError, match="no free slot"):
        s.alloc()
    with pytest.raises(ValueError, match=">= 1"):
        SlotMap(0)


def test_request_and_point_validation():
    with pytest.raises(ValueError, match="non-empty prompt"):
        Request(uid=0, prompt=(), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(uid=0, prompt=(1,), max_new_tokens=0)
    with pytest.raises(ValueError, match="str tag"):
        Request(uid=0, prompt=(1,), max_new_tokens=1, point=3)
    model = _model(mixed=True)
    assert model.points == ("", "quality", "throughput")
    with pytest.raises(ValueError, match="unknown operating point"):
        InflightScheduler(model, capacity=2).submit(
            Request(uid=0, prompt=(1,), max_new_tokens=1, point="nope"))


def test_noise_raises_not_implemented():
    model = _model()
    with pytest.raises(NotImplementedError, match="noise slice"):
        InflightScheduler(model, capacity=2, key=object())
    with pytest.raises(NotImplementedError, match="noise slice"):
        decode_sequential(model, Request(0, (1,), 1), key=object())
    with pytest.raises(NotImplementedError, match="noise slice"):
        model.step_rows(model.init_state(1), [1],
                        noise_ids=torch.zeros(1, dtype=torch.int32))


# ---- the isolation property -------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 6), st.sampled_from([2, 3, 4]))
def test_fused_decode_equals_sequential(seed, n_req, capacity):
    """Any admit/retire schedule at one point: every fused token stream is
    bit-identical to the request's solo decode."""
    _check_schedule(seed, n_req, capacity)


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 6), st.sampled_from([2, 3, 4]))
def test_mixed_points_fused_equals_sequential(seed, n_req, capacity):
    """Schedules mixing base/quality/throughput requests: every fused
    request equals its solo decode at its own point."""
    _check_schedule(seed, n_req, capacity, mixed=True)


def test_queueing_beyond_capacity_preserves_isolation():
    model = _model()
    reqs = [Request(uid=u, prompt=(u % 23, (2 * u) % 23),
                    max_new_tokens=1 + u % 4) for u in range(7)]
    sched = InflightScheduler(model, capacity=2)
    out = sched.run([(0, r) for r in reqs])
    for r in reqs:
        assert out[r.uid] == _solo(model, r)
    assert max(sched.metrics()["extents_seen"]) <= 2


def test_one_token_request_admit_and_retire_same_step():
    model = _model()
    req = Request(uid=9, prompt=(3, 1), max_new_tokens=1)
    sched = InflightScheduler(model, capacity=2)
    out = sched.run([(0, req)])
    assert out[9] == _solo(model, req) and len(out[9]) == 1
    rec = sched.finished[9]
    assert rec.admitted_step == rec.finished_step
    assert sched.decode_steps == 0


def test_rows_outside_the_group_are_untouched():
    """A step updates the state in place; rows it does not commit (other
    points' live slots riding along as padding) end it exactly as they
    began it, and the committed rows change only in their ring slot and
    position."""
    model = _model(mixed=True)
    state = model.init_state(4)
    for s, (prompt, pt) in enumerate((((1, 2), "quality"), ((5,), ""),
                                      ((7, 8, 9), "quality"),
                                      ((4, 4), "throughput"))):
        model.prefill(Request(s, prompt, 3, pt),
                      state={k: a[s:s + 1] for k, a in state.items()})
    before = {k: a.clone() for k, a in state.items()}
    commit = torch.tensor([True, False, True, False])
    _, nxt = model.step_rows(state, [3, 6, 11, 2], point="quality",
                             commit=commit)
    assert tuple(nxt.shape) == (4,)
    for key in ("k", "v", "pos"):
        assert torch.equal(state[key][1], before[key][1])
        assert torch.equal(state[key][3], before[key][3])
    assert state["pos"].tolist() == [3, 1, 4, 2]
    for row, slot in ((0, 2), (2, 3)):
        changed = (state["k"][row] != before["k"][row]).any(dim=(0, 2, 3))
        assert changed.nonzero().flatten().tolist() == [slot]


def test_digital_ops_give_each_row_its_solo_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(5, 48)).astype(np.float32))
    qk = torch.from_numpy(rng.normal(size=(5, 4, 12)).astype(np.float32))
    pos = torch.tensor([0, 3, 17, 40, 1000])
    embed = _model().embed
    for fn, args in ((tsch._rms_norm, (x,)), (tsch._silu, (x,)),
                     (tsch._rope, (qk, pos)),
                     (tsch._tied_logits, (x, embed))):
        whole = fn(*args)
        for r in range(5):
            rows = tuple(a[r:r + 1] if a.shape[0] == 5 else a for a in args)
            assert torch.equal(whole[r:r + 1], fn(*rows)), fn.__name__


def test_metrics_account_every_token():
    model = _model(mixed=True)
    reqs = [Request(uid=u, prompt=(u % 23, 1), max_new_tokens=2,
                    point=POINTS[u % 3]) for u in range(6)]
    sched = InflightScheduler(model, capacity=4)
    out = sched.run([(0, r) for r in reqs])
    m = sched.metrics()
    for p in POINTS:
        want = sum(len(out[r.uid]) for r in reqs if r.point == p)
        assert m["tokens_by_point"][p] == want
    assert m["requests"] == 6 and m["tokens"] == 12
    assert sum(sched.points_served.values()) == m["decode_steps"]
