"""The port's program cache and dispatch routes against the JAX package.

- the two-table LRU cache (`set_program_cache_capacity`, evictions,
  capacity, $REPRO_PROGRAM_CACHE_CAP) and an evicted program that still
  serves bit for bit with JAX;
- `compile_program` plans once, equal plans share one program, and
  `program_for_plan(prog.plan) is prog`; hash, equality and `.cfg`;
- `executables_compiled` bounded by the bucket ladder over batch sizes
  1-17, with the same dispatch counters as JAX's program;
- the forward with `m_valid` as a 0-d tensor bit-equal to its int form,
  whatever the pad rows hold, and to JAX's bucketed serve;
- every dispatch on the CPU, keyed, reference or with per-call params
  runs eagerly and counts in `eager_calls`, never in the graph counters;
- the route-B workspace keeps every outgrown buffer alive, and the
  launch-counter helpers a graph replay uses.

The CUDA-graph route itself needs the card: tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as jmap
from repro.runtime import program as jprog
from repro_torch.convert import params_from_numpy
from repro_torch.core import mapping as tmap
from repro_torch.core import prng
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.kernels.cim_mbiw import kernel as tkernel
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog


def seeded_params(dims, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in dims]


def _jparams(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


def specs(mod, dims, r_in=4, r_w=2, m=4):
    return tuple(mod.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
                 for k, n in zip(dims[:-1], dims[1:]))


def bits_equal(want, got):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.fixture
def capacity():
    """Restores the port's cache capacity after the test."""
    old = tprog.set_program_cache_capacity(tprog._CACHE_CAPACITY[0])
    yield
    tprog.set_program_cache_capacity(old)


# ---- the LRU tables ----------------------------------------------------------

def test_program_cache_lru_eviction_matches_jax(capacity):
    """Shrinking the capacity evicts at once (counted), and the first,
    evicted program keeps serving, bit for bit with JAX's program."""
    tprog.clear_program_cache()
    assert tprog.set_program_cache_capacity(2) == tprog._env_capacity()
    progs = [tprog.compile_program(
        (tmap.LayerSpec(m=2, k=16, n=8 + 8 * i, r_in=2, r_w=1),),
        device="cpu") for i in range(4)]
    st = tprog.program_cache_stats()
    assert st["capacity"] == 2 and st["programs"] == 2
    # two evictions from each table
    assert st["evictions"] == 4 and st["programs_built"] == 4
    params = seeded_params([(16, 8)], 0)
    x = np.maximum(np.random.default_rng(1).normal(size=(2, 16)),
                   0).astype(np.float32)
    got = progs[0].serve(params_from_numpy(params), torch.from_numpy(x))
    assert torch.equal(got, progs[0].serve(params_from_numpy(params),
                                           torch.from_numpy(x),
                                           reference=True))
    jp = jprog.compile_program(
        (jmap.LayerSpec(m=2, k=16, n=8, r_in=2, r_w=1),))
    bits_equal(jp.serve(_jparams(params), jnp.asarray(x)), got)
    # an equal compile re-plans the evicted program: a new object
    again = tprog.compile_program(
        (tmap.LayerSpec(m=2, k=16, n=8, r_in=2, r_w=1),), device="cpu")
    assert again is not progs[0] and again == progs[0]
    assert tprog.program_cache_stats()["programs_built"] == 5


def test_set_program_cache_capacity_validates_and_trims(capacity):
    tprog.clear_program_cache()
    for i in range(3):
        tprog.compile_program(specs(tmap, (8, 4 + i)), device="cpu")
    assert tprog.program_cache_stats()["programs"] == 3
    tprog.set_program_cache_capacity(1)
    st = tprog.program_cache_stats()
    assert st["programs"] == 1 and st["evictions"] == 4
    with pytest.raises(ValueError, match=">= 1"):
        tprog.set_program_cache_capacity(0)
    with pytest.raises(ValueError, match=">= 1"):
        jprog.set_program_cache_capacity(0)
    tprog.clear_program_cache()
    assert tprog.program_cache_stats() == {
        "programs_built": 0, "lookups": 0, "hits": 0, "evictions": 0,
        "programs": 0, "capacity": 1}


@pytest.mark.parametrize("env", [None, "7", "0", "-3", "many"])
def test_env_capacity_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("REPRO_PROGRAM_CACHE_CAP", raising=False)
    else:
        monkeypatch.setenv("REPRO_PROGRAM_CACHE_CAP", env)
    assert tprog._env_capacity() == jprog._env_capacity()
    assert tprog._env_capacity() == {None: 512, "7": 7, "0": 1, "-3": 1,
                                     "many": 512}[env]


def test_lru_order_matches_jax(capacity):
    """The same compile sequence evicts the same programs in both
    packages: a hit refreshes an entry, the least recently used goes."""
    jcap = jprog.set_program_cache_capacity(2)
    try:
        jprog.clear_program_cache()
        tprog.clear_program_cache()
        tprog.set_program_cache_capacity(2)
        order = (0, 1, 0, 2, 1, 0)
        jp = [jprog.compile_program(specs(jmap, (8, 20 + i)))
              for i in order]
        tp = [tprog.compile_program(specs(tmap, (8, 20 + i)), device="cpu")
              for i in order]
        js, ts = jprog.program_cache_stats(), tprog.program_cache_stats()
        assert ts == js
        # the second 0 hits; 2 evicts key 1 and plan 0; 1 finds its plan
        # still cached; the last 0 is planned anew
        assert tp[0] is tp[2] and tp[4] is tp[1] and tp[5] is not tp[0]
        assert jp[0] is jp[2] and jp[4] is jp[1] and jp[5] is not jp[0]
    finally:
        jprog.set_program_cache_capacity(jcap)


# ---- plan sharing, identity ------------------------------------------------

def test_compile_program_plans_once_and_shares_plans():
    dims = (56, 16)
    plans0 = trt.PLAN_COUNT["n"]
    p1 = tprog.compile_program(specs(tmap, dims), device="cpu")
    plans1 = trt.PLAN_COUNT["n"]
    p2 = tprog.compile_program(specs(tmap, dims), device="cpu")
    p3 = tprog.compile_program(list(specs(tmap, dims)), trt.EngineConfig(),
                               activations=["none"], pools=[1],
                               device="cpu")
    assert p1 is p2 is p3 and trt.PLAN_COUNT["n"] == plans1
    assert plans1 <= plans0 + 1
    assert tprog.program_for_plan(p1.plan, device="cpu") is p1
    assert tprog.program_for_plan(p1.plan, p1.buckets, "cpu") is p1
    assert hash(p1) == hash(tprog.compile_program(specs(tmap, dims),
                                                  device="cpu"))
    assert p1.cfg is p1.plan.cfg
    with pytest.raises(AttributeError, match="immutable"):
        p1.plan = None
    # JAX's program answers the same questions the same way
    jp = jprog.compile_program(specs(jmap, dims))
    assert jprog.program_for_plan(jp.plan) is jp
    assert jp.cfg is jp.plan.cfg


def test_program_for_plan_caches_a_fresh_plan():
    """A plan built outside compile_program gets one program, cached;
    an equal plan built again (another object) finds the same one, as
    does a compile_program whose key is new but whose plan is equal."""
    sp = specs(tmap, (40, 12, 5), r_in=3, r_w=3)
    built = tprog.program_cache_stats()["programs_built"]
    plan = trt.plan_network(sp)
    prog = tprog.program_for_plan(plan, device="cpu")
    assert tprog.program_for_plan(plan, device="cpu") is prog
    assert tprog.program_for_plan(trt.plan_network(sp), device="cpu") is prog
    assert tprog.compile_program(sp, device="cpu") is prog
    assert tprog.program_cache_stats()["programs_built"] == built + 1
    other = tprog.program_for_plan(plan, tprog.BatchBuckets(4),
                                   device="cpu")
    assert other is not prog and other != prog
    assert prog == tprog.CIMProgram(plan, device="cpu")
    assert prog != tprog.CIMProgram(plan, tprog.BatchBuckets(2),
                                    device="cpu")


# ---- the executable count --------------------------------------------------

def test_executables_bounded_by_ladder_matches_jax():
    """Every batch size 1..17 lands on a rung: the program's dispatch
    keys are bounded by the ladder, its counters equal JAX's program's,
    and the outputs equal JAX's at a size per rung."""
    dims = (104, 16)
    params = seeded_params([dims], 5)
    x = np.maximum(np.random.default_rng(5).normal(size=(17, 104)),
                   0).astype(np.float32)
    jprog_ = jprog.compile_program(specs(jmap, dims, r_in=2, r_w=1))
    tprog_ = tprog.compile_program(specs(tmap, dims, r_in=2, r_w=1),
                                   device="cpu")
    jb, tb = jprog_.bind(_jparams(params)), tprog_.bind(
        params_from_numpy(params))
    j0, t0 = jprog_.stats(), tprog_.stats()
    for m in range(1, 18):
        got = tb.serve(torch.from_numpy(x[:m]))
        assert tuple(got.shape) == (m, 16)
        if m in (1, 2, 3, 5, 9, 17):
            bits_equal(jb.serve(jnp.asarray(x[:m])), got)
        else:
            jb.serve(jnp.asarray(x[:m]))
    ladder = tprog_.buckets.ladder(17)
    jd = {k: v - j0[k] for k, v in jprog_.stats().items()}
    td = {k: v - t0[k] for k, v in tprog_.stats().items()}
    assert td["executables_compiled"] <= len(ladder)
    assert td["bucket_misses"] <= len(ladder)
    assert td["bucket_hits"] == 17 - td["bucket_misses"]
    assert {k: td[k] for k in jd} == jd
    # the CPU is an eager route: no graph counter moves
    assert td["eager_calls"] == 17 and td["graphs_captured"] == 0 \
        and td["graph_replays"] == 0


# ---- m_valid as a device scalar ----------------------------------------------

@pytest.mark.parametrize("m,bucket", [(5, 8), (3, 4), (8, 8), (1, 2)])
def test_m_valid_tensor_matches_int_and_jax(m, bucket):
    """The forward with m_valid a 0-d int64 tensor equals its int form
    bit for bit, whatever the pad rows hold (a captured graph's static
    rows keep an earlier call's data), and equals JAX's bucketed serve."""
    dims = (300, 40, 7)
    params = seeded_params(list(zip(dims[:-1], dims[1:])), m)
    prog = tprog.compile_program(specs(tmap, dims), device="cpu")
    binds = prog.bind(params_from_numpy(params))._binds
    rng = np.random.default_rng(m + bucket)
    x = rng.normal(size=(m, 300)).astype(np.float32)
    pad_row0 = np.concatenate([x, np.repeat(x[:1], bucket - m, 0)])
    pad_junk = np.concatenate([x, 1e6 * rng.normal(
        size=(bucket - m, 300)).astype(np.float32)])
    outs = [trt._forward(prog.plan, binds, torch.from_numpy(xp),
                         reference=ref, m_valid=mv)[:m]
            for xp in (pad_row0, pad_junk)
            for mv in (m, torch.tensor(m, dtype=torch.int64))
            for ref in (False, True)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    jb = jprog.compile_program(specs(jmap, dims)).bind(_jparams(params))
    bits_equal(jb.serve(jnp.asarray(x)), outs[0])


def test_m_valid_tensor_with_segments_on_a_conv_matches_int():
    """A conv front end with segment ids (repeated over each image's
    im2col rows) and a 0-d m_valid equals the int form and JAX."""
    b, bucket = 3, 4
    conv = dict(h=8, w=8, c_in=2, c_out=6, r_in=4, r_w=2)
    jc = jmap.conv_layer_spec(batch=bucket, **conv)
    tc = tmap.conv_layer_spec(batch=bucket, **conv)
    feat = tc.conv.out_h * tc.conv.out_w * 6
    params = seeded_params([(tc.k, 6), (feat, 5)], 11)
    prog = tprog.compile_program(
        (tc, tmap.LayerSpec(m=bucket, k=feat, n=5, r_in=4, r_w=2)),
        device="cpu")
    binds = prog.bind(params_from_numpy(params))._binds
    rng = np.random.default_rng(12)
    x = np.maximum(rng.normal(size=(b, 8, 8, 2)), 0).astype(np.float32)
    x[1:] *= 30.0
    seg = np.array([0, 1, 1], np.int64)
    xp = torch.from_numpy(np.concatenate([x, -5.0 * x[:1]]))
    sp = torch.from_numpy(np.concatenate([seg, seg[:1]]))
    got = [trt._forward(prog.plan, binds, xp, reference=False, m_valid=mv,
                        seg=sp)[:b]
           for mv in (b, torch.tensor(b))]
    assert torch.equal(got[0], got[1])
    jb = jprog.compile_program(
        (jc, jmap.LayerSpec(m=bucket, k=feat, n=5, r_in=4, r_w=2))).bind(
        _jparams(params))
    bits_equal(jb.serve(jnp.asarray(x), segments=jnp.asarray(seg)), got[0])


# ---- eager routes ------------------------------------------------------------

def test_eager_routes_are_counted():
    """On the CPU every dispatch is eager; keyed, reference and
    per-call-params dispatches are eager routes on any device.  Each one
    counts in eager_calls, none captures."""
    dims = (48, 10)
    params = params_from_numpy(seeded_params([dims], 2))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 48)).astype(np.float32))
    captures = trt.CAPTURE_COUNT["n"]
    prog = tprog.compile_program(specs(tmap, dims, r_in=3, r_w=2),
                                 device="cpu")
    bound = prog.bind(params)
    noisy = tprog.compile_program(
        specs(tmap, dims, r_in=3, r_w=2),
        trt.EngineConfig(noise=NoiseConfig()), device="cpu").bind(params)
    calls = (lambda: bound.serve(x),                       # the CPU
             lambda: bound.reference(x),                   # reference
             lambda: bound.serve(x, prng.key(0)),          # keyed, clean
             lambda: prog.run(params, x),                  # per-call params
             lambda: prog.serve(params, x),
             lambda: bound.serve_batch([x[:1], x[1:]], isolate=True),
             lambda: noisy.serve(x, prng.key(1)))          # keyed, noisy
    for fn in calls:
        p = noisy.program if fn is calls[-1] else prog
        st0 = p.stats()
        fn()
        st = p.stats()
        assert st["eager_calls"] == st0["eager_calls"] + 1
        assert (st["graphs_captured"], st["graph_replays"]) == \
            (st0["graphs_captured"], st0["graph_replays"])
    assert trt.CAPTURE_COUNT["n"] == captures
    assert bound.executables == () and noisy.executables == ()


# ---- the route-B workspace and the replay counters -------------------------

def test_outgrown_workspace_stays_alive():
    """A workspace a captured graph may hold is never freed when a larger
    one replaces it."""
    dev = torch.device("cpu")
    tkernel._WORKSPACE.pop(dev, None)
    n_retired = len(tkernel._RETIRED_WORKSPACES)
    small = tkernel._splitk_workspace(dev, 10)
    assert tkernel._splitk_workspace(dev, 8) is small
    big = tkernel._splitk_workspace(dev, 100)
    assert big.numel() >= 100 and big is not small
    assert tkernel._RETIRED_WORKSPACES[n_retired] is small
    assert int(small.abs().sum()) == 0 and int(big.abs().sum()) == 0
    tkernel._WORKSPACE.pop(dev)
    del tkernel._RETIRED_WORKSPACES[n_retired:]


def test_launch_count_helpers_round_trip():
    fn = tkernel.cim_mbiw_matmul_planes
    before = tkernel.launch_counts()
    assert set(before) == set(tkernel.LAUNCH_COUNTERS)
    delta = {"launches": 7, "launches_tc": 2, "launches_splitk": 4}
    tkernel.add_launches(delta)
    assert (fn.launches, fn.launches_tc, fn.launches_splitk) == (
        before["launches"] + 7, before["launches_tc"] + 2,
        before["launches_splitk"] + 4)
    tkernel.add_launches({c: -n for c, n in delta.items()})
    assert tkernel.launch_counts() == before
