"""The port's schedule autotuner (`repro_torch.tuner`) against the JAX
package's (`repro.tuner`), on the CPU, in "analytic" mode.

The knob differs by design: JAX tunes a Pallas (bm, bn, bk) block priced
by TPU DMA; the port tunes the cim_mbiw Hopper route's tile, priced by
the card's HBM bytes and wave-filled operations (`core/hw.H100_SXM`).
What must agree, and is held here:

  * the IMAGINE macro's own projections in every `LayerCost` -
    macro_evals, macro_evals_per_device, adc_conversions, t_macro_s -
    equal to JAX's `layer_cost` on the same spec, exactly;
  * `schedule_report` on a tuned plan: the "tune" entry's keys equal
    JAX's and every macro field equal to JAX's;
  * the cache's degradation contract (corrupt, stale schema, invalid
    entry: one warning, the heuristic, no search, no write) and its
    round trip (a hit skips the search), and `cache_key` discrimination;
  * a no-win search folds to a plan hash-equal to the untuned one;
  * plan_layer / plan_network / compile_program validation;
  * tuned cost <= heuristic cost over a hypothesis sweep of shapes and
    the r_in x r_w grid; the card term monotone in M, N and K;
  * a tuned program's outputs bit for bit equal to the untuned one's and
    to JAX's tuned program's (Pallas interpret mode);
  * "measure" on a CPU program raises: it times the Hopper kernel.

The timed counterpart of JAX's Spearman check runs on the card only
(tests/test_torch_gpu.py, chip_smoke.py's tuner phase).
"""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                  # pragma: no cover
    from hypofallback import given, settings, st

from repro import tuner as jtuner
from repro.core import mapping as jmap
from repro.perfmodel import macro_perf as jpm
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro_torch import tuner as ttuner
from repro_torch.convert import params_from_numpy
from repro_torch.core import hw as thw
from repro_torch.core import mapping as tmap
from repro_torch.kernels.cim_mbiw import kernel as tkernel
from repro_torch.perfmodel import macro_perf as tpm
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog
from repro_torch.tuner import cost as tcost
from repro_torch.tuner import search as tsearch

R_INS = (1, 2, 4, 8)
R_WS = (1, 2, 4)
MACRO_FIELDS = ("macro_evals", "macro_evals_per_device", "adc_conversions",
                "t_macro_s")
# LeNet's fc1 at batch 256 ((4, 2): one plane, a 128-channel col tile),
# where the tuner moves route A off route_for's 64 x 16
FC1 = dict(m=256, k=1568, n=128, r_in=4, r_w=2)


def seeded_params(dims, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in dims]


def _count():
    return tsearch.SEARCH_COUNT["n"]


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r_in", R_INS)
@pytest.mark.parametrize("r_w", R_WS)
def test_cost_macro_fields_equal_jax(r_in, r_w):
    """The macro's evaluations, conversions and time equal JAX's
    layer_cost exactly (the JAX package's own shapes and LeNet's)."""
    shapes = [(8, 64, 16), (16, 300, 40), (4, 1300, 256), (32, 2048, 512),
              (256, 1568, 128), (50176, 144, 32), (4, 8192, 2048)]
    for m, k, n in shapes:
        jspec = jmap.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
        tspec = tmap.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
        want = jtuner.layer_cost(
            jspec, jtuner.heuristic_choice(jspec, jrt.EngineConfig()))
        for choice in ttuner.layer_candidates(tspec, trt.EngineConfig(), 1):
            got = ttuner.layer_cost(tspec, choice)
            for f in MACRO_FIELDS:
                assert getattr(got, f) == getattr(want, f), (m, k, n, f)
            assert got.total_s == max(got.t_macro_s, got.t_dma_s)
            assert got.collective_bytes == 0 and got.t_collective_s == 0.0


@pytest.mark.parametrize("devices", (2, 4, 8))
def test_cost_sharded_devices_equal_jax(devices):
    """At D > 1 the search scores the shard kinds JAX's does (none, then
    the automatic kind, then the other), and every candidate's macro
    fields and collective bytes equal JAX's `layer_cost` for its kind;
    devices < 1 raises."""
    for m, k, n in ((8, 144, 320), (64, 1300, 700), (3, 2304, 16)):
        jspec = jmap.LayerSpec(m=m, k=k, n=n, r_in=4, r_w=2)
        tspec = tmap.LayerSpec(m=m, k=k, n=n, r_in=4, r_w=2)
        jcfg = jrt.EngineConfig(sharding=jrt.ShardingConfig(devices=devices))
        tcfg = trt.EngineConfig(sharding=trt.ShardingConfig(devices=devices))
        jkinds = [c.shard_kind for c in jtuner.layer_candidates(
            jspec, jcfg, devices)]
        tkinds = [c.shard_kind for c in ttuner.layer_candidates(
            tspec, tcfg, devices)]
        assert list(dict.fromkeys(tkinds)) == list(dict.fromkeys(jkinds))
        for choice in ttuner.layer_candidates(tspec, tcfg, devices):
            want = jtuner.layer_cost(
                jspec, jtuner.ScheduleChoice(64, 64, 256, choice.shard_kind),
                devices=devices)
            got = ttuner.layer_cost(tspec, choice, devices=devices)
            for f in MACRO_FIELDS + ("collective_bytes",):
                assert getattr(got, f) == getattr(want, f), (m, k, n, f)
            assert got.t_collective_s == \
                got.collective_bytes / thw.H100_SXM.nvlink_bw
    choice = ttuner.heuristic_choice(tspec, trt.EngineConfig())
    with pytest.raises(ValueError, match="devices"):
        ttuner.layer_cost(tspec, choice, devices=0)


@pytest.mark.parametrize("route,base,tile", [
    ("splitk", dict(m=4, k=128, n=64), ("splitk", 0, 64, 32)),
    ("tc", dict(m=64, k=128, n=32), ("tc", 64, 32, 0)),
    ("cuda_core", dict(m=64, k=9, n=16), ("cuda_core", 128, 32, 0)),
])
def test_cost_monotone_in_mnk(route, base, tile):
    """Doubling any one GEMM dimension at a fixed tile never lowers the
    card term, its bytes or the macro evaluations (every shape stays on
    the tile's route)."""
    choice = ttuner.ScheduleChoice(*tile)
    for dim in ("m", "k", "n"):
        prev = None
        for mult in (1, 2, 4, 8):
            kw = dict(base)
            kw[dim] = base[dim] * mult
            spec = tmap.LayerSpec(r_in=8, r_w=4, **kw)
            rows, k, n, planes = tsearch._dispatch(spec, thw.DEFAULT_MACRO)
            assert tkernel.route_for(rows, n, k, planes).name == route
            lc = ttuner.layer_cost(spec, choice)
            if prev is not None:
                assert lc.t_dma_s >= prev.t_dma_s, (dim, mult)
                assert lc.dma_bytes >= prev.dma_bytes, (dim, mult)
                assert lc.total_s >= prev.total_s, (dim, mult)
                assert lc.macro_evals >= prev.macro_evals, (dim, mult)
            prev = lc


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 600), st.integers(8, 3000), st.integers(1, 600),
       st.sampled_from([(r_in, r_w) for r_in in R_INS for r_w in R_WS]))
def test_tuned_cost_never_above_heuristic(m, k, n, prec):
    """tune_layer's winner scores <= the heuristic, whose tile is the
    first candidate, and every candidate is a legal tile of the route the
    layer's dispatch takes."""
    r_in, r_w = prec
    spec = tmap.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
    cfg = trt.EngineConfig()
    cands = ttuner.layer_candidates(spec, cfg, 1)
    heur = ttuner.heuristic_choice(spec, cfg)
    assert cands[0] == heur and len(set(cands)) == len(cands)
    rows, k_t, n_t, planes = tsearch._dispatch(spec, thw.DEFAULT_MACRO)
    own = tkernel.route_for(rows, n_t, k_t, planes)
    assert heur.blocks == own.tile
    assert set(c.blocks for c in cands[1:]) <= set(
        tkernel.legal_tiles(rows, n_t, k_t, planes))
    for c in cands:
        assert c.route == own.name and c.shard_kind is None
    best, rep = ttuner.tune_layer(spec, cfg, 1, cache=None)
    assert rep["predicted_s"] <= rep["heuristic_s"]
    assert ttuner.layer_cost(spec, best).score() <= \
        ttuner.layer_cost(spec, heur).score()
    assert rep["candidates"] == len(cands)


def test_cost_and_chip_smoke_share_the_card_table():
    """The tuner's cost model and chip_smoke.py's bounds (through the
    kernels' cost table, `kernels/costs.py`) read the same objects of
    core/hw - one table of the card, not copied constants."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs
    card = thw.H100_SXM
    assert tcost.H100_SXM is card
    assert cs.CARD is card
    # the kernels' bounds read the rates through the cost table
    # (kernels/costs.py), the same objects of core/hw
    rates = cs.costs.rates(cs.CARD)
    for got, want in ((rates["int8"], card.int8_ops),
                      (rates["bf16"], card.bf16_flops),
                      (rates["f32"], card.f32_flops),
                      (cs.PEAK_F32_OPS, card.f32_flops),
                      (cs.PEAK_INT32_OPS, card.int32_ops),
                      (cs.PEAK_BYTES, card.hbm_bw)):
        assert got is want
    assert (card.int8_ops, card.bf16_flops, card.f32_flops, card.hbm_bw,
            card.sms, card.hbm_bytes, card.l2_bytes, card.smem_per_sm) == (
        1979e12, 989e12, 67e12, 3.35e12, 132, 80e9, 50 * 2**20,
        228 * 2**10)
    assert card.sms == tkernel.WAVE


# ---------------------------------------------------------------------------
# the search, the plan and the program
# ---------------------------------------------------------------------------

def test_tuned_no_win_folds_to_heuristic_plan():
    """A layer whose search keeps the heuristic produces the *same* plan
    (hash-equal), so the tuned program shares the untuned one."""
    spec = tmap.LayerSpec(m=50176, k=144, n=32, r_in=4, r_w=2)   # conv2
    cfg = trt.EngineConfig()
    best, _ = ttuner.tune_layer(spec, cfg, 1, cache=None)
    assert best == ttuner.heuristic_choice(spec, cfg)
    plan_t, _ = ttuner.tune_network([spec], cfg, cache_path="")
    assert plan_t == trt.plan_network((spec,), cfg)
    assert hash(plan_t) == hash(trt.plan_network((spec,), cfg))
    assert plan_t.layers[0].blocks is None


def test_schedule_override_validation():
    """Bad overrides fail loudly at plan time, with JAX's messages."""
    spec = tmap.LayerSpec(m=8, k=64, n=16, r_in=8, r_w=4)   # two planes
    for bad in ((0, 64, 64), ("tc", 64, 128, 0), ("tc", 32, 16, 0),
                ("splitk", 0, 32, 16), ("splitk", 0, 64, 129),
                ("cuda_core", 64, 16, 0), ("gemm", 64, 64, 0),
                ("tc", 64.0, 16, 0)):
        with pytest.raises(ValueError, match="blocks"):
            trt.plan_layer(spec, blocks=bad)
    assert trt.plan_layer(spec, blocks=("tc", 128, 64, 0)).blocks == \
        ("tc", 128, 64, 0)
    with pytest.raises(ValueError, match="sharding"):
        trt.plan_layer(spec, shard_kind="col")
    with pytest.raises(ValueError, match="schedule"):
        trt.plan_network((spec,), trt.EngineConfig(),
                         schedule=(None, (("tc", 64, 16, 0), None)))
    with pytest.raises(ValueError, match="mode"):
        ttuner.tune_network([spec], trt.EngineConfig(), mode="psychic")
    with pytest.raises(ValueError, match="tune"):
        tprog.compile_program((spec,), trt.EngineConfig(), device="cpu",
                              tune="nope")


def test_measure_on_a_cpu_program_raises():
    """"measure" times the Hopper kernel; the plain version a CPU program
    runs ignores tiles, so a CPU program refuses it (never a quiet
    analytic run), before any search."""
    spec = tmap.LayerSpec(**FC1)
    n0 = _count()
    with pytest.raises(ValueError, match="Hopper kernel"):
        tprog.compile_program((spec,), trt.EngineConfig(), device="cpu",
                              tune="measure", tune_cache="")
    with pytest.raises(ValueError, match="Hopper kernel"):
        ttuner.tune_network([spec], trt.EngineConfig(), mode="measure",
                            cache_path="", device="cpu")
    assert _count() == n0


@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4)])
def test_compile_program_tune_bitexact_with_jax(r_in, r_w):
    """compile_program(tune="analytic") end to end on the CPU: fc1 and fc2
    of LeNet at batch 256 get a tuned tile where the cost model finds one;
    the tuned program serves bit for bit like tune="off" and like JAX's
    tuned program; schedule_report echoes the tile, predicted <=
    heuristic, its "tune" keys are JAX's and its macro fields JAX's."""
    dims = (1568, 128, 10)
    tspecs = tuple(tmap.LayerSpec(m=256, k=k, n=n, r_in=r_in, r_w=r_w)
                   for k, n in zip(dims[:-1], dims[1:]))
    jspecs = tuple(jmap.LayerSpec(m=256, k=k, n=n, r_in=r_in, r_w=r_w)
                   for k, n in zip(dims[:-1], dims[1:]))
    params = seeded_params(list(zip(dims[:-1], dims[1:])), r_in)
    x = np.random.default_rng(1).normal(size=(5, 1568)).astype(np.float32)
    p0 = tprog.compile_program(tspecs, trt.EngineConfig(), device="cpu")
    pa = tprog.compile_program(tspecs, trt.EngineConfig(), device="cpu",
                               tune="analytic", tune_cache="")
    assert pa.plan.layers[0].blocks == ("tc", 64, 32, 0)
    assert pa.plan != p0.plan
    y0 = p0.bind(params_from_numpy(params)).serve(torch.from_numpy(x))
    ya = pa.bind(params_from_numpy(params)).serve(torch.from_numpy(x))
    assert torch.equal(y0, ya)
    jp = jprog.compile_program(jspecs, jrt.EngineConfig(), tune="analytic",
                               tune_cache="")
    yj = np.asarray(jp.bind([{k: jnp.asarray(v) for k, v in p.items()}
                             for p in params]).serve(jnp.asarray(x)))
    np.testing.assert_array_equal(ya.numpy().view(np.int32),
                                  yj.view(np.int32))
    # JAX's report of its own tuned plan, beside the port's
    jplan = jrt.plan_network(jspecs, jrt.EngineConfig(),
                             schedule=(((64, 64, 256), None), None))
    jrep = jpm.schedule_report(jplan)
    trep = tpm.schedule_report(pa.plan)
    for jl, tl, lp in zip(jrep["layers"], trep["layers"], pa.plan.layers):
        assert set(jl) == set(tl)
        assert {k: v for k, v in jl.items() if k != "tune"} == \
            {k: v for k, v in tl.items() if k != "tune"}
        if lp.blocks is None:
            continue
        tune = tl["tune"]
        assert set(tune) == set(jl["tune"])
        assert tune["blocks"] == lp.blocks and tune["shard_kind"] is None
        assert tune["predicted_s"] <= tune["heuristic_s"]
    assert jrep["total"] == trep["total"]


# ---------------------------------------------------------------------------
# the cache: round trip and degradation
# ---------------------------------------------------------------------------

def _two_specs():
    """fc1 on route A, then a chained route B layer (4 rows)."""
    return [tmap.LayerSpec(**FC1),
            tmap.LayerSpec(m=4, k=128, n=64, r_in=4, r_w=2)]


def test_cache_roundtrip_hit_skips_search(tmp_path):
    """Miss -> search + write-back; a second tune with the same cache is
    all hits, runs no search and keeps the winners."""
    path = str(tmp_path / "tune.json")
    specs = _two_specs()
    n0 = _count()
    plan1, reps1 = ttuner.tune_network(specs, trt.EngineConfig(),
                                       cache_path=path)
    assert _count() - n0 == len(specs)
    assert all(r["cache"] == "miss" for r in reps1)
    n1 = _count()
    plan2, reps2 = ttuner.tune_network(specs, trt.EngineConfig(),
                                       cache_path=path)
    assert _count() == n1
    assert all(r["cache"] == "hit" for r in reps2)
    assert [r["choice"] for r in reps2] == [r["choice"] for r in reps1]
    assert plan1 == plan2
    with open(path) as fh:
        raw = json.load(fh)
    assert raw["schema"] == ttuner.SCHEMA_VERSION
    entry = raw["entries"][ttuner.cache_key(specs[0], 1)]
    assert (entry["route"], entry["bm"], entry["bn"], entry["bk"]) == \
        plan1.layers[0].blocks
    assert entry["mode"] == "analytic"


def test_cache_corrupt_falls_back_heuristic(tmp_path):
    """A corrupt file warns and yields the heuristic plan - no search, no
    crash, no write-back."""
    path = str(tmp_path / "tune.json")
    with open(path, "w") as fh:
        fh.write("{ this is not json")
    spec = tmap.LayerSpec(**FC1)
    n0 = _count()
    with pytest.warns(ttuner.TuneCacheWarning, match="unreadable"):
        plan, reps = ttuner.tune_network([spec], trt.EngineConfig(),
                                         cache_path=path)
    assert _count() == n0
    assert reps[0]["cache"] == "invalid"
    assert plan == trt.plan_network((spec,), trt.EngineConfig())
    with open(path) as fh:
        assert fh.read() == "{ this is not json"


@pytest.mark.parametrize("raw", [
    {"schema": 2, "entries": {}}, {"entries": {}}, [1, 2],
    {"schema": 1, "entries": [1]}])
def test_cache_stale_schema_falls_back_heuristic(tmp_path, raw):
    """A schema mismatch (or a file that is no table of entries) degrades
    exactly like corruption: one warning, the heuristic, nothing written."""
    path = str(tmp_path / "tune.json")
    with open(path, "w") as fh:
        json.dump(raw, fh)
    spec = tmap.LayerSpec(**FC1)
    n0 = _count()
    with pytest.warns(ttuner.TuneCacheWarning) as rec:
        plan, reps = ttuner.tune_network([spec], trt.EngineConfig(),
                                         cache_path=path)
    assert len(rec) == 1
    assert _count() == n0 and reps[0]["cache"] == "invalid"
    assert plan == trt.plan_network((spec,), trt.EngineConfig())
    with open(path) as fh:
        assert json.load(fh) == raw


def test_cache_invalid_entry_falls_back_heuristic(tmp_path):
    """One malformed entry (or a tile its route does not launch at the
    layer's planes) degrades only its own layer; a valid entry in the same
    file still hits."""
    path = str(tmp_path / "tune.json")
    s_bad, s_good = _two_specs()
    s_wide = tmap.LayerSpec(m=256, k=64, n=64, r_in=8, r_w=4)
    entries = {
        ttuner.cache_key(s_bad, 1): {"route": "tc", "bm": -5, "bn": "x",
                                     "bk": 0, "shard_kind": None},
        # 128 columns at two planes: more registers than route A holds
        ttuner.cache_key(s_wide, 1): {"route": "tc", "bm": 64, "bn": 128,
                                      "bk": 0, "shard_kind": None},
        ttuner.cache_key(s_good, 1): {"route": "splitk", "bm": 0, "bn": 64,
                                      "bk": 40, "shard_kind": None},
    }
    with open(path, "w") as fh:
        json.dump({"schema": ttuner.SCHEMA_VERSION, "entries": entries}, fh)
    n0 = _count()
    with pytest.warns(ttuner.TuneCacheWarning, match="invalid"):
        plan, reps = ttuner.tune_network([s_bad, s_good, s_wide],
                                         trt.EngineConfig(), cache_path=path)
    assert [r["cache"] for r in reps] == ["invalid", "hit", "invalid"]
    assert reps[1]["choice"] == ttuner.ScheduleChoice("splitk", 0, 64, 40)
    assert plan.layers[1].blocks == ("splitk", 0, 64, 40)
    assert plan.layers[0].blocks is None and plan.layers[2].blocks is None
    assert _count() == n0
    with open(path) as fh:
        assert json.load(fh)["entries"] == entries


def test_cache_key_discriminates():
    """The key separates geometry, precision, kind, device count, macro
    and card - and never collides with the JAX package's key."""
    s = tmap.LayerSpec(m=8, k=64, n=16, r_in=4, r_w=2)
    base = ttuner.cache_key(s, 1)
    others = [
        ttuner.cache_key(tmap.LayerSpec(m=8, k=64, n=32, r_in=4, r_w=2), 1),
        ttuner.cache_key(tmap.LayerSpec(m=8, k=64, n=16, r_in=8, r_w=2), 1),
        ttuner.cache_key(tmap.LayerSpec(m=9, k=64, n=16, r_in=4, r_w=2), 1),
        ttuner.cache_key(tmap.conv_layer_spec(2, 2, 2, 4, 16, r_in=4,
                                              r_w=2), 1),
        ttuner.cache_key(s, 4),
        ttuner.cache_key(s, 1, dataclasses.replace(thw.DEFAULT_MACRO,
                                                   n_rows=576)),
        ttuner.cache_key(s, 1, gpu=dataclasses.replace(thw.H100_SXM,
                                                       name="h200_sxm")),
    ]
    assert base not in others and len(set(others)) == len(others)
    assert base != jtuner.cache_key(jmap.LayerSpec(m=8, k=64, n=16, r_in=4,
                                                   r_w=2), 1)
    assert ttuner.default_cache_path() != jtuner.default_cache_path()


def test_cache_path_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "a"))
    assert ttuner.default_cache_path() == str(tmp_path / "a")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert ttuner.default_cache_path().endswith(
        os.path.join(".cache", "repro-cim", "autotune_torch.json"))


def test_cache_through_compile_program(tmp_path):
    """The integrated path with a cache file: the first compile misses and
    tunes, a fresh compile (program cache cleared) hits with no search;
    both serve bit for bit like tune="off"; the cache path is part of the
    program-cache key."""
    tprog.clear_program_cache()
    path = str(tmp_path / "tune.json")
    specs = (tmap.LayerSpec(**FC1),)
    p0 = tprog.compile_program(specs, trt.EngineConfig(), device="cpu")
    p1 = tprog.compile_program(specs, trt.EngineConfig(), device="cpu",
                               tune="analytic", tune_cache=path)
    n1 = _count()
    assert tprog.compile_program(specs, trt.EngineConfig(), device="cpu",
                                 tune="analytic", tune_cache=path) is p1
    tprog.clear_program_cache()
    p2 = tprog.compile_program(specs, trt.EngineConfig(), device="cpu",
                               tune="analytic", tune_cache=path)
    assert _count() == n1 and p1.plan == p2.plan
    params = params_from_numpy(seeded_params([(1568, 128)], 3))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 1568)).astype(np.float32))
    assert torch.equal(p0.bind(params).serve(x), p2.bind(params).serve(x))
    tprog.clear_program_cache()
