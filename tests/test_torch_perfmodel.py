"""The port's macro cycle and energy model against the JAX package's,
float for float.

`repro_torch.perfmodel` is plain Python over the port's `LayerSpec`,
`map_layer` and `CIMMacroConfig`, so every number must equal JAX's
exactly (`==`, never approx): the eval time and Eqs. 8-10 over the whole
precision grid, the energy model and per-layer reports on dense and conv
specs, the schedule report of LeNet's plan and of a dense plan at every
point of the precision chain (clean and with the noise echo), the
operating-point echo, and `CIMProgram.perf_report`'s program echo on the
counters both packages keep.  The macro-model cases of
`tests/test_hlo_and_perf.py` (regimes, energy anchors, split-DPL
savings, quasi-linear precision scaling, eval time) run on the port.
"""
import dataclasses

import pytest

from repro.core import mapping as jmap
from repro.core import noise_model as jnm
from repro.models import cnn as jcnn
from repro.perfmodel import macro_perf as jpm
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro_torch.convert import params_from_numpy
from repro_torch.core import mapping as tmap
from repro_torch.core import noise_model as tnm
from repro_torch.models import cnn as tcnn
from repro_torch.perfmodel import macro_perf as tpm
from repro_torch.perfmodel import (EnergyModel, cim_eval_time_ns,
                                   cycle_model)
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog

CHAIN = ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (8, 4))
# dense and conv-shaped specs: one row tile, two row tiles (K > 1152),
# many col tiles, a conv kernel without geometry
SPECS = (dict(m=8, k=144, n=16), dict(m=4, k=2304, n=80),
         dict(m=1, k=1152, n=256, kernel=(3, 3)), dict(m=32, k=48, n=300))


def _specs(i, **r):
    return (jmap.LayerSpec(**SPECS[i], **r), tmap.LayerSpec(**SPECS[i], **r))


def _conv_specs(**r):
    return (jmap.conv_layer_spec(2, 14, 14, 16, 32, padding=1, **r),
            tmap.conv_layer_spec(2, 14, 14, 16, 32, padding=1, **r))


@pytest.mark.parametrize("r_out", (4, 8))
@pytest.mark.parametrize("r_w", (1, 2, 3, 4))
@pytest.mark.parametrize("r_in", range(1, 9))
def test_eval_time_and_cycle_model_equal_jax(r_in, r_w, r_out):
    r = dict(r_in=r_in, r_w=r_w, r_out=r_out)
    assert cim_eval_time_ns(r_in, r_w, r_out) == jpm.cim_eval_time_ns(
        r_in, r_w, r_out)
    pairs = [_specs(i, **r) for i in range(len(SPECS))] + [_conv_specs(**r)]
    for js, ts in pairs:
        for clock in (10.0, 3.3):
            assert dataclasses.asdict(cycle_model(ts, clock_ns=clock)) == \
                dataclasses.asdict(jpm.cycle_model(js, clock_ns=clock))


@pytest.mark.parametrize("kind", ("dense0", "dense1", "dense2", "dense3",
                                  "conv"))
def test_energy_model_and_layer_report_equal_jax(kind):
    jem, tem = jpm.EnergyModel(), EnergyModel()
    for ri, rw in CHAIN:
        for r_out in (4, 8):
            r = dict(r_in=ri, r_w=rw, r_out=r_out)
            js, ts = (_conv_specs(**r) if kind == "conv"
                      else _specs(int(kind[-1]), **r))
            jmp, tmp = jmap.map_layer(js), tmap.map_layer(ts)
            assert dataclasses.asdict(jmp) == dataclasses.asdict(tmp)
            for units in (1, 7, 32):
                assert tem.e_dp_pj(units, ri) == jem.e_dp_pj(units, ri)
            for gamma in (1.0, 3.0):
                assert tem.e_adc_total_pj(r_out, gamma) == \
                    jem.e_adc_total_pj(r_out, gamma)
                assert tem.macro_energy_pj(ts, tmp, gamma) == \
                    jem.macro_energy_pj(js, jmp, gamma)
                assert tem.macro_tops_per_watt(ts, gamma=gamma) == \
                    jem.macro_tops_per_watt(js, gamma=gamma)
            for norm in (False, True):
                assert tem.macro_ops_per_eval(ts, tmp, norm) == \
                    jem.macro_ops_per_eval(js, jmp, norm)
                assert tem.macro_throughput_tops(ts, normalize_8b=norm) == \
                    jem.macro_throughput_tops(js, normalize_8b=norm)
            for pipelined in (True, False):
                for clock in (10.0, 5.0):
                    kw = dict(gamma=2.0, pipelined=pipelined)
                    assert tpm.AcceleratorPerfModel(
                        clock_ns=clock).layer_report(ts, **kw) == \
                        jpm.AcceleratorPerfModel(
                            clock_ns=clock).layer_report(js, **kw)


def _plans(net, point, noise):
    ri, rw = point
    if net == "lenet":
        from repro.core.cim_layers import CIMConfig as JCIM
        from repro_torch.core.cim_layers import CIMConfig as TCIM
        js, ja, jp = jcnn.lenet_engine_specs(8, cim=JCIM(r_in=ri, r_w=rw))
        ts, ta, tp = tcnn.lenet_engine_specs(8, cim=TCIM(r_in=ri, r_w=rw))
    else:
        js = [jmap.LayerSpec(m=4, k=1300, n=200, r_in=ri, r_w=rw),
              jmap.LayerSpec(m=4, k=200, n=10, r_in=ri, r_w=rw)]
        ts = [tmap.LayerSpec(m=4, k=1300, n=200, r_in=ri, r_w=rw),
              tmap.LayerSpec(m=4, k=200, n=10, r_in=ri, r_w=rw)]
        ja = ta = ["relu", "none"]
        jp = tp = [1, 1]
    jcfg = jrt.EngineConfig(noise=jnm.NoiseConfig() if noise
                            else jnm.NO_NOISE)
    tcfg = trt.EngineConfig(noise=tnm.NoiseConfig() if noise
                            else tnm.NO_NOISE)
    return (jrt.plan_network(js, jcfg, ja, jp),
            trt.plan_network(ts, tcfg, ta, tp))


@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noise"))
@pytest.mark.parametrize("point", CHAIN, ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("net", ("lenet", "dense"))
def test_schedule_report_equal_jax(net, point, noise):
    jplan, tplan = _plans(net, point, noise)
    for kw in (dict(), dict(pipelined=False, gamma=4.0, clock_ns=7.5),
               dict(point="throughput")):
        want = jpm.schedule_report(jplan, **kw)
        got = tpm.schedule_report(tplan, **kw)
        assert got == want
    assert got["operating_point"]["name"] == "throughput"
    assert got["noise"]["enabled"] is noise
    assert ("noise" in got["layers"][0]) is noise


def test_perf_report_program_echo_equal_jax():
    """CIMProgram.perf_report: the schedule report plus the program's
    counters and bucket ladder, equal to JAX's on the counters both
    packages keep; the port adds its three graph counters."""
    import jax
    import numpy as np
    import torch
    specs = [dict(m=4, k=144, n=40, r_in=4, r_w=2),
             dict(m=4, k=40, n=10, r_in=4, r_w=2)]
    buckets = dict(min_bucket=2, max_bucket=8)
    jp = jprog.compile_program([jmap.LayerSpec(**s) for s in specs],
                               buckets=jprog.BatchBuckets(**buckets))
    tp = tprog.compile_program([tmap.LayerSpec(**s) for s in specs],
                               buckets=tprog.BatchBuckets(**buckets),
                               device="cpu")
    jst0, tst0 = jp.stats(), tp.stats()
    params = [{k: np.asarray(v) for k, v in lay.items()}
              for lay in jp.init_params(jax.random.PRNGKey(0))]
    tparams = params_from_numpy(params)
    jb, tb = jp.bind(params), tp.bind(tparams)
    x = np.random.default_rng(0).uniform(0, 1, (11, 144)).astype(np.float32)
    for rows in (3, 3, 11, 1):
        jb.serve(x[:rows])
        tb.serve(torch.from_numpy(x[:rows]))
    jp.run(params, x[:5])
    tp.run(tparams, torch.from_numpy(x[:5]))
    want = jp.perf_report(point="balanced")
    got = tp.perf_report(point="balanced")
    jecho, techo = want.pop("program"), got.pop("program")
    assert got == want
    assert techo["buckets"] == jecho["buckets"] == buckets
    shared = set(jecho) & set(techo)
    assert shared == set(jecho)
    assert {k: techo[k] - tst0.get(k, 0) for k in shared - {"buckets"}} == \
        {k: jecho[k] - jst0.get(k, 0) for k in shared - {"buckets"}}
    assert set(techo) - shared == {"graphs_captured", "graph_replays",
                                   "eager_calls"}
    assert techo["eager_calls"] - tst0["eager_calls"] == 5


@pytest.mark.parametrize("devices", (2, 4, 8))
@pytest.mark.parametrize("net", ("lenet", "dense"))
def test_sharded_schedule_report_equal_jax(net, devices):
    """A sharded plan's report - per-layer shard columns, the totals'
    macro_evals_total / macro_evals_per_device / parallel_efficiency and
    the "sharding" echo - equals JAX's exactly, with each layer's
    automatic kind and with every layer forced to the other kind (whose
    "tune" entry echoes the forced kind; its times are each card's
    model, held in tests/test_torch_tuner.py)."""
    jplan, tplan = _plans(net, (4, 2), False)
    jcfg = jplan.cfg.replace(sharding=jrt.ShardingConfig(devices=devices))
    tcfg = tplan.cfg.replace(sharding=trt.ShardingConfig(devices=devices))
    jspecs = [lp.spec for lp in jplan.layers]
    tspecs = [lp.spec for lp in tplan.layers]
    acts = [lp.activation for lp in tplan.layers]
    pools = [lp.pool for lp in tplan.layers]
    auto = trt.plan_network(tspecs, tcfg, acts, pools)
    other = [(None, "rows" if lp.shard.kind == "col" else "col")
             for lp in auto.layers]
    for sched in (None, other):
        want = jpm.schedule_report(jrt.plan_network(jspecs, jcfg, acts,
                                                    pools, schedule=sched))
        got = tpm.schedule_report(trt.plan_network(tspecs, tcfg, acts,
                                                   pools, schedule=sched))
        tunes = [(lt.pop("tune", None), lw.pop("tune", None))
                 for lt, lw in zip(got["layers"], want["layers"])]
        assert got == want
        for t, w in tunes:
            assert (t is None) == (w is None) == (sched is None)
            if t is not None:
                assert t["shard_kind"] == w["shard_kind"]
    assert got["sharding"] == {"devices": devices, "axis": "macro"}
    assert 0.0 < got["total"]["parallel_efficiency"] <= 1.0
    assert "sharding" not in tpm.schedule_report(tplan)


def test_tuned_plans_carry_tune_entry():
    """A plan carrying autotuned blocks is reported with the tuner's
    "tune" entry (tests/test_torch_tuner.py holds it against JAX's), and
    its other columns are the untuned plan's."""
    _, plan = _plans("dense", (4, 2), False)
    tuned = dataclasses.replace(
        plan, layers=(dataclasses.replace(plan.layers[0],
                                          blocks=("splitk", 0, 64, 40)),)
        + plan.layers[1:])
    rep = tpm.schedule_report(tuned)
    assert rep["layers"][0]["tune"]["blocks"] == ("splitk", 0, 64, 40)
    assert rep["layers"][0]["tune"]["shard_kind"] is None
    assert all("tune" not in lr for lr in rep["layers"][1:])
    assert {k: v for k, v in rep["layers"][0].items() if k != "tune"} == \
        tpm.schedule_report(plan)["layers"][0]


# ---- the macro-model cases of tests/test_hlo_and_perf.py, on the port ------

def test_cycle_model_regimes():
    """Eq. 9/10: deep-input layers are input-dominated; wide-output layers
    output-dominated."""
    deep = cycle_model(tmap.LayerSpec(m=1, k=9 * 512, n=16, r_in=8, r_w=4,
                                      kernel=(3, 3)))
    wide = cycle_model(tmap.LayerSpec(m=1, k=9 * 4, n=512, r_in=1, r_w=4,
                                      r_out=8, kernel=(3, 3)))
    assert deep.n_in > deep.n_out
    assert wide.n_out > wide.n_in


def test_energy_anchors():
    """Calibration targets from the paper (Sec. V / Table I)."""
    em = EnergyModel()
    s8 = tmap.LayerSpec(m=1, k=1152, n=256, r_in=8, r_w=1, r_out=8,
                        kernel=(3, 3))
    s1 = tmap.LayerSpec(m=1, k=1152, n=256, r_in=1, r_w=1, r_out=1,
                        kernel=(3, 3))
    assert abs(em.macro_tops_per_watt(s8) / 1e3 - 1.2) < 0.15     # 1.2 POPS/W
    assert abs(em.macro_tops_per_watt(s1) / 1e3 - 8.0) < 1.0      # 8 POPS/W
    s84 = tmap.LayerSpec(m=1, k=1152, n=64, r_in=8, r_w=4, r_out=8,
                         kernel=(3, 3))
    assert 120 < em.macro_tops_per_watt(s84, normalize_8b=True) < 180


def test_energy_split_dpl_savings():
    """Fig. 6(c): DP energy drops when fewer units are connected."""
    em = EnergyModel()
    assert em.e_dp_pj(1, 8) < 0.3 * em.e_dp_pj(32, 8)


def test_precision_scaling_quasi_linear():
    em = EnergyModel()
    effs = []
    for r in (1, 2, 4, 8):
        s = tmap.LayerSpec(m=1, k=1152, n=256, r_in=r, r_w=1, r_out=r,
                           kernel=(3, 3))
        effs.append(em.macro_tops_per_watt(s))
    assert effs[0] > effs[1] > effs[2] > effs[3]
    assert 4 < effs[0] / effs[3] < 10   # ~6.7x from 8b -> 1b


def test_eval_time_scales_with_precision():
    assert cim_eval_time_ns(1, 1, 1) < 0.25 * cim_eval_time_ns(8, 4, 8)
