"""The port's workload-adaptive precision serving against the JAX
package's `repro.precision`, on the same seeds.

Both packages draw the calibration's parameters, inputs and trial keys
from threefry (`core/prng` is JAX's PRNG bit for bit), so a variant's
outputs are equal bit for bit and what can differ is the MSE's
reduction: XLA sums the float32 squares in float32 in its own order, the
port in float64 and rounds the mean to float32.  The MSEs are held to
MSE_RTOL (1e-6 relative), the top-1 agreement and the base point's zero
exactly; `assign` is held bit for bit on a profile loaded from JAX's
JSON and on the hand-built profile of `tests/test_precision.py`, whose
cases have no near-tie.  The noisy calibration runs the JAX side under
`jax.disable_jit()` with float32 noise leaves (numpy scalars, which the
program cache can hash), as `tests/test_torch_noise.py` does: that is
the JAX source's rounded chain, which the port follows.
"""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import precision as jpr
from repro.core import mapping as jmap
from repro.core import noise_model as jnm
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro.runtime import scheduler as jsch
from repro_torch import precision as tpr
from repro_torch.convert import decode_lm_from_numpy
from repro_torch.core import mapping as tmap
from repro_torch.core import noise_model as tnm
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog
from repro_torch.runtime.scheduler import InflightScheduler


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MSE_RTOL = 1e-6
# tests/test_precision.py's chained net and reduced sweep
SPECS = (dict(m=4, k=32, n=16, r_in=8, r_w=4),
         dict(m=4, k=16, n=8, r_in=8, r_w=4))
POINTS = ((1, 1), (2, 2))
# the launcher's demo: four decode projections at d 48, d_ff 96
DEMO = dict(d=48, d_ff=96)
_JAX = {}


def _jspecs(specs):
    return tuple(jmap.LayerSpec(**s) for s in specs)


def _tspecs(specs):
    return tuple(tmap.LayerSpec(**s) for s in specs)


def _demo_specs():
    tspecs = tserve.precision_specs(**DEMO)
    jspecs = tuple(jmap.LayerSpec(m=s.m, k=s.k, n=s.n, r_in=s.r_in,
                                  r_w=s.r_w) for s in tspecs)
    return jspecs, tspecs


def _jax_demo_profile():
    """JAX's calibration of the launcher's demo (module-cached)."""
    if "demo" not in _JAX:
        jspecs, _ = _demo_specs()
        _JAX["demo"] = jpr.calibrate(jspecs, jrt.EngineConfig(), n_trials=2,
                                     batch=4, seed=0, label="serve-demo",
                                     cache_path="")
    return _JAX["demo"]


def _same_profile(got, want):
    """Equal but for the MSEs, which agree within MSE_RTOL; the base
    point's delta is exactly 0 in both."""
    g, w = got.to_dict(), want.to_dict()
    assert {k: v for k, v in g.items() if k != "layers"} == \
        {k: v for k, v in w.items() if k != "layers"}
    assert len(g["layers"]) == len(w["layers"])
    for gl, wl in zip(g["layers"], w["layers"]):
        assert gl["index"] == wl["index"]
        for (gi, gw, gm, ga), (wi, ww, wm, wa) in zip(gl["entries"],
                                                      wl["entries"]):
            assert (gi, gw, ga) == (wi, ww, wa)
            assert abs(gm - wm) <= MSE_RTOL * abs(wm), (gi, gw, gm, wm)
            if (gi, gw) == tuple(g["base"]):
                assert gm == wm == 0.0 and ga == 1.0


def _fake_profiles():
    # tests/test_precision.py's hand-built profile: layer 0 twice as
    # sensitive as layer 1
    def build(pr):
        return pr.SensitivityProfile(
            base=(8, 4), points=((1, 1), (2, 2), (8, 4)), n_trials=1,
            chained=True,
            layers=(pr.LayerSensitivity(0, ((1, 1, 8.0, 0.5),
                                            (2, 2, 2.0, 0.9),
                                            (8, 4, 0.0, 1.0))),
                    pr.LayerSensitivity(1, ((1, 1, 4.0, 0.6),
                                            (2, 2, 1.0, 0.95),
                                            (8, 4, 0.0, 1.0)))))
    return build(jpr), build(tpr)


# ---- parameters and keys ---------------------------------------------------

@pytest.mark.parametrize("net", ("dense", "lenet", "projections"))
def test_init_params_from_a_key_equal_jax(net):
    """CIMProgram.init_params(prng key) draws JAX's init_params(PRNGKey)
    bit for bit: one split per layer, scale * normal in float32."""
    if net == "lenet":
        from repro.core.cim_layers import CIMConfig as JCIM
        from repro.models import cnn as jcnn
        from repro_torch.core.cim_layers import CIMConfig as TCIM
        from repro_torch.models import cnn as tcnn
        jp = jcnn.lenet_program(8, cim=JCIM(r_in=4, r_w=2))
        tp = tcnn.lenet_program(8, cim=TCIM(r_in=4, r_w=2), device="cpu")
    elif net == "dense":
        jp = jprog.compile_program(_jspecs(SPECS))
        tp = tprog.compile_program(_tspecs(SPECS), device="cpu")
    else:
        jspecs, tspecs = _demo_specs()
        jp = jprog.compile_program(jspecs[2:3], activations=("none",))
        tp = tprog.compile_program(tspecs[2:3], activations=("none",),
                                   device="cpu")
    for seed, fold in ((0, 0), (3, 12), (7, 51)):
        want = jp.init_params(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 fold))
        got = tp.init_params(prng.fold_in(prng.key(seed), fold))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                a = np.asarray(w[k])
                assert g[k].dtype == torch.float32 and g[k].shape == a.shape
                assert np.array_equal(g[k].numpy().view(np.int32),
                                      a.view(np.int32)), (net, seed, k)


def test_profile_key_equal_jax():
    jspecs, tspecs = _demo_specs()
    from repro.models import cnn as jcnn
    from repro_torch.models import cnn as tcnn
    cases = [(_jspecs(SPECS), _tspecs(SPECS)), (jspecs, tspecs),
             (jcnn.lenet_engine_specs(8)[0], tcnn.lenet_engine_specs(8)[0])]
    for js, ts in cases:
        for noise in (False, True):
            jcfg = jrt.EngineConfig(noise=jnm.NoiseConfig(enabled=noise))
            tcfg = trt.EngineConfig(noise=tnm.NoiseConfig(enabled=noise))
            for args in ((jpr.PRECISION_CHAIN, 4, 8, 0, ""),
                         (POINTS + ((8, 4),), 2, 4, 11, "demo")):
                assert tpr.profile_key(ts, tcfg, *args) == \
                    jpr.profile_key(js, jcfg, *args)
    assert tpr.PRECISION_CHAIN == jpr.PRECISION_CHAIN
    assert tpr.BASE_POINT == jpr.BASE_POINT
    assert tpr.DEFAULT_BUDGETS == jpr.DEFAULT_BUDGETS


# ---- calibration -------------------------------------------------------------

def test_calibrate_chained_clean_equal_jax():
    kw = dict(points=POINTS, n_trials=1, batch=4, cache_path="")
    want = jpr.calibrate(_jspecs(SPECS), jrt.EngineConfig(), **kw)
    got = tpr.calibrate(_tspecs(SPECS), trt.EngineConfig(), device="cpu",
                        **kw)
    assert got.chained and got.n_trials == 1
    _same_profile(got, want)


def test_calibrate_independent_clean_equal_jax():
    """The four decode projections of the launcher's demo, each its own
    single-layer program, over the whole precision chain."""
    _, tspecs = _demo_specs()
    got = tpr.calibrate(tspecs, trt.EngineConfig(), n_trials=2, batch=4,
                        seed=0, label="serve-demo", cache_path="",
                        device="cpu")
    want = _jax_demo_profile()
    assert not got.chained and got.points == tpr.PRECISION_CHAIN
    _same_profile(got, want)


def test_calibrate_noisy_equal_jax():
    """Monte-Carlo calibration under NoiseConfig(), 2 trials over
    split(fold_in(key, 2), 2): the JAX side eager with float32 leaves."""
    nz = jnm.NoiseConfig()
    leaves = nz.replace(**{f: np.float32(getattr(nz, f))
                           for f in tnm.LEAF_FIELDS})
    kw = dict(points=((1, 1),), n_trials=2, batch=4, seed=5, cache_path="")
    with jax.disable_jit():
        want = jpr.calibrate(_jspecs(SPECS), jrt.EngineConfig(noise=leaves),
                             **kw)
    got = tpr.calibrate(_tspecs(SPECS),
                        trt.EngineConfig(noise=tnm.NoiseConfig()),
                        device="cpu", **kw)
    assert got.n_trials == 2 and got.delta(0, (1, 1)) > 0
    _same_profile(got, want)


# ---- the profile cache -------------------------------------------------------

def test_profile_cache_files_cross_packages(tmp_path):
    """A file JAX's ProfileCache wrote is a hit for the port (and the
    profile is JAX's exactly), and the reverse."""
    kw = dict(points=POINTS, n_trials=1, batch=4)
    path = str(tmp_path / "jax.json")
    want = jpr.calibrate(_jspecs(SPECS), jrt.EngineConfig(), cache_path=path,
                         label="cross", **kw)
    n0 = tpr.CALIBRATION_RUNS["n"]
    got = tpr.calibrate(_tspecs(SPECS), trt.EngineConfig(), cache_path=path,
                        label="cross", device="cpu", **kw)
    assert tpr.CALIBRATION_RUNS["n"] == n0
    assert got.to_dict() == want.to_dict()

    path = str(tmp_path / "port.json")
    mine = tpr.calibrate(_tspecs(SPECS), trt.EngineConfig(), cache_path=path,
                         label="cross", device="cpu", **kw)
    assert tpr.CALIBRATION_RUNS["n"] == n0 + 1
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    assert raw["schema"] == 1 and list(raw["entries"]) == [
        jpr.profile_key(_jspecs(SPECS), jrt.EngineConfig(),
                        POINTS + ((8, 4),), 1, 4, 0, "cross")]
    j0 = jpr.CALIBRATION_RUNS["n"]
    theirs = jpr.calibrate(_jspecs(SPECS), jrt.EngineConfig(),
                           cache_path=path, label="cross", **kw)
    assert jpr.CALIBRATION_RUNS["n"] == j0
    assert theirs.to_dict() == mine.to_dict()


@pytest.mark.parametrize("content", ("{not json", json.dumps(
    {"schema": -1, "entries": {}}), json.dumps({"schema": 1})),
    ids=("corrupt", "schema", "no_entries"))
def test_profile_cache_bad_file_warns_once_and_never_writes(tmp_path,
                                                            content):
    path = tmp_path / "profiles.json"
    path.write_text(content, encoding="utf-8")
    n0 = tpr.CALIBRATION_RUNS["n"]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        prof = tpr.calibrate(_tspecs(SPECS), trt.EngineConfig(),
                             points=POINTS, n_trials=1, batch=4,
                             cache_path=str(path), label="bad",
                             device="cpu")
    assert [type(w.message) for w in rec] == [tpr.ProfileCacheWarning]
    assert tpr.CALIBRATION_RUNS["n"] == n0 + 1
    assert prof.delta(0, tpr.BASE_POINT) == 0.0
    assert path.read_text(encoding="utf-8") == content
    assert not (tmp_path / "profiles.json.tmp").exists()


def test_default_profile_path_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PRECISION_PROFILES", str(tmp_path / "p.json"))
    assert tpr.default_profile_path() == jpr.default_profile_path() \
        == str(tmp_path / "p.json")


# ---- the planner and the ladder ---------------------------------------------

def test_assign_equal_jax_on_hand_built_and_loaded_profiles():
    """assign is bit for bit JAX's: on the hand-built profile (with its
    nesting across budgets) and on JAX's calibrated demo profile loaded
    from its JSON."""
    jprof, tprof = _fake_profiles()
    jspecs, tspecs = _jspecs(SPECS), _tspecs(SPECS)
    rank = {p: i for i, p in enumerate(tprof.points)}
    prev = None
    for frac in (1.0, 0.6, 0.5, 0.25, 0.2, 0.1, 0.02, 0.0):
        got = tpr.assign(tprof, tspecs, frac)
        assert got == jpr.assign(jprof, jspecs, frac)
        if prev is not None:
            assert all(rank[a] >= rank[b] for a, b in zip(got[0], prev))
        prev = got[0]
    with pytest.raises(ValueError, match=">= 0"):
        tpr.assign(tprof, tspecs, -0.1)
    with pytest.raises(ValueError, match="covers 2 layers"):
        tpr.assign(tprof, tspecs[:1], 0.5)

    jdemo = _jax_demo_profile()
    loaded = tpr.SensitivityProfile.from_dict(
        json.loads(json.dumps(jdemo.to_dict())))
    jspecs, tspecs = _demo_specs()
    for frac in (0.0, 0.02, 0.05, 0.2, 0.4, 0.6, 1.0):
        assert tpr.assign(loaded, tspecs, frac) == \
            jpr.assign(jdemo, jspecs, frac)


def test_plan_ladder_report_equal_jax_and_rungs_serve_exactly():
    """plan_ladder's report (assignments, allowances, predicted deltas,
    the macro model's time and TOPS/W) equals JAX's; every rung of the
    port's ladder serves bit for bit equal to its reference."""
    jprof, tprof = _fake_profiles()
    jl = jpr.plan_ladder(jprof, _jspecs(SPECS), jrt.EngineConfig())
    tl = tpr.plan_ladder(tprof, _tspecs(SPECS), trt.EngineConfig(),
                         device="cpu")
    assert tl.names() == jl.names() == tuple(tpr.DEFAULT_BUDGETS)
    assert tl.report() == jl.report()
    for name in tl.names():
        assert tl.specs_for(name) == _tspecs(
            [dict(s, r_in=p[0], r_w=p[1])
             for s, p in zip(SPECS, tl.point(name).assignment)])
        prog = tl.program(name)
        params = prog.init_params(prng.key(3))
        x = torch.relu(prng.normal(prng.key(4), (4, SPECS[0]["k"]))) + 0.1
        out = prog.serve(params, x, point=name)
        assert torch.equal(out, prog.serve(params, x, reference=True,
                                           point=name)), name
        bound = prog.bind(params)
        assert torch.equal(bound.serve(x, point=name), out)
        assert torch.equal(bound.reference(x, point=name), out)
    with pytest.raises(ValueError, match="unknown operating point"):
        tl.point("nope")


def test_point_report_equal_jax():
    """InflightScheduler.point_report over a toy CIMDecodeLM whose masters
    crossed from JAX: the macro model's projection of each point, and the
    program echo on the counters both packages keep."""
    d, d_ff, heads = 40, 72, 4
    points = {"quality": ((4, 4), (4, 4), (2, 2), (4, 4)),
              "throughput": ((1, 1), (2, 2), (1, 1), (2, 2))}
    key = jax.random.PRNGKey(9)
    jmodel = jsch.CIMDecodeLM.toy(key, d=d, depth=1, vocab=23, d_ff=d_ff,
                                  r_in=8, r_w=4, points=points)
    # the same masters as numpy: toy's key schedule (block b folds 100+b)
    kb = jax.random.fold_in(key, 100)
    base = jmodel.blocks[0]
    heads_of = {"qkv": (("q", d), ("k", d), ("v", d)),
                "gate_up": (("gate", d_ff), ("up", d_ff))}
    shared = {"qkv": base.qkv.shared, "gate_up": base.gate_up.shared}
    m = {}
    for j, name in enumerate(("qkv", "o", "gate_up", "down")):
        sub = jax.random.fold_in(kb, j)
        if name in shared:
            for h, p in shared[name].init_params(sub).items():
                m[h] = {k: np.asarray(v) for k, v in p.items()}
        else:
            prog = getattr(base, name).program
            (p,) = prog.init_params(sub)
            m[name] = {k: np.asarray(v) for k, v in p.items()}
    assert set(m) == {h for hs in heads_of.values() for h, _ in hs} \
        | {"o", "down"}
    embed = np.asarray(jmodel.embed)
    tmodel = decode_lm_from_numpy(embed, [m], n_heads=heads, r_in=8, r_w=4,
                                  points=points, device="cpu")
    jsched = jsch.InflightScheduler(jmodel, capacity=4)
    tsched = InflightScheduler(tmodel, capacity=4)
    for pt in ("", "quality", "throughput"):
        want = jsched.point_report(pt)
        got = tsched.point_report(pt)
        jecho, techo = want.pop("program"), got.pop("program")
        assert got == want, pt
        assert got["operating_point"]["name"] == pt
        assert {k: techo[k] for k in jecho} == jecho
    tops = [tsched.point_report(p)["operating_point"]["tops_per_w"]
            for p in ("", "quality", "throughput")]
    assert tops[0] < tops[1] < tops[2]


# ---- the launcher ------------------------------------------------------------

def test_serve_precision_policy_cli(monkeypatch, tmp_path, capsys):
    """`launch/serve.py --precision-policy mixed --assert-no-recompile
    --device cpu` passes (fused == solo, no growth after warm-up) and
    prints the assignments JAX's calibrate + assign give for the seed;
    a second run hits the profile cache."""
    monkeypatch.setenv("REPRO_PRECISION_PROFILES",
                       str(tmp_path / "profiles.json"))
    argv = ["--arch", "olmo-1b", "--cim-mode", "engine", "--inflight",
            "--precision-policy", "mixed", "--assert-no-recompile",
            "--device", "cpu"]
    n0 = tpr.CALIBRATION_RUNS["n"]
    out = tserve.main(argv)
    text = capsys.readouterr().out
    assert tpr.CALIBRATION_RUNS["n"] == n0 + 1
    jprof = _jax_demo_profile()
    jspecs, _ = _demo_specs()
    for name in ("quality", "throughput"):
        asg, _ = jpr.assign(jprof, jspecs, jpr.DEFAULT_BUDGETS[name])
        assert out["points"][name] == asg
        assert f"precision: point {name!r} -> {list(asg)}" in text
    assert "per-request bit-exactness vs solo decode: PASS" in text
    assert "plans=0 captures=0" in text
    assert out["growth"] == {"plans": 0, "captures": 0, "binds": 0}
    assert set(out["metrics"]["tokens_by_point"]) == {"quality",
                                                      "throughput"}
    assert out["tops_per_w"]["quality"] < out["tops_per_w"]["throughput"]
    again = tserve.main(argv)
    assert tpr.CALIBRATION_RUNS["n"] == n0 + 1
    assert again["points"] == out["points"]
    assert again["streams"] == out["streams"]


def test_serve_precision_policy_needs_engine_inflight():
    for extra in (["--cim-mode", "engine"], ["--inflight"]):
        with pytest.raises(SystemExit) as exc:
            tserve.main(["--arch", "olmo-1b", "--precision-policy", "mixed",
                         "--device", "cpu"] + extra)
        assert exc.value.code == 2
