"""The port's sharded multi-macro engine against the JAX package.

JAX runs its sharded engine on a bank of devices faked on one host
(`--xla_force_host_platform_device_count`), which tier-1's one-device
process does not have, so its sharded dispatch is not run here.  What is
held, on the CPU with meshes folded onto the host
(`ShardingConfig(fold_onto="cpu")`), the port's counterpart of that
flag:

  * against JAX's numbers (its planning and costing need no devices):
    `shard_layer`, `LayerPlan.shard`, `schedule_report`'s shard columns,
    `layer_cost(devices=D)`'s macro and collective terms, the calibration
    key;
  * against JAX's unsharded engine (Pallas interpret mode) and its
    reference oracle (noisy: eager, float32 leaves, as
    tests/test_torch_noise.py), bit for bit: the port's sharded engine ==
    its unsharded engine == JAX's, clean and under a fixed key, for
    D in {1, 2, 3, 8} and both kinds (uneven col and rows splits, stream
    chunking, conv layers, the engine-mode layer, bucketed serves, the
    tuner's forced kinds);
  * fused in-flight decode == sequential decode at D = 8, one point and
    mixed points, clean and noisy, and equal to the unsharded streams;
  * `kv_repeat_to` against JAX's attention block, and
    `flash_attention_sharded` against `flash_attention` through the
    kernels' plain versions.

Sizes follow tests/test_engine_sharding.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_layers as jcl
from repro.core import mapping as jmap
from repro.core import noise_model as jnm
from repro.models import common as jcm
from repro.perfmodel import macro_perf as jpm
from repro.precision import sensitivity as jsens
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro.tuner import cost as jcost
from repro_torch.convert import params_from_numpy
from repro_torch.core import cim_layers as tcl
from repro_torch.core import mapping as tmap
from repro_torch.core import prng
from repro_torch.core.hw import H100_SXM
from repro_torch.core.noise_model import LEAF_FIELDS, NoiseConfig
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_sharded,
                                                sharded_pieces)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import cnn as tcnn
from repro_torch.models import common as tcm
from repro_torch.models import sharding as tsh
from repro_torch.perfmodel import macro_perf as tpm
from repro_torch.precision import sensitivity as tsens
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog
from repro_torch.runtime.scheduler import (CIMDecodeLM, InflightScheduler,
                                           Request, decode_sequential)
from repro_torch.tuner import cost as tcost
from repro_torch.tuner import search as tsearch

SC = trt.ShardingConfig


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it.  Its sharded schedules run thousands of tiny CPU ops; where
    pytest-xdist workers share the cores, each op's thread pool spins at
    its barrier (one case here took 199 s on the default threads against
    11 s on one, with eight busy processes beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def folded(devices: int, **kw) -> trt.ShardingConfig:
    return SC(devices=devices, fold_onto="cpu", **kw)


def seeded_params(dims, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in dims]


def relu_x(m, k, seed):
    return np.maximum(np.random.default_rng(seed).normal(size=(m, k)),
                      0).astype(np.float32)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def jax_serve(specs, params, x, noise=False, key=3, **cfg_kw):
    """JAX's unsharded engine on the same layers: the bound program's
    serve (Pallas interpret mode) clean, its reference oracle run eagerly
    with float32 noise leaves under PRNGKey(key) when noisy."""
    jspecs = [jmap.LayerSpec(**dataclasses.asdict(s)) for s in specs]
    if not noise:
        jp = jprog.compile_program(jspecs, jrt.EngineConfig(**cfg_kw),
                                   activations=["none"] * len(specs))
        return np.asarray(jp.bind(params).serve(jnp.asarray(x)))
    jn = jnm.NoiseConfig()
    jp = jprog.compile_program(jspecs, jrt.EngineConfig(noise=jn, **cfg_kw),
                               activations=["none"] * len(specs))
    f32 = jn.replace(**{f: jnp.float32(getattr(jn, f)) for f in LEAF_FIELDS})
    bound = jp.bind(params)             # jitted, as the serving bind
    with jax.disable_jit():
        return np.asarray(bound.reference(jnp.asarray(x),
                                          jax.random.PRNGKey(key), f32))


def port_pair(specs, devices, *, noise=False, acts=None, pools=None,
              stream_rows=0, kinds=None):
    """(unsharded, sharded) port programs over the same specs on the CPU;
    `kinds` forces each layer's shard kind."""
    base = trt.EngineConfig(stream_rows=stream_rows)
    if noise:
        base = base.replace(noise=NoiseConfig())
    p1 = tprog.compile_program(specs, base, activations=acts, pools=pools,
                               device="cpu")
    cfg = base.replace(sharding=folded(devices))
    if kinds is None:
        pd = tprog.compile_program(specs, cfg, activations=acts, pools=pools,
                                   device="cpu")
    else:
        plan = trt.plan_network(specs, cfg, acts, pools,
                                schedule=[(None, k) for k in kinds])
        pd = tprog.program_for_plan(plan, device="cpu")
    return p1, pd


def assert_sharded_equal(p1, pd, params, x, key=None):
    """sharded serve == unsharded serve == the sharded program's reference
    (the serial oracle), bit for bit; returns the result."""
    xt = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    y1 = p1.bind(params).serve(xt, key)
    bd = pd.bind(params)
    yd = bd.serve(xt, key)
    assert torch.equal(yd, y1)
    assert torch.equal(yd, bd.reference(xt, key))
    return yd


# ---- shard planning against JAX's numbers --------------------------------

SHAPES = [dict(m=24, k=144, n=320, r_in=4, r_w=4),
          dict(m=5, k=2304, n=16, r_in=4, r_w=2),
          dict(m=130, k=1300, n=700, r_in=8, r_w=1),
          dict(m=1, k=9, n=10, r_in=2, r_w=2)]


@pytest.mark.parametrize("kind", (None, "col", "rows"))
@pytest.mark.parametrize("devices", (1, 2, 3, 4, 8))
def test_shard_layer_equals_jax(devices, kind):
    for s in SHAPES:
        js, ts = jmap.LayerSpec(**s), tmap.LayerSpec(**s)
        want = jmap.shard_layer(js, jmap.map_layer(js), devices, kind=kind)
        got = tmap.shard_layer(ts, tmap.map_layer(ts), devices, kind=kind)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), s


def test_shard_layer_validation_and_heuristic():
    spec = tmap.LayerSpec(m=24, k=144, n=320, r_in=4, r_w=4)   # 5 col tiles
    mp = tmap.map_layer(spec)
    col = tmap.shard_layer(spec, mp, 2)
    assert (col.kind, col.tiles_per_device) == ("col", 3)
    assert col.efficiency == pytest.approx(5 / 6)
    rows = tmap.shard_layer(spec, mp, 8)
    assert (rows.kind, rows.rows_per_device, rows.efficiency) == \
        ("rows", 3, 1.0)
    with pytest.raises(ValueError, match="devices"):
        tmap.shard_layer(spec, mp, 0)
    with pytest.raises(ValueError, match="shard kind"):
        tmap.shard_layer(spec, mp, 2, kind="diagonal")
    assert tmap.split_even_slices(130, 3) == [(0, 44), (44, 44), (88, 44)]


@pytest.mark.parametrize("devices", (1, 2, 4, 8))
def test_plan_shard_equals_jax(devices):
    dims = (2000, 300, 70, 10)
    kw = dict(m=4, r_in=4, r_w=2)
    jspecs = [jmap.LayerSpec(k=k, n=n, **kw)
              for k, n in zip(dims[:-1], dims[1:])]
    tspecs = [tmap.LayerSpec(k=k, n=n, **kw)
              for k, n in zip(dims[:-1], dims[1:])]
    for sched in (None, [(None, "col"), (None, "rows"), None]):
        jp = jrt.plan_network(jspecs, jrt.EngineConfig(
            sharding=jrt.ShardingConfig(devices=devices)), schedule=sched)
        tp = trt.plan_network(tspecs, trt.EngineConfig(
            sharding=SC(devices=devices)), schedule=sched)
        for jl, tl in zip(jp.layers, tp.layers):
            assert dataclasses.asdict(tl.shard) == \
                dataclasses.asdict(jl.shard)
            assert (tl.n_slices, tl.tile_n, tl.n_pad) == \
                (jl.n_slices, jl.tile_n, jl.n_pad)
            assert len({sz for _, sz in tl.n_slices}) == 1
    assert trt.plan_network(tspecs).layers[0].shard is None
    with pytest.raises(ValueError, match="requires cfg.sharding"):
        trt.plan_layer(tspecs[0], shard_kind="col")


@pytest.mark.parametrize("devices", (2, 4, 8))
def test_schedule_report_shard_columns_equal_jax(devices):
    specs = [dict(m=8, k=144, n=80, r_in=4, r_w=4),
             dict(m=8, k=80, n=320, r_in=4, r_w=4),
             dict(m=8, k=320, n=32, r_in=2, r_w=2)]
    sched = [None, (None, "rows"), (None, "col")]
    jp = jrt.plan_network([jmap.LayerSpec(**s) for s in specs],
                          jrt.EngineConfig(sharding=jrt.ShardingConfig(
                              devices=devices)), schedule=sched)
    tp = trt.plan_network([tmap.LayerSpec(**s) for s in specs],
                          trt.EngineConfig(sharding=folded(devices)),
                          schedule=sched)
    want, got = jpm.schedule_report(jp), tpm.schedule_report(tp)
    assert got["sharding"] == want["sharding"]
    for f in ("macro_evals", "macro_evals_total", "macro_evals_per_device",
              "parallel_efficiency", "time_s", "energy_j", "tops_per_w"):
        assert got["total"][f] == want["total"][f], f
    for jl, tl in zip(want["layers"], got["layers"]):
        assert tl["shard"] == jl["shard"]
        assert ("tune" in tl) == ("tune" in jl)
        if "tune" in tl:
            assert tl["tune"]["shard_kind"] == jl["tune"]["shard_kind"]
    plain = tpm.schedule_report(trt.plan_network(
        [tmap.LayerSpec(**s) for s in specs]))
    assert "sharding" not in plain and "shard" not in plain["layers"][0]


MACRO_FIELDS = ("macro_evals", "macro_evals_per_device", "adc_conversions",
                "t_macro_s", "collective_bytes")


@pytest.mark.parametrize("devices", (2, 4, 8))
def test_layer_cost_sharded_equals_jax(devices):
    """The macro and collective terms equal JAX's for both kinds and the
    heuristic one; the all-gather is priced over NVLink across cards and
    over the card's memory folded onto one, whose partitions also add up
    on the card."""
    for s in SHAPES:
        js, ts = jmap.LayerSpec(**s), tmap.LayerSpec(**s)
        for kind in (None, "col", "rows"):
            want = jcost.layer_cost(js, jcost.ScheduleChoice(64, 64, 256,
                                                             kind),
                                    devices=devices)
            choice = tsearch.heuristic_choice(ts, trt.EngineConfig())
            choice = dataclasses.replace(choice, shard_kind=kind)
            got = tcost.layer_cost(ts, choice, devices=devices)
            fold = tcost.layer_cost(ts, choice, devices=devices, folded=True)
            for f in MACRO_FIELDS:
                assert getattr(got, f) == getattr(want, f), (s, kind, f)
                assert getattr(fold, f) == getattr(want, f), (s, kind, f)
            assert got.t_collective_s == \
                got.collective_bytes / H100_SXM.nvlink_bw
            assert fold.t_collective_s == \
                got.collective_bytes / H100_SXM.hbm_bw
            assert fold.dma_bytes == devices * got.dma_bytes
            assert fold.t_dma_s == pytest.approx(devices * got.t_dma_s)
            assert got.total_s == max(got.t_macro_s, got.t_dma_s,
                                      got.t_collective_s)


def test_calibration_key_equals_jax():
    specs = [dict(m=8, k=144, n=80, r_in=4, r_w=4)]
    for devices in (0, 1, 4):
        jcfg = jrt.EngineConfig(sharding=jrt.ShardingConfig(devices=devices)
                                if devices else None)
        tcfg = trt.EngineConfig(sharding=SC(devices=devices)
                                if devices else None)
        args = (((4, 4), (2, 2)), 4, 8, 0, "x")
        assert tsens.profile_key([tmap.LayerSpec(**s) for s in specs], tcfg,
                                 *args) == \
            jsens.profile_key([jmap.LayerSpec(**s) for s in specs], jcfg,
                              *args)


# ---- meshes ------------------------------------------------------------------

def test_engine_mesh_placement():
    m = tmesh.make_engine_mesh(1, device="cpu")
    assert m.devices == (torch.device("cpu"),) and m.folded
    m8 = tmesh.make_engine_mesh(8, "macro", device="cpu", fold_onto="cpu")
    assert m8.size == 8 and m8.folded and m8.axis_names == ("macro",)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_engine_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="fold onto the program's device"):
        tmesh.make_engine_mesh(2, device="cpu", fold_onto="meta")
    if not torch.cuda.is_available():
        host = tmesh.make_host_mesh()
        assert (host.devices, host.shape) == ((torch.device("cpu"),), (1, 1))
    h = tmesh.make_mesh((2, 4), ("data", "model"), fold_onto="cpu")
    assert (h.axis_size("data"), h.axis_size("model"), h.axis_size("pod")) \
        == (2, 4, 1)


def test_model_sharding_helpers():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert tsh.mesh_spec("data", None) is None and tsh.axis_size("model") == 1
    assert tsh.shard(x, tsh.BATCH, None, tsh.TP) is x
    with tsh.use_mesh(tmesh.make_mesh((2, 4), ("data", "model"),
                                      fold_onto="cpu")):
        assert tsh.axis_size("model") == 4 and tsh.axis_size("pod") == 1
        # the largest dividing prefix: 4 does not divide 3 rows
        assert tsh.mesh_spec(tsh.BATCH, "model", "model",
                             shape=x.shape) == (("data",), None, "model")
        assert tsh.shard(x, tsh.BATCH, None, tsh.TP) is x
    spread = tmesh.DeviceMesh((torch.device("cpu"), torch.device("meta")),
                              (2,), ("data",))
    with tsh.use_mesh(spread):
        with pytest.raises(NotImplementedError, match="fold"):
            tsh.shard(x, tsh.BATCH, None, None)
        assert tsh.shard(x, None, None, tsh.TP) is x
    assert tsh.get_mesh() is None


# ---- the sharded engine, bit for bit ------------------------------------

@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noisy"))
def test_mesh_of_one_degenerate(noise):
    """D = 1 on the default placement (the host's one device) still runs
    the sharded schedule, equal to the unsharded port, and clean to JAX's
    (the noisy JAX chain is held at D 2, 3 and 8 below)."""
    specs = [tmap.LayerSpec(m=8, k=144, n=80, r_in=4, r_w=4),
             tmap.LayerSpec(m=8, k=80, n=32, r_in=4, r_w=4)]
    p = seeded_params([(144, 80), (80, 32)], 0)
    x = relu_x(8, 144, 1)
    base = trt.EngineConfig(noise=NoiseConfig()) if noise \
        else trt.EngineConfig()
    acts = ["none"] * len(specs)
    p1 = tprog.compile_program(specs, base, activations=acts, device="cpu")
    pd = tprog.compile_program(specs, base.replace(sharding=SC(devices=1)),
                               activations=acts, device="cpu")
    key = prng.key(3) if noise else None
    got = assert_sharded_equal(p1, pd, params_from_numpy(p), x, key)
    if not noise:
        assert np.array_equal(bits(got.numpy()), bits(jax_serve(specs, p, x)))
    assert pd.plan.layers[0].shard.devices == 1


def test_sharding_wants_more_devices_than_visible():
    """Planning takes any D; binding a program whose placement has fewer
    devices raises ValueError naming them (the host has one)."""
    prog = tprog.compile_program(
        [tmap.LayerSpec(m=4, k=72, n=16, r_in=4, r_w=2)],
        trt.EngineConfig(sharding=SC(devices=2)), device="cpu")
    params = prog.init_params(prng.key(0))
    with pytest.raises(ValueError, match="devices"):
        prog.bind(params).serve(torch.ones(4, 72))
    with pytest.raises(ValueError, match="devices"):
        prog.run(params, torch.ones(4, 72))


@pytest.mark.parametrize("devices", (2, 8))
@pytest.mark.parametrize("r_in", (1, 2, 4, 8))
def test_lenet_grid_sharded_bitexact(r_in, devices):
    """The whole LeNet plan (conv layers, pools, dense), sharded, equals
    the unsharded engine bit for bit across the r_w grid, clean."""
    for r_w in (1, 2, 4):
        specs, acts, pools = tcnn.lenet_engine_specs(
            2, h=12, w=12, cim=tcl.CIMConfig(r_in=r_in, r_w=r_w))
        p1, pd = port_pair(specs, devices, acts=acts, pools=pools)
        params = p1.init_params(prng.key(r_in * 10 + r_w))
        x = torch.rand((2, 12, 12, 1),
                       generator=torch.Generator().manual_seed(2))
        assert_sharded_equal(p1, pd, params, x)


def test_lenet_sharded_equals_jax():
    """One grid point against JAX's unsharded LeNet program."""
    from repro.models import cnn as jcnn
    cim = dict(r_in=4, r_w=2)
    specs, acts, pools = tcnn.lenet_engine_specs(2, h=12, w=12,
                                                 cim=tcl.CIMConfig(**cim))
    p1, pd = port_pair(specs, 8, acts=acts, pools=pools)
    jspecs, _, _ = jcnn.lenet_engine_specs(2, h=12, w=12,
                                           cim=jcl.CIMConfig(**cim))
    dims = [(s.k, s.n) for s in specs]
    p = seeded_params(dims, 4)
    x = np.random.default_rng(2).uniform(size=(2, 12, 12, 1)).astype(
        np.float32)
    got = assert_sharded_equal(p1, pd, params_from_numpy(p), x)
    jp = jprog.compile_program(jspecs, jrt.EngineConfig(), activations=acts,
                               pools=pools)
    want = np.asarray(jp.bind(p).serve(jnp.asarray(x)))
    assert np.array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("devices", (2, 3, 8))
def test_lenet_sharded_noise_fixed_key(devices):
    specs, acts, pools = tcnn.lenet_engine_specs(
        2, h=12, w=12, cim=tcl.CIMConfig(r_in=4, r_w=2))
    p1, pd = port_pair(specs, devices, noise=True, acts=acts, pools=pools)
    params = p1.init_params(prng.key(0))
    x = torch.rand((2, 12, 12, 1), generator=torch.Generator().manual_seed(2))
    yd = assert_sharded_equal(p1, pd, params, x, prng.key(5))
    bd = pd.bind(params)
    assert torch.equal(yd, bd.serve(x, prng.key(5)))
    assert not torch.equal(yd, bd.serve(x, prng.key(6)))


@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noisy"))
@pytest.mark.parametrize("n", (320, 130))
def test_uneven_col_tile_device_split(n, noise):
    """5 col tiles (n 320) or 3 with padded columns inside the uniform
    tiles (n 130) over D in {2, 3, 8}, both kinds forced, equal to the
    unsharded port, and to JAX's unsharded engine (noisy: at n 130)."""
    specs = [tmap.LayerSpec(m=8, k=144, n=n, r_in=4, r_w=4)]
    p = seeded_params([(144, n)], 3)
    x = relu_x(8, 144, 1)
    key = prng.key(9) if noise else None
    for devices in (2, 3, 8):
        for kinds in (None, ["col"], ["rows"]):
            p1, pd = port_pair(specs, devices, noise=noise, acts=["none"],
                               kinds=kinds)
            got = assert_sharded_equal(p1, pd, params_from_numpy(p), x, key)
    if not noise or n == 130:
        assert np.array_equal(bits(got.numpy()),
                              bits(jax_serve(specs, p, x, noise, key=9)))


@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noisy"))
def test_uneven_rows_kind(noise):
    """The rows kind with M = 5 over D in {2, 3, 8} (zero-padded rows,
    partitions of padding only), two row tiles (K 2304)."""
    specs = [tmap.LayerSpec(m=5, k=2304, n=16, r_in=4, r_w=2)]
    p = seeded_params([(2304, 16)], 4)
    x = relu_x(5, 2304, 1)
    key = prng.key(13) if noise else None
    for devices in (2, 3, 8):
        p1, pd = port_pair(specs, devices, noise=noise, acts=["none"])
        assert pd.plan.layers[0].shard.kind == "rows"
        got = assert_sharded_equal(p1, pd, params_from_numpy(p), x, key)
    assert np.array_equal(bits(got.numpy()),
                          bits(jax_serve(specs, p, x, noise, key=13)))


def test_stream_chunking_bit_invariant_under_noise():
    specs = [tmap.LayerSpec(m=16, k=72, n=16, r_in=4, r_w=2)]
    x = torch.from_numpy(relu_x(16, 72, 1))
    outs = []
    for stream_rows in (0, 4, 7):
        prog = tprog.compile_program(
            specs, trt.EngineConfig(noise=NoiseConfig(),
                                    stream_rows=stream_rows), device="cpu")
        outs.append(prog.bind(prog.init_params(prng.key(0))).serve(
            x, prng.key(2)))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("devices", (2, 8))
def test_sharded_streaming_composition(devices):
    """stream_rows chunking inside each partition, both kinds, noisy."""
    specs = [tmap.LayerSpec(m=12, k=144, n=320, r_in=4, r_w=4),
             tmap.LayerSpec(m=12, k=320, n=16, r_in=4, r_w=4)]
    p1, pd = port_pair(specs, devices, noise=True, stream_rows=5)
    params = p1.init_params(prng.key(0))
    assert_sharded_equal(p1, pd, params, relu_x(12, 144, 1), prng.key(21))


@pytest.mark.parametrize("devices", (2, 8))
def test_cim_layers_engine_mode_sharded(devices):
    """CIMConfig.sharding threads through the engine-mode linear and conv
    layers; both equal their unsharded runs and JAX's."""
    cfg = tcl.CIMConfig(mode="engine", r_in=4, r_w=4)
    p = seeded_params([(144, 320)], 0)[0]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = np.random.default_rng(1).normal(size=(8, 144)).astype(np.float32)
    y1 = tcl.cim_linear_apply(tp, torch.from_numpy(x), cfg)
    yd = tcl.cim_linear_apply(tp, torch.from_numpy(x),
                              cfg.replace(sharding=folded(devices)))
    assert torch.equal(yd, y1)
    jy = jcl.cim_linear_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x),
                              jcl.CIMConfig(mode="engine", r_in=4, r_w=4))
    assert np.array_equal(bits(yd.numpy()), bits(jy))
    conv = tcl.CIMConfig(mode="engine", r_in=4, r_w=2)
    cp = tcnn.init_lenet(prng.key(1), cim=conv)["conv2"]
    xc = torch.rand((2, 6, 6, 16), generator=torch.Generator().manual_seed(3))
    c1 = tcl.cim_conv2d_apply(cp, xc, conv, padding=1)
    cd = tcl.cim_conv2d_apply(cp, xc, conv.replace(sharding=folded(devices)),
                              padding=1)
    assert torch.equal(cd, c1)


@pytest.mark.parametrize("devices", (1, 8))
def test_bucketed_serve_bitexact_sharded(devices):
    """A sharded program's bucketed serve (ragged extents on the ladder,
    isolated serve_batch) equals the unsharded unbucketed run; the
    dispatch keys carry D."""
    specs = [tmap.LayerSpec(m=8, k=144, n=320, r_in=4, r_w=4),
             tmap.LayerSpec(m=8, k=320, n=16, r_in=4, r_w=4)]
    p1, pd = port_pair(specs, devices)
    params = p1.init_params(prng.key(0))
    b1, bd = p1.bind(params), pd.bind(params)
    for m in (1, 3, 5, 8):
        x = torch.from_numpy(relu_x(m, 144, m))
        assert torch.equal(bd.serve(x), p1.run(params, x))
    reqs = [torch.from_numpy(relu_x(m, 144, 10 + m)) for m in (2, 3)]
    for got, want in zip(bd.serve_batch(reqs, isolate=True),
                         b1.serve_batch(reqs, isolate=True)):
        assert torch.equal(got, want)
    assert {k[4] for k in pd._shapes} == {devices}
    _, pn = port_pair(specs, devices, noise=True)
    xn = torch.from_numpy(relu_x(5, 144, 7))
    bn = pn.bind(params)
    assert torch.equal(bn.serve(xn, prng.key(4)),
                       bn.reference(xn, prng.key(4)))


# ---- the tuner ------------------------------------------------------------

@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noisy"))
@pytest.mark.parametrize("kind", ("col", "rows"))
def test_sharded_kind_override_bitexact(kind, noise):
    """Forcing either shard kind with a tuned tile on a 4-partition plan
    leaves every bit of the output as the untuned unsharded program's."""
    specs = [tmap.LayerSpec(m=8, k=144, n=320, r_in=4, r_w=4),
             tmap.LayerSpec(m=8, k=320, n=64, r_in=4, r_w=4)]
    base = trt.EngineConfig(noise=NoiseConfig()) if noise \
        else trt.EngineConfig()
    p1 = tprog.compile_program(specs, base, device="cpu")
    cfg = base.replace(sharding=folded(4))
    cands = [tsearch.layer_candidates(s, cfg, 4) for s in specs]
    sched = [(next(c.blocks for c in cs if c.shard_kind == kind), kind)
             for cs in cands]
    plan = trt.plan_network(specs, cfg, schedule=sched)
    assert [lp.shard.kind for lp in plan.layers] == [kind, kind]
    pd = tprog.program_for_plan(plan, device="cpu")
    assert_sharded_equal(p1, pd, p1.init_params(prng.key(0)),
                         relu_x(8, 144, 1), prng.key(3) if noise else None)


def test_tuner_crosses_kinds_and_caches_them(tmp_path):
    spec = tmap.LayerSpec(m=64, k=144, n=320, r_in=4, r_w=2)
    cfg = trt.EngineConfig(sharding=folded(4))
    kinds = [c.shard_kind for c in tsearch.layer_candidates(spec, cfg, 4)]
    assert kinds[0] is None and set(kinds[1:]) == {"col", "rows"}
    assert {c.shard_kind for c in tsearch.layer_candidates(
        spec, trt.EngineConfig(), 1)} == {None}
    path = str(tmp_path / "tune.json")
    plan, reps = tsearch.tune_network([spec], cfg, ["none"],
                                      mode="analytic", cache_path=path,
                                      device="cpu")
    assert reps[0]["key"].endswith("d4fg1152x256@h100_sxm")
    n0 = tsearch.SEARCH_COUNT["n"]
    plan2, reps2 = tsearch.tune_network([spec], cfg, ["none"],
                                        mode="analytic", cache_path=path,
                                        device="cpu")
    assert tsearch.SEARCH_COUNT["n"] == n0 and reps2[0]["cache"] == "hit"
    assert plan2 == plan
    prog = tprog.program_for_plan(plan, device="cpu")
    p1 = tprog.compile_program([spec], trt.EngineConfig(),
                               activations=["none"], device="cpu")
    assert_sharded_equal(p1, prog, p1.init_params(prng.key(1)),
                         relu_x(64, 144, 2))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_sharded_bitexact(seed):
    """Random shapes x precision x forced kind on 4 folded partitions."""
    rng = np.random.default_rng(seed)
    m, k, n = (int(rng.integers(1, 20)), int(rng.integers(9, 400)),
               int(rng.integers(1, 300)))
    r_in, r_w = int(rng.choice((1, 2, 4, 8))), int(rng.choice((1, 2, 4)))
    kind = ("col", "rows")[seed % 2]
    specs = [tmap.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)]
    p1, pd = port_pair(specs, 4, acts=["none"], kinds=[kind])
    assert_sharded_equal(p1, pd, p1.init_params(prng.key(seed)),
                         relu_x(m, k, seed))


# ---- in-flight decode over the sharded engine ----------------------------

_MODELS = {}
MIXED = {"throughput": (2, 1), "quality": ((4, 2), (4, 4), (2, 2), (4, 2))}


def _model(noise: bool, devices: int, mixed: bool) -> CIMDecodeLM:
    k = (noise, devices, mixed)
    if k not in _MODELS:
        cfg = trt.EngineConfig(noise=NoiseConfig()) if noise \
            else trt.EngineConfig()
        if devices:
            cfg = cfg.replace(sharding=folded(devices))
        _MODELS[k] = CIMDecodeLM.toy(
            torch.Generator().manual_seed(7), d=48, depth=2, vocab=23,
            r_in=4, r_w=2, cfg=cfg, points=MIXED if mixed else None,
            device="cpu")
    return _MODELS[k]


@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noisy"))
@pytest.mark.parametrize("mixed", (False, True), ids=("one_point", "mixed"))
def test_fused_decode_equals_sequential_8dev(mixed, noise):
    """The isolation contract across 8 folded macros: every fused stream
    equals its solo decode and the unsharded model's fused stream."""
    rng = np.random.default_rng(99 if mixed else 42)
    points = ("", "throughput", "quality") if mixed else ("",)
    arrivals = []
    for uid in range(4):
        prompt = tuple(int(t) for t in
                       rng.integers(0, 23, size=int(rng.integers(1, 4))))
        arrivals.append((int(rng.integers(0, 4)), Request(
            uid=uid, prompt=prompt, max_new_tokens=int(rng.integers(1, 4)),
            point=points[uid % len(points)])))
    key = prng.key(123) if noise else None
    model, plain = _model(noise, 8, mixed), _model(noise, 0, mixed)
    fused = InflightScheduler(model, capacity=3, key=key).run(arrivals)
    want = InflightScheduler(plain, capacity=3, key=key).run(arrivals)
    assert fused == want
    for _, req in arrivals:
        assert fused[req.uid] == decode_sequential(model, req, key)


# ---- model-level helpers --------------------------------------------------

def test_kv_repeat_to_equals_jax():
    """kv_repeat_to repeats each KV head in place (jnp.repeat) after RoPE
    and before the cache write: the attention block equals JAX's, with
    and without a cache (bypass projections, float32)."""
    d, h, g, hd, s, b = 32, 4, 2, 8, 6, 2
    acfg = dict(d_model=d, n_heads=h, n_kv_heads=g, head_dim=hd)
    rng = np.random.default_rng(0)
    params = {n: {"w": rng.normal(0, 0.2, (d, o)).astype(np.float32),
                  "abn_log_gamma": np.zeros(o, np.float32),
                  "abn_beta": np.zeros(o, np.float32)}
              for n, o in (("wq", h * hd), ("wk", g * hd), ("wv", g * hd),
                           ("wo", d))}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    jp = {n: {k: jnp.asarray(v) for k, v in p.items()}
          for n, p in params.items()}
    tp = {n: {k: torch.from_numpy(v) for k, v in p.items()}
          for n, p in params.items()}
    jc, tc = jcl.CIMConfig(mode="bypass"), tcl.CIMConfig(mode="bypass")
    pos = np.arange(s)

    @jax.jit
    def jblock(x_, cache=None):
        return jcm.attention_block(jp, x_, jcm.AttnConfig(**acfg), jc,
                                   positions=jnp.asarray(pos), cache=cache,
                                   kv_repeat_to=h)
    want, _ = jblock(jnp.asarray(x))
    got, _ = tcm.attention_block(tp, torch.from_numpy(x),
                                 tcm.AttnConfig(**acfg), tc,
                                 positions=torch.from_numpy(pos),
                                 kv_repeat_to=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    jcache = jcm.init_kv_cache(b, 8, h, hd, jnp.float32)
    tcache = tcm.init_kv_cache(b, 8, h, hd, torch.float32)
    want, jcache = jblock(jnp.asarray(x), jcache)
    got, tcache = tcm.attention_block(
        tp, torch.from_numpy(x), tcm.AttnConfig(**acfg), tc,
        positions=torch.from_numpy(pos), cache=tcache, kv_repeat_to=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-6, atol=1e-6)
    kv = torch.arange(2 * 3 * 2 * 1.0).reshape(2, 3, 2, 1)
    assert np.array_equal(tcm._repeat_kv_to(kv, 4).numpy(),
                          np.asarray(jcm._repeat_kv_to(jnp.asarray(kv.numpy()),
                                                       4)))
    assert tcm._repeat_kv_to(kv, 2) is kv


@pytest.mark.parametrize("mesh,b,sq,split", [
    (((2, 4), ("data", "model")), 2, 512, True),
    (((1, 4), ("data", "model")), 2, 512, True),
    (((2,), ("data",)), 4, 256, True),
    (((2, 2, 2), ("pod", "data", "model")), 4, 256, True),
    (((1, 4), ("data", "model")), 2, 256, False),     # 64 rows a piece
    (((3, 1), ("data", "model")), 2, 512, False),     # 3 does not divide B
    (None, 2, 512, False),
], ids=("data2_model4", "model4", "data2", "pod_data_model",
        "under_128_rows", "batch_not_divided", "no_mesh"))
def test_flash_attention_sharded_matches_flash_attention(mesh, b, sq, split):
    """Through the kernels' plain versions: each piece with its q offset
    gives the unsharded result (forward bit for bit: a query row never
    meets another; gradients within the flash tolerances, the sequence
    pieces' dk/dv partials summed in another order), and the fallback
    cases are `flash_attention` itself."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((b, sq, 4, 16), generator=g).requires_grad_()
    k = torch.randn((b, sq, 2, 16), generator=g).requires_grad_()
    v = torch.randn((b, sq, 2, 16), generator=g).requires_grad_()
    do = torch.randn((b, sq, 4, 16), generator=g)
    want = flash_attention(q, k, v, True, 0)
    dwant = torch.autograd.grad(want, (q, k, v), do)
    m = None if mesh is None else tmesh.make_mesh(*mesh, fold_onto="cpu")
    assert (sharded_pieces(m, b, sq) is not None) == split
    if m is None:
        got = flash_attention_sharded(q, k, v, True, 0)
    else:
        with tsh.use_mesh(m):
            got = flash_attention_sharded(q, k, v, True, 0)
    assert torch.equal(got, want)
    for a, w in zip(torch.autograd.grad(got, (q, k, v), do), dwant):
        torch.testing.assert_close(a, w, rtol=5e-5, atol=5e-5)


def test_flash_pieces_follow_the_mesh():
    m = tmesh.make_mesh((2, 4), ("data", "model"), fold_onto="cpu")
    pieces = sharded_pieces(m, 4, 1024)
    assert [(p[0].start, p[1].start, p[2]) for p in pieces[:5]] == [
        (0, 0, 0), (0, 256, 256), (0, 512, 512), (0, 768, 768),
        (2, 0, 0)]
    spread = tmesh.DeviceMesh(tuple(torch.device("cpu") if i % 2 == 0
                                    else torch.device("meta")
                                    for i in range(4)), (2, 2),
                              ("data", "model"))
    assert [p[3].type for p in sharded_pieces(spread, 2, 256)] == [
        "cpu", "meta", "cpu", "meta"]


# ---- the launcher ------------------------------------------------------------

def test_serve_engine_devices():
    """--engine-devices keeps JAX's meaning (D real devices: the host has
    one), needs engine mode, and a folded ShardingConfig serves the same
    tokens as the unsharded launcher."""
    from repro_torch.launch import serve
    args = serve.parser().parse_args(
        ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--cim-mode",
         "engine", "--engine-devices", "2", "--batch", "2"])
    with pytest.raises(ValueError, match="devices"):
        serve.build(args)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                    "--engine-devices", "2"])
    args.engine_devices = 0
    outs = []
    for sharding in (None, folded(4)):
        cfg, params, dev = serve.build(args, sharding)
        assert cfg.cim.sharding == sharding
        cfg = cfg.replace(n_layers=1)
        params = dict(params, layers=params["layers"][:1])
        prompt = serve.make_prompt(cfg.vocab_size, 2, 6, 0, dev)
        outs.append(serve.static_serve(cfg, params, prompt, 2,
                                       max_len=12)["tokens"])
    assert torch.equal(outs[0], outs[1])
