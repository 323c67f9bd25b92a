"""The port's engine and program layer against the JAX package.

Plans are compared field by field (g0 as floats, bit for bit), bind
products bit for bit (gamma_p included), and whole programs - dense
multi-tile and conv - served bit-exact against JAX
compile_program(...).bind(...).serve (Pallas interpret mode).  The port's
own invariants (bucket padding, stream_rows chunking, serve_batch) hold
bit for bit too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as jmap
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro_torch.convert import params_from_numpy
from repro_torch.core import mapping as tmap
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog


def seeded_params(specs, seed):
    """numpy params for a chain of (k, n) layers, with spread ABN gains."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in specs]


def dense(mod, m, dims, r_in, r_w):
    return [mod.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
            for k, n in zip(dims[:-1], dims[1:])]


def assert_plans_equal(jp, tp):
    assert len(jp.layers) == len(tp.layers)
    for jl, tl in zip(jp.layers, tp.layers):
        assert dataclasses.asdict(jl.spec) == dataclasses.asdict(tl.spec)
        assert dataclasses.asdict(jl.mp) == dataclasses.asdict(tl.mp)
        assert dataclasses.asdict(jl.precision) == \
            dataclasses.asdict(tl.precision)
        assert np.float64(jl.g0).tobytes() == np.float64(tl.g0).tobytes()
        assert (jl.k_slices, jl.n_slices, jl.activation, jl.pool) == \
            (tl.k_slices, tl.n_slices, tl.activation, tl.pool)
        assert (jl.tile_n, jl.n_pad, jl.out_shape, jl.macro_evals) == \
            (tl.tile_n, tl.n_pad, tl.out_shape, tl.macro_evals)
    assert jp.total_macro_evals == tp.total_macro_evals


@pytest.mark.parametrize("adaptive_swing", (True, False))
@pytest.mark.parametrize("r_in,r_w", [(8, 4), (4, 2), (1, 1), (3, 3)])
def test_plan_network_matches_jax(r_in, r_w, adaptive_swing):
    jcfg = jrt.EngineConfig(adaptive_swing=adaptive_swing)
    tcfg = trt.EngineConfig(adaptive_swing=adaptive_swing)
    dims = (2000, 300, 70, 10)
    assert_plans_equal(jrt.plan_network(dense(jmap, 4, dims, r_in, r_w), jcfg),
                       trt.plan_network(dense(tmap, 4, dims, r_in, r_w), tcfg))
    conv = dict(batch=2, h=10, w=10, c_in=3, c_out=8, r_in=r_in, r_w=r_w)
    acts, pools = ["relu", "none"], [2, 1]
    jspecs = [jmap.conv_layer_spec(**conv), jmap.LayerSpec(m=2, k=200, n=5)]
    tspecs = [tmap.conv_layer_spec(**conv), tmap.LayerSpec(m=2, k=200, n=5)]
    assert_plans_equal(jrt.plan_network(jspecs, jcfg, acts, pools),
                       trt.plan_network(tspecs, tcfg, acts, pools))


def test_plan_rejects_bad_chains_like_jax():
    for mod, rt in ((jmap, jrt), (tmap, trt)):
        conv = mod.conv_layer_spec(2, 8, 8, 3, 8, padding=1)
        with pytest.raises(ValueError, match="chain mismatch"):
            rt.plan_network([conv, mod.LayerSpec(m=2, k=100, n=4)])
        with pytest.raises(ValueError, match="chain mismatch"):
            rt.plan_network([mod.LayerSpec(m=2, k=16, n=192), conv])
        with pytest.raises(ValueError, match="pooling epilogue"):
            rt.plan_network([mod.LayerSpec(m=2, k=16, n=8)], pools=[2])


@pytest.mark.parametrize("gamma_bits", (-1, 3))
@pytest.mark.parametrize("r_in,r_w", [(8, 4), (4, 2), (2, 1)])
def test_bind_network_matches_jax(r_in, r_w, gamma_bits):
    dims = (1300, 140, 10)
    params = seeded_params(list(zip(dims[:-1], dims[1:])), r_in * 7 + r_w)
    jcfg = jrt.EngineConfig(gamma_bits=gamma_bits)
    tcfg = trt.EngineConfig(gamma_bits=gamma_bits)
    jb = jprog.compile_program(dense(jmap, 4, dims, r_in, r_w), jcfg).bind(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    tb = tprog.compile_program(dense(tmap, 4, dims, r_in, r_w), tcfg,
                               device="cpu").bind(params_from_numpy(params))
    for jl, tl in zip(jb._binds, tb._binds):
        assert set(jl) == set(tl) == {"wqq", "w_scale", "gamma_p", "beta_p"}
        for key in jl:
            a, b = np.asarray(jl[key]), tl[key].numpy()
            assert a.shape == b.shape and b.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _serve_both(jspecs, tspecs, params, x, *, acts=None, pools=None,
                stream_rows=0):
    jb = jprog.compile_program(
        jspecs, jrt.EngineConfig(stream_rows=stream_rows), activations=acts,
        pools=pools).bind([{k: jnp.asarray(v) for k, v in p.items()}
                           for p in params])
    tb = tprog.compile_program(
        tspecs, trt.EngineConfig(stream_rows=stream_rows), activations=acts,
        pools=pools, device="cpu").bind(params_from_numpy(params))
    want = np.asarray(jb.serve(jnp.asarray(x)))
    got = tb.serve(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    return tb, got


@pytest.mark.parametrize("r_in,r_w", [(8, 4), (4, 2), (1, 2)])
def test_dense_multitile_program_matches_jax(r_in, r_w):
    """K > 1152 (two row tiles) and N beyond one col tile's budget."""
    dims = (1300, 140, 12)
    params = seeded_params(list(zip(dims[:-1], dims[1:])), r_in + 10 * r_w)
    x = np.random.default_rng(r_in).normal(size=(3, 1300)).astype(np.float32)
    _serve_both(dense(jmap, 4, dims, r_in, r_w),
                dense(tmap, 4, dims, r_in, r_w), params, x)


CONVS = [
    dict(h=9, w=9, c_in=4, c_out=8, stride=1, padding="SAME"),
    dict(h=9, w=7, c_in=4, c_out=8, stride=2, padding="SAME"),
    dict(h=8, w=8, c_in=2, c_out=6, stride=1, padding="VALID"),
    dict(h=6, w=6, c_in=5, c_out=7, kh=1, kw=1, padding=0),
    dict(h=7, w=7, c_in=1, c_out=4, stride=2, padding=((0, 1), (1, 0))),
]


@pytest.mark.parametrize("conv", CONVS)
def test_conv_program_matches_jax(conv):
    b, r = 2, dict(r_in=4, r_w=2)
    jc = jmap.conv_layer_spec(batch=b, **conv, **r)
    tc = tmap.conv_layer_spec(batch=b, **conv, **r)
    g = tc.conv
    feat = g.out_h * g.out_w * g.c_out
    jspecs = [jc, jmap.LayerSpec(m=b, k=feat, n=5, **r)]
    tspecs = [tc, tmap.LayerSpec(m=b, k=feat, n=5, **r)]
    params = seeded_params([(tc.k, tc.n), (feat, 5)], g.h * g.c_in)
    x = np.maximum(np.random.default_rng(g.w).normal(
        size=(b, g.h, g.w, g.c_in)), 0).astype(np.float32)
    _serve_both(jspecs, tspecs, params, x)


def test_conv_row_tiles_and_pool_match_jax():
    """A conv whose K = 3*3*132 > 1152 requantizes across two row tiles,
    streamed in 50-row chunks, then max-pooled."""
    r = dict(r_in=8, r_w=4)
    jc = jmap.conv_layer_spec(batch=2, h=6, w=6, c_in=132, c_out=6, **r)
    tc = tmap.conv_layer_spec(batch=2, h=6, w=6, c_in=132, c_out=6, **r)
    params = seeded_params([(tc.k, 6), (54, 3)], 5)
    x = np.random.default_rng(4).uniform(size=(2, 6, 6, 132)).astype(
        np.float32)
    tb, y = _serve_both([jc, jmap.LayerSpec(m=2, k=54, n=3, **r)],
                        [tc, tmap.LayerSpec(m=2, k=54, n=3, **r)], params, x,
                        acts=["relu", "none"], pools=[2, 1], stream_rows=50)
    assert tb.plan.layers[0].macro_evals == 2


def _lenet_like(batch, stream_rows=0):
    specs = [tmap.conv_layer_spec(batch, 12, 12, 2, 8, r_in=4, r_w=2),
             tmap.LayerSpec(m=batch, k=6 * 6 * 8, n=7, r_in=4, r_w=2)]
    prog = tprog.compile_program(
        specs, trt.EngineConfig(stream_rows=stream_rows),
        activations=["relu", "none"], pools=[2, 1], device="cpu")
    params = params_from_numpy(seeded_params([(18, 8), (288, 7)], 9))
    return prog, params


def test_bucket_padding_equals_unpadded_run():
    tprog.clear_program_cache()
    prog, params = _lenet_like(8)
    bound = prog.bind(params)
    rng = np.random.default_rng(0)
    for b in (1, 3, 5, 8):
        x = torch.from_numpy(rng.normal(size=(b, 12, 12, 2)).astype(
            np.float32))
        served = bound.serve(x)
        assert torch.equal(served, prog.run(params, x))
        assert torch.equal(served, bound.reference(x))
        assert torch.equal(served, prog.serve(params, x))
    # rungs 1, 4 and 8, each served bound, unbound and as the reference
    st = prog.stats()
    assert st["plans_built"] == 1 and st["bucket_misses"] == 9
    assert st["serve_calls"] == 12 and st["run_calls"] == 4


def test_stream_rows_chunking_changes_no_bit():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 12, 12, 2)).astype(np.float32))
    outs = []
    for rows in (0, 7, 64, 1000):
        prog, params = _lenet_like(4, stream_rows=rows)
        outs.append(prog.bind(params).serve(x))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_serve_batch_equals_serve_of_concatenation():
    prog, params = _lenet_like(16)
    bound = prog.bind(params)
    rng = np.random.default_rng(2)
    reqs = [torch.from_numpy(rng.normal(size=(b, 12, 12, 2)).astype(
        np.float32)) for b in (1, 4, 6)]
    outs = bound.serve_batch(reqs)
    whole = bound.serve(torch.cat(reqs))
    assert [tuple(o.shape) for o in outs] == [(1, 7), (4, 7), (6, 7)]
    assert torch.equal(torch.cat(outs), whole)
    assert bound.serve_batch([]) == []
    # isolate=True makes each request its own segment: equal to solo serves
    for out, req in zip(bound.serve_batch(reqs, isolate=True), reqs):
        assert torch.equal(out, bound.serve(req))
    with pytest.raises(NotImplementedError):
        bound.serve(reqs[0], noise_ids=torch.zeros(1))
    with pytest.raises(ValueError, match="batch-major"):
        bound.serve_batch([reqs[0], torch.zeros(2, 5)])


def test_program_cache_plans_once():
    tprog.clear_program_cache()
    before = trt.PLAN_COUNT["n"]
    specs = dense(tmap, 4, (20, 8, 3), 4, 2)
    a = tprog.compile_program(specs, device="cpu")
    b = tprog.compile_program(list(specs), trt.EngineConfig(),
                              activations=["relu", "none"], device="cpu")
    assert a is b and trt.PLAN_COUNT["n"] == before + 1
    assert tprog.program_cache_stats() == {
        "programs_built": 1, "lookups": 2, "hits": 1, "programs": 1}
    assert a.device == torch.device("cpu")
    with pytest.raises(ValueError, match="input width"):
        a.bind(params_from_numpy(seeded_params([(20, 8), (8, 3)], 0))).serve(
            torch.zeros(2, 19))


def test_compile_program_defaults_to_cuda(monkeypatch):
    """With no device named, a program runs on CUDA; without a card that
    raises (naming device="cpu") instead of carrying on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tprog.compile_program(dense(tmap, 4, (20, 8, 3), 4, 2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tprog.compile_program(dense(tmap, 4, (20, 8, 3), 4, 2),
                              device="cuda")


def test_bucket_ladder_matches_jax():
    for jb, tb in ((jprog.BatchBuckets(), tprog.BatchBuckets()),
                   (jprog.BatchBuckets(4, 32), tprog.BatchBuckets(4, 32))):
        assert all(jb.bucket_for(m) == tb.bucket_for(m)
                   for m in range(1, 100))
        assert jb.ladder(70) == tb.ladder(70)
    with pytest.raises(ValueError):
        tprog.BatchBuckets(0)
