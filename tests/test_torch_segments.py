"""Per-request isolation in the port against the JAX package.

Segment-wise activation quantization, segmented `BoundProgram.serve` at
bucket-padded and exact extents, `serve_batch(isolate=True)` on dense and
LeNet conv programs, and `SharedInputBind.serve` per head are held bit for
bit (zero tolerance, the integer-domain contract) to the JAX package
(Pallas interpret mode).  The pure-integer helpers of the program layer
(noise-id ranges, dispatch keys) match too.  Noise itself is held in
tests/test_torch_noise.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_layers as jcl
from repro.core import mapping as jmap
from repro.core import quantization as jq
from repro.models import cnn as jcnn
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro_torch.convert import params_from_numpy
from repro_torch.core import mapping as tmap
from repro_torch.core import quantization as tq
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.models import cnn as tcnn
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog


def bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def seeded_params(specs, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in specs]


def _jparams(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


def _rows_with_swings(seed, sizes, k):
    """One request per size, each with its own activation swing."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, k)) * rng.uniform(0.05, 20)
             + rng.uniform(-3, 3)).astype(np.float32) for b in sizes]


# ---- quantize_act -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("r_in", (1, 2, 4, 8))
def test_quantize_act_segments_match_jax(r_in, seed):
    rng = np.random.default_rng(100 + 10 * seed + r_in)
    m = 11
    x = (rng.normal(0, 3, size=(m, 29))
         * rng.uniform(0.01, 5, size=(m, 1))).astype(np.float32)
    ids = np.sort(rng.integers(0, 5, size=m)).astype(np.int32)
    if seed == 1:
        ids = rng.permutation(ids)           # interleaved segments
    j = jax.jit(lambda a, s: jq.quantize_act(a, r_in, segment_ids=s,
                                             num_segments=m))(
        jnp.asarray(x), jnp.asarray(ids))
    t = tq.quantize_act(torch.from_numpy(x), r_in,
                        segment_ids=torch.from_numpy(ids), num_segments=m)
    bits_equal(j.q, t.q)
    bits_equal(j.scale, t.scale)
    bits_equal(j.zero, t.zero)


def test_quantize_act_segments_nd_and_solo_stats():
    """A (B, H, W) tensor reduces each sample's trailing axes, and each
    segment's statistics equal quantizing that segment alone."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 4, 3)).astype(np.float32) * np.arange(
        1, 7, dtype=np.float32)[:, None, None]
    ids = np.array([0, 0, 1, 2, 2, 2], np.int32)
    j = jq.quantize_act(jnp.asarray(x), 4, segment_ids=jnp.asarray(ids))
    t = tq.quantize_act(torch.from_numpy(x), 4,
                        segment_ids=torch.from_numpy(ids))
    assert tuple(t.scale.shape) == (6, 1, 1)
    bits_equal(j.q, t.q)
    bits_equal(j.scale, t.scale)
    for s in range(3):
        rows = ids == s
        solo = tq.quantize_act(torch.from_numpy(x[rows]), 4)
        assert torch.equal(t.q[torch.from_numpy(rows)], solo.q)


# ---- segmented serve --------------------------------------------------------

DIMS = (200, 70, 10)


def _dense_pair(r_in, r_w, seed):
    jspecs = [jmap.LayerSpec(m=4, k=k, n=n, r_in=r_in, r_w=r_w)
              for k, n in zip(DIMS[:-1], DIMS[1:])]
    tspecs = [tmap.LayerSpec(m=4, k=k, n=n, r_in=r_in, r_w=r_w)
              for k, n in zip(DIMS[:-1], DIMS[1:])]
    params = seeded_params(list(zip(DIMS[:-1], DIMS[1:])), seed)
    jb = jprog.compile_program(jspecs, jrt.EngineConfig()).bind(
        _jparams(params))
    tb = tprog.compile_program(tspecs, trt.EngineConfig(),
                               device="cpu").bind(params_from_numpy(params))
    return jb, tb, params_from_numpy(params)


@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4), (1, 1)])
def test_segmented_serve_matches_jax(r_in, r_w):
    """Segmented serve at a padded extent (3 rows -> rung 4) and at an
    exact rung (4 rows), plus the exact-shape run, bit for bit."""
    jb, tb, tparams = _dense_pair(r_in, r_w, r_in * 10 + r_w)
    for sizes in ((1, 2), (2, 1, 1)):
        x = np.concatenate(_rows_with_swings(sum(sizes) + r_in, sizes,
                                             DIMS[0]))
        seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
        want = np.asarray(jb.serve(jnp.asarray(x),
                                   segments=jnp.asarray(seg)))
        got = tb.serve(torch.from_numpy(x), segments=torch.from_numpy(seg))
        bits_equal(want, got)
        assert torch.equal(got, tb.reference(torch.from_numpy(x),
                                             segments=seg))
        run = tb.program.run(tparams, torch.from_numpy(x), segments=seg)
        assert torch.equal(run, got)


def test_segmented_serve_validates_ids():
    _, tb, _ = _dense_pair(4, 2, 0)
    x = torch.zeros(3, DIMS[0])
    with pytest.raises(ValueError, match="entries for batch extent"):
        tb.serve(x, segments=[0, 1])
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        tb.serve(x, segments=[0, 1, 3])
    with pytest.raises(ValueError, match="integer ids"):
        tb.serve(x, segments=torch.zeros(3))


@pytest.mark.parametrize("sizes", [(1, 3, 2), (2, 2), (5,)])
def test_isolated_serve_batch_dense_matches_jax(sizes):
    jb, tb, _ = _dense_pair(4, 2, 7)
    xs = _rows_with_swings(len(sizes), sizes, DIMS[0])
    want = jb.serve_batch([jnp.asarray(x) for x in xs], isolate=True)
    got = tb.serve_batch([torch.from_numpy(x) for x in xs], isolate=True)
    for w, g, x in zip(want, got, xs):
        bits_equal(w, g)
        # isolation: each request equals its solo serve
        assert torch.equal(g, tb.serve(torch.from_numpy(x)))


def test_isolated_serve_batch_lenet_matches_jax():
    """LeNet (conv front end: segment ids repeat over each image's im2col
    rows) served as two isolated requests, one with a 50x swing."""
    cim = dict(r_in=4, r_w=2)
    jparams = jcnn.init_lenet(jax.random.PRNGKey(3),
                              cim=jcl.CIMConfig(**cim))
    jbound = jcnn.lenet_program(4, cim=jcl.CIMConfig(**cim)).bind(
        jcnn.lenet_params_list(jparams))
    tparams = params_from_numpy({n: {k: np.asarray(v) for k, v in p.items()}
                                 for n, p in jparams.items()})
    tbound = tcnn.lenet_program(4, cim=CIMConfig(**cim), device="cpu").bind(
        tcnn.lenet_params_list(tparams))
    rng = np.random.default_rng(8)
    xs = [np.maximum(rng.normal(size=(b, 28, 28, 1)), 0).astype(np.float32)
          * s for b, s in ((1, 1.0), (2, 50.0))]
    want = jbound.serve_batch([jnp.asarray(x) for x in xs], isolate=True)
    got = tbound.serve_batch([torch.from_numpy(x) for x in xs],
                             isolate=True)
    for w, g, x in zip(want, got, xs):
        bits_equal(w, g)
        assert torch.equal(g, tbound.serve(torch.from_numpy(x)))


# ---- shared-input fusion ----------------------------------------------------

@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4)])
def test_shared_input_bind_matches_jax(r_in, r_w):
    heads = (("q", 24), ("k", 24), ("v", 40))
    js = jprog.SharedInputProgram.compile(32, heads, r_in=r_in, r_w=r_w)
    ts = tprog.SharedInputProgram.compile(32, heads, r_in=r_in, r_w=r_w,
                                          device="cpu")
    rng = np.random.default_rng(r_in)
    params = {name: seeded_params([(32, n)], i)[0]
              for i, (name, n) in enumerate(heads)}
    jbind = js.bind({n: {k: jnp.asarray(v) for k, v in p.items()}
                     for n, p in params.items()})
    tbind = ts.bind({n: params_from_numpy([p])[0]
                     for n, p in params.items()})
    x = rng.normal(size=(3, 32)).astype(np.float32)
    seg = np.array([0, 1, 1], np.int32)
    for kw in ({}, {"segments": seg}):
        want = jbind.serve(jnp.asarray(x), **{k: jnp.asarray(v)
                                               for k, v in kw.items()})
        got = tbind.serve(torch.from_numpy(x), **kw)
        assert list(got) == [n for n, _ in heads]
        for name, n in heads:
            assert tuple(got[name].shape) == (3, n)
            bits_equal(want[name], got[name].contiguous())
    # the fused heads equal a per-head program column for column
    solo = tprog.compile_program(
        [tmap.LayerSpec(m=8, k=32, n=40, r_in=r_in, r_w=r_w)],
        activations=("none",), device="cpu").bind(
            params_from_numpy([params["v"]]))
    assert torch.equal(tbind.serve(torch.from_numpy(x))["v"],
                       solo.serve(torch.from_numpy(x)))
    assert ts.k == 32 and tbind.stats()["serve_calls"] >= 3


def test_shared_input_validation_like_jax():
    for mod in (jprog, tprog):
        kw = {} if mod is jprog else {"device": "cpu"}
        with pytest.raises(ValueError, match="duplicate head"):
            mod.SharedInputProgram.compile(16, (("q", 8), ("q", 8)),
                                           r_in=4, r_w=2, **kw)
    ts = tprog.SharedInputProgram.compile(16, (("a", 8), ("b", 4)), r_in=4,
                                          r_w=2, device="cpu")
    with pytest.raises(ValueError, match="missing head"):
        ts.bind({"a": params_from_numpy(seeded_params([(16, 8)], 0))[0]})
    with pytest.raises(ValueError, match="weight shape"):
        ts.bind({n: params_from_numpy(seeded_params([(16, 5)], 0))[0]
                 for n in ("a", "b")})
    with pytest.raises(ValueError, match="single-layer"):
        tprog.SharedInputProgram(tprog.compile_program(
            [tmap.LayerSpec(m=2, k=16, n=8), tmap.LayerSpec(m=2, k=8, n=4)],
            device="cpu"), (("a", 4),))


# ---- integer helpers and what stays unported --------------------------------

def test_noise_id_helpers_and_dispatch_key_match_jax():
    assert tprog.NOISE_ID_STRIDE == jprog.NOISE_ID_STRIDE
    for idx, rows in ((0, 1), (3, 5), (2047, 7)):
        np.testing.assert_array_equal(
            np.asarray(jprog.request_noise_ids(idx, rows)),
            tprog.request_noise_ids(idx, rows).numpy())
        assert tprog.request_noise_ids(idx, rows).dtype == torch.int32
    for bad in ((2048, 1), (-1, 1), (0, 0)):
        with pytest.raises(ValueError):
            jprog.request_noise_ids(*bad)
        with pytest.raises(ValueError):
            tprog.request_noise_ids(*bad)
    assert tprog.EXEC_KEY_FIELDS == jprog.EXEC_KEY_FIELDS
    kw = dict(noise=False, keyed=False, devices=1, bound=True,
              reference=False, segmented=True, identity=False,
              point="quality")
    assert tprog.executable_key("bucket", 4, **kw) == \
        jprog.executable_key("bucket", 4, **kw)


def test_point_joins_the_dispatch_key():
    _, tb, _ = _dense_pair(4, 2, 1)
    x = torch.zeros(2, DIMS[0])
    before = tb.stats()["executables_compiled"]
    tb.serve(x, point="a")
    tb.serve(x, point="b")
    tb.serve(x, point="a")
    assert tb.stats()["executables_compiled"] == before + 2
