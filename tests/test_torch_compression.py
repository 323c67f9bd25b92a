"""The port's error-feedback int8 gradient compression
(`repro_torch/optim/compression.py`) against the JAX package's.

Bit for bit against JAX run eagerly (`jax.disable_jit()`): codes,
scales and residuals of `compress_leaf`, and the trees of `compress`,
`decompress` and `compressed_grads`, over numpy-seeded leaves of every
magnitude, exact .5 ties of gf / scale, an all-zero leaf and leaves near
either end of float32's normal range (XLA's CPU code flushes subnormal
inputs, so a subnormal element's residual differs: a test of its own
holds that).  Jitted, XLA contracts the residual `gf - q * scale`
into a fused multiply-add and turns `/ 127` into a multiply by its
reciprocal (ROADMAP Queue 3, reference fault 13): one test holds that
the jitted form differs.  A compressed fakequant train step of
OLMo-1B's smoke config is held to JAX's (jitted, as its launcher runs
it) within `tests/test_torch_train.py`'s float32 fakequant tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.cim_layers import CIMConfig as JaxCIM
from repro.launch import steps as jsteps
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import compression as jgc
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.optim import AdamWConfig
from repro_torch.optim import compression as gc
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module (test_torch_train.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> bytes:
    a = np.asarray(a)
    return a.dtype.str.encode() + str(a.shape).encode() + a.tobytes()


def _leaf(kind: str, seed: int):
    """(g, err) float32 numpy leaves of one kind."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    if kind == "random":
        g = rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8)
        e = rng.standard_normal(n) * np.abs(g).max() * 1e-2
    elif kind == "ties":
        # scale = 2^k exactly (max |gf| = 127 * 2^k), every other value
        # an odd multiple of 2^(k-1): gf / scale = m + 0.5 exactly
        k = int(rng.integers(-20, 20))
        g = (rng.integers(-126, 126, n) + 0.5) * 2.0 ** k
        g[int(rng.integers(n))] = 127 * 2.0 ** k * rng.choice((-1, 1))
        e = np.zeros(n)
    elif kind == "zeros":
        g, e = np.zeros(n), np.zeros(n)
    elif kind == "huge":
        g = rng.uniform(-1, 1, n) * 3.4e38
        e = np.zeros(n)
    elif kind == "tiny":
        # near the bottom of the normal range, with gf, the scale and the
        # residual all normal: XLA's CPU code flushes subnormals to zero
        g = rng.choice((-1, 1), n) * rng.uniform(0.5, 1, n) * 1e-28
        e = rng.uniform(-1, 1, n) * 1e-32
    else:
        raise ValueError(kind)
    shape = (n,) if seed % 2 else (1, n)
    return (g.astype(np.float32).reshape(shape),
            e.astype(np.float32).reshape(shape))


KINDS = ("random", "ties", "zeros", "huge", "tiny")


@pytest.mark.parametrize("kind", KINDS)
def test_compress_leaf_matches_eager_jax(kind):
    for seed in range(16 if kind == "random" else 6):
        g, e = _leaf(kind, seed)
        with jax.disable_jit():
            want = jgc.compress_leaf(jnp.asarray(g), jnp.asarray(e))
        got = gc.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
        for name, w, t in zip(("codes", "scale", "residual"), want, got):
            assert _bits(w) == _bits(t.numpy()), (kind, seed, name)
        if kind == "ties":
            q = got[0].numpy().astype(np.int64)
            # half to even: every tie landed on an even code
            ties = np.abs(g / float(got[1])) % 1 == 0.5
            assert np.all(q[ties] % 2 == 0), (kind, seed)


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal((3, 5)).astype(np.float32),
                  np.zeros(4, np.float32)],
            "a": {"w": (1e3 * rng.standard_normal((7,))).astype(np.float32)}}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return jax.tree.map(torch.from_numpy, t)


def _leaves_bits(tree):
    return [_bits(np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                             else x)) for x in jax.tree.leaves(tree)]


def test_tree_functions_match_eager_jax():
    g, e = _tree(1), jax.tree.map(lambda a: a * 1e-3, _tree(2))
    with jax.disable_jit():
        jcodes, jscales, jerr = jgc.compress(_jtree(g), _jtree(e))
        jdeq = jgc.decompress(jcodes, jscales)
        jgq, jerr2 = jgc.compressed_grads(_jtree(g), _jtree(e))
        jbuf = jgc.init_error_buffer(_jtree(g))
    tcodes, tscales, terr = gc.compress(_ttree(g), _ttree(e))
    tdeq = gc.decompress(tcodes, tscales)
    tgq, terr2 = gc.compressed_grads(_ttree(g), _ttree(e))
    tbuf = gc.init_error_buffer(_ttree(g))
    for jt, tt in ((jcodes, tcodes), (jscales, tscales), (jerr, terr),
                   (jdeq, tdeq), (jgq, tgq), (jerr2, terr2), (jbuf, tbuf)):
        assert jax.tree.structure(jt) == jax.tree.structure(
            jax.tree.map(lambda x: 0, tt))
        assert _leaves_bits(jt) == _leaves_bits(tt)


def test_compression_takes_the_steps_leaf_list():
    """The train step hands its gradients over as a list of leaves in
    tree order, with the error buffer's leaves beside them."""
    g, e = _tree(3), _tree(4)
    gq, err = gc.compressed_grads(tree_leaves(_ttree(g)),
                                  tree_leaves(_ttree(e)))
    want_gq, want_err = gc.compressed_grads(_ttree(g), _ttree(e))
    assert isinstance(gq, list) and len(gq) == 3
    assert _leaves_bits(gq) == _leaves_bits(tree_leaves(want_gq))
    assert _leaves_bits(err) == _leaves_bits(tree_leaves(want_err))


def test_jit_rewrites_the_compression_chain():
    """Reference fault 13: jitted, XLA computes `/ 127` as a multiply by
    f32(1/127) and fuses `gf - q * scale` into one rounding.  The
    smallest case of the scale is one leaf of 0.13803421; the residual
    differs on a random leaf.  The port (== eager JAX) keeps the chain
    as written."""
    g = np.array([0.13803421], np.float32)
    z = np.zeros(1, np.float32)
    jit = jax.jit(jgc.compress_leaf)
    with jax.disable_jit():
        eager = jgc.compress_leaf(jnp.asarray(g), jnp.asarray(z))
    jitted = jit(jnp.asarray(g), jnp.asarray(z))
    port = gc.compress_leaf(torch.from_numpy(g), torch.from_numpy(z))
    assert _bits(port[1].numpy()) == _bits(eager[1])
    assert np.asarray(jitted[1]) != np.asarray(eager[1])
    assert np.float32(0.13803421) / np.float32(127) == port[1].item()
    g, e = _leaf("random", 5)
    jitted = jit(jnp.asarray(g), jnp.asarray(e))
    port = gc.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(np.asarray(jitted[0]), port[0].numpy())
    assert _bits(jitted[2]) != _bits(port[2].numpy())
    # the fused form: one rounding of gf - q * scale
    gf = (g + e).astype(np.float64)
    fused = (gf - port[0].numpy().astype(np.float64)
             * float(np.asarray(jitted[1]))).astype(np.float32)
    assert _bits(fused) == _bits(jitted[2])


def test_subnormal_elements_stay_in_the_port_error():
    """XLA's CPU code flushes subnormal inputs to zero, eager too: a
    gradient element below 2^-126 leaves no residual in JAX's error
    buffer, and stays in the port's (PyTorch's CPU and CUDA arithmetic
    keep subnormals).  Codes and scales agree, and so does every
    residual of a normal element; the other tests keep their leaves
    normal for this reason."""
    g = np.array([1e-39, -5e-40, 2e-45, 3e-38, 1e-30], np.float32)
    z = np.zeros_like(g)
    with jax.disable_jit():
        want = jgc.compress_leaf(jnp.asarray(g), jnp.asarray(z))
    got = gc.compress_leaf(torch.from_numpy(g), torch.from_numpy(z))
    assert _bits(want[0]) == _bits(got[0].numpy())
    assert _bits(want[1]) == _bits(got[1].numpy())
    sub = np.abs(g) < np.finfo(np.float32).tiny
    np.testing.assert_array_equal(np.asarray(want[2])[sub], 0.0)
    np.testing.assert_array_equal(got[2].numpy()[sub], g[sub])
    assert _bits(np.asarray(want[2])[~sub]) == _bits(got[2].numpy()[~sub])


def test_error_feedback_converges():
    """int8 EF-compressed SGD reaches the optimum of a quadratic (the
    JAX package's tests/test_substrate.py case)."""
    w = torch.tensor([5.0, -3.0, 2.0])
    target = torch.tensor([1.0, 1.0, 1.0])
    err = gc.init_error_buffer({"w": w})
    for _ in range(300):
        gq, err = gc.compressed_grads({"w": 2 * (w - target)}, err)
        w = w - 0.05 * gq["w"]
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


def test_roundtrip_bound_and_residual():
    g = {"x": torch.from_numpy(
        10 * np.random.default_rng(0).standard_normal(128).astype(
            np.float32))}
    err = gc.init_error_buffer(g)
    assert err["x"].dtype == torch.float32 and not err["x"].any()
    codes, scales, new_err = gc.compress(g, err)
    assert codes["x"].dtype == torch.int8 and scales["x"].dim() == 0
    deq = gc.decompress(codes, scales)
    assert float((deq["x"] - g["x"]).abs().max()) <= float(scales["x"])
    # the error buffer carries exactly the residual
    assert torch.equal(new_err["x"], g["x"] - deq["x"])


LR, STEPS, SEQ, BATCH = 1e-3, 3, 32, 4
# tests/test_torch_train.py's ("fakequant", "float32") tolerances
TOLS = dict(loss=5e-3, gnorm=2e-2, p_max=2 * LR * STEPS, p_mean=1e-4)


@functools.lru_cache(maxsize=None)
def _compressed_runs():
    jcfg = jax_smoke("olmo_1b").replace(
        cim=JaxCIM(mode="fakequant", max_gamma=2.0**16), attn_impl="pallas",
        dtype="float32")
    tcfg = get_smoke_config("olmo_1b").replace(
        cim=CIMConfig(mode="fakequant", max_gamma=2.0**16),
        attn_impl="pallas", dtype="float32")
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     compress_grads=True)
    tstate = convert.train_state_from_numpy(jax.tree.map(np.array, jstate))
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JaxAdamW(lr=LR), total_steps=10, warmup=2,
        compress_grads=True))
    tstep = steps.make_train_step(tcfg, AdamWConfig(lr=LR), total_steps=10,
                                  warmup=2, compress_grads=True)
    data = SyntheticLM(LMDataConfig(vocab_size=512, seq_len=SEQ,
                                    global_batch=BATCH))
    metrics = []
    for s in range(STEPS):
        toks, labels = data.batch_at(s)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks).long(),
                                    "labels": torch.from_numpy(labels).long()})
        metrics.append({k: (float(jm[k]), float(tm[k]))
                        for k in ("loss", "grad_norm", "lr")})
    return metrics, convert.train_state_from_numpy(
        jax.tree.map(np.array, jstate)), tstate


def test_compressed_train_step_matches_jax():
    metrics, jstate, tstate = _compressed_runs()
    for m in metrics:
        for key, tol in (("loss", TOLS["loss"]), ("grad_norm", TOLS["gnorm"])):
            j, t = m[key]
            assert abs(j - t) <= tol * abs(j), (key, j, t)
        assert m["lr"][0] == m["lr"][1]
    diffs = [(j.detach() - t.detach()).abs() for j, t in zip(
        tree_leaves(jstate["params"]), tree_leaves(tstate["params"]))]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs)
    assert worst <= TOLS["p_max"] and mean <= TOLS["p_mean"], (worst, mean)
    assert int(tstate["opt"]["step"]) == STEPS


def test_compressed_train_step_carries_the_error():
    """The error buffer is live: a float32 leaf for every parameter, as
    JAX's, nonzero after the steps, and no leaf of it requires grad."""
    _, jstate, tstate = _compressed_runs()
    jerr, terr = tree_leaves(jstate["err"]), tree_leaves(tstate["err"])
    assert len(jerr) == len(terr) == len(tree_leaves(tstate["params"]))
    assert any(bool(e.any()) for e in terr)
    for j, t in zip(jerr, terr):
        assert t.dtype == torch.float32 and not t.requires_grad
        assert t.shape == j.shape
