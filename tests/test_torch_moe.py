"""The port's MoE block (`repro_torch/models/moe.py`) against the JAX
package's (`repro/models/moe.py`), on numpy inputs, weights carried
across with `convert.moe_params_from_numpy`.

What is held, and to what:

- `tests/test_moe.py`'s contracts in the port: with ample capacity
  `_moe_local` equals the dense every-token reference within 2e-4 (and
  JAX's `_moe_local` on the same inputs within 2e-4), at top_k 2 and 3;
  capacity ~0 gives
  a finite, shrunken output; gradients reach all four banks;
- the routing and the capacity grid: `route`'s top_idx equals
  `jax.lax.top_k`'s on tie-heavy probabilities (ties to the lower
  index); `capacity_grid`'s token ids, gates and keep mask equal JAX's
  bit for bit, with drops and with ties (JAX's token grid read off the
  gathered `x_g` of its own `_moe_local`, the gates and keep mask from
  its grid lines run in jnp, whose token grid equals the read one);
- `_expert_gemm` in fakequant bit for bit against jitted JAX at the grid
  points of `tests/test_llm_engine.py` (r_in {1,2,4,8} x r_w {1,2,4}),
  at a fan-in of 1300 (two row tiles), with learned and default ABN;
  under noise, against JAX run op by op (`jax.disable_jit()`) with
  float32 noise leaves, as `tests/test_torch_noise.py` runs it;
- `moe_block` within 2e-5 of the largest output (float32 fakequant and
  bypass; the router's softmax and the float glue round differently in
  XLA and PyTorch), with JAX's top_idx and an aux loss within 1e-6;
- in the port: engine == fakequant bit for bit at the grid, and with
  capacity drops (`tests/test_llm_engine.py:64`, `:74`); an unknown mode
  raises (`:88`); the experts fold into one program per GEMM shape, the
  (d->f) program serving >= 2E times a block and the (f->d) >= E, one
  plan each (`:97`); `bound_for` binds each expert once, a second block
  binds nothing, an in-place bank update re-binds, and a bank's binds
  leave with it; under one noise key the engine is deterministic, its
  kernel path equals `reference=True`, and another key differs (`:165`,
  unsharded).
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cim_layers import BYPASS as JBYPASS
from repro.core.cim_layers import CIMConfig as JCIM
from repro.core import noise_model as jnm
from repro.models import moe as jm
from repro_torch import convert
from repro_torch.core import mapping
from repro_torch.core import noise_model as tnm
from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig, _engine_config
from repro_torch.models import moe as tm
from repro_torch.runtime import program as tprog


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRID = [(r_in, r_w) for r_in in (1, 2, 4, 8) for r_w in (1, 2, 4)]
E, D, F_ = 4, 16, 48
BYPASS = CIMConfig(mode="bypass")


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return np.asarray(a, np.float32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_bank(seed=5, d=D, f=F_, e=E):
    return jax.tree.map(np.asarray, jm.init_moe(jax.random.PRNGKey(seed), d,
                                                f, e))


def _bank(seed=5, **kw):
    return convert.moe_params_from_numpy(_jax_bank(seed, **kw))


def _x(seed=6, shape=(2, 8, D)):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))


def _block(params, x, cim, cf=1.25, **kw):
    return tm.moe_block(params, torch.from_numpy(x), n_experts=E, top_k=2,
                        capacity_factor=cf, cim=cim, **kw)


# ---- tests/test_moe.py's contracts ------------------------------------------

def _dense_reference(x, probs, top_idx, w_gate, w_up, w_down):
    out = torch.zeros_like(x)
    for ei in range(w_up.shape[0]):
        h = torch.nn.functional.silu(x @ w_gate[ei]) * (x @ w_up[ei])
        y = h @ w_down[ei]
        for k in range(top_idx.shape[1]):
            m = (top_idx[:, k] == ei).float()
            out = out + y * (m * probs[:, k])[:, None]
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_moe_local_matches_dense_with_ample_capacity(k):
    """top_k 2 (every registered config; the combine's index_add_) and 3
    (the combine summed in slot order)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    t = 64
    x = jax.random.normal(ks[0], (t, D))
    w_gate = 0.3 * jax.random.normal(ks[1], (E, D, 32))
    w_up = 0.3 * jax.random.normal(ks[2], (E, D, 32))
    w_down = 0.3 * jax.random.normal(ks[3], (E, 32, D))
    probs_full = jax.nn.softmax(jax.random.normal(ks[4], (t, E)), -1)
    top_p, top_idx = jax.lax.top_k(probs_full, k)
    top_p = top_p / jnp.sum(top_p, -1, keepdims=True)
    zeros = jnp.zeros((E, D))
    want = jm._moe_local(x, top_p, top_idx, w_gate, w_up, w_down, zeros,
                         zeros, n_experts=E, top_k=k, capacity_factor=8.0,
                         cim=JBYPASS, act="silu", psum_axis=None)
    tt = [torch.from_numpy(np.array(a)) for a in
          (x, top_p, top_idx, w_gate, w_up, w_down, zeros)]
    got = tm._moe_local(tt[0], tt[1], tt[2], tt[3], tt[4], tt[5], tt[6],
                        tt[6], n_experts=E, top_k=k, capacity_factor=8.0,
                        cim=BYPASS, act="silu")
    dense = _dense_reference(tt[0], tt[1], tt[2], tt[3], tt[4], tt[5])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_moe_capacity_drops_tokens():
    """With capacity ~0 the output is ~0 (all but 8 slots dropped), not
    NaN."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 32, 8)))
    params = convert.moe_params_from_numpy(jax.tree.map(
        np.asarray, jm.init_moe(jax.random.PRNGKey(1), 8, 16, E)))
    out, aux = _block(params, x, BYPASS, cf=0.01)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))
    assert float(out.abs().mean()) < float(np.abs(x).mean())


def test_moe_grads_flow():
    params = convert.moe_params_from_numpy(jax.tree.map(
        np.asarray, jm.init_moe(jax.random.PRNGKey(2), 8, 16, E)))
    for p in params.values():
        p.requires_grad_(True)
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 8, 8)))
    out, aux = _block(params, x, BYPASS, cf=2.0)
    torch.autograd.backward(torch.mean(out ** 2) + 0.01 * aux)
    for name in ("w_gate", "w_up", "w_down", "router"):
        assert float(params[name].grad.norm()) > 0, name


# ---- routing and the capacity grid -----------------------------------------

def _tie_probs(t, e, seed):
    """Probabilities drawn from few levels, so rows hold equal values."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, 3, size=(t, e)).astype(np.float32)
    return lv / lv.sum(-1, keepdims=True).clip(1)


def test_route_breaks_ties_as_top_k():
    p = _tie_probs(64, E, 0)
    assert any(len(set(r)) < E for r in p.tolist())
    want_p, want_i = jax.lax.top_k(jnp.asarray(p), 2)
    got_p, got_i = torch.sort(torch.from_numpy(p), dim=-1, descending=True,
                              stable=True)
    np.testing.assert_array_equal(got_i[:, :2].numpy(), np.asarray(want_i))
    # route() itself: the router product's softmax, then the same sort
    x, router = np.eye(E, dtype=np.float32), np.zeros((E, E), np.float32)
    _, _, idx = tm.route(torch.from_numpy(x), torch.from_numpy(router), E, 2)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1]] * E)


def _jax_grid(probs, top_idx, cap):
    """JAX's grid lines (repro/models/moe.py, _moe_local) in jnp."""
    t, k = top_idx.shape
    flat_e = top_idx.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(t), k)
    flat_p = probs.reshape(-1)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    same = jax.nn.one_hot(e_sorted, E, dtype=jnp.int32)
    rank = (jnp.cumsum(same, axis=0) - 1)[jnp.arange(t * k), e_sorted]
    keep = rank < cap
    slot = jnp.where(keep, e_sorted * cap + rank, E * cap)
    tok = jnp.zeros((E * cap + 1,), jnp.int32).at[slot].set(
        flat_tok[order], mode="drop")
    gate = jnp.zeros((E * cap + 1,), flat_p.dtype).at[slot].set(
        jnp.where(keep, flat_p[order], 0.0), mode="drop")
    return (np.asarray(tok[:-1].reshape(E, cap)),
            np.asarray(gate[:-1].reshape(E, cap)), np.asarray(keep))


def _jax_tok_grid(probs, top_idx, cf):
    """The token grid JAX's own _moe_local gathers: x holds each token's
    id, so its first expert GEMM's input is the grid."""
    seen = []
    orig = jm._expert_gemm

    def spy(x_g, *a, **kw):
        seen.append(np.asarray(x_g))
        return orig(x_g, *a, **kw)
    t = top_idx.shape[0]
    x = jnp.tile(jnp.arange(t, dtype=jnp.float32)[:, None], (1, 2))
    w = jnp.zeros((E, 2, 2))
    jm._expert_gemm = spy
    try:
        jm._moe_local(x, probs, top_idx, w, w, w, jnp.zeros((E, 2)),
                      jnp.zeros((E, 2)), n_experts=E, top_k=2,
                      capacity_factor=cf, cim=JBYPASS, act="silu",
                      psum_axis=None)
    finally:
        jm._expert_gemm = orig
    return seen[0][..., 0].astype(np.int64)


@pytest.mark.parametrize("case", ["drops", "ties", "ample"])
def test_capacity_grid_matches_jax(case):
    t = 40
    cf = {"drops": 0.4, "ties": 0.4, "ample": 8.0}[case]
    if case == "ties":
        p = _tie_probs(t, E, 1)
    else:
        p = np.asarray(jax.nn.softmax(jax.random.normal(
            jax.random.PRNGKey(7), (t, E)), -1))
    top_p, top_idx = jax.lax.top_k(jnp.asarray(p), 2)
    cap = tm.capacity(t, E, 2, cf)
    want_tok, want_gate, want_keep = _jax_grid(top_p, top_idx, cap)
    np.testing.assert_array_equal(_jax_tok_grid(top_p, top_idx, cf),
                                  want_tok)
    tok, gate, keep = tm.capacity_grid(
        torch.from_numpy(np.asarray(top_p)),
        torch.from_numpy(np.asarray(top_idx)), n_experts=E, top_k=2,
        capacity_factor=cf)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(_bits(gate), _bits(want_gate))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (not keep.all()) == (case != "ample")


# ---- the expert GEMM against JAX, bit for bit -------------------------------

K_SPLIT = 1300          # > 1152 rows: two row tiles


def _gemm_inputs(seed=0, e=3, c=8, k=K_SPLIT, n=20):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, c, k)).astype(np.float32),
            (rng.normal(size=(e, k, n)) * k ** -0.5).astype(np.float32),
            rng.uniform(-1, 5, size=(e, n)).astype(np.float32),
            rng.uniform(-4, 4, size=(e, n)).astype(np.float32))


@pytest.mark.parametrize("r_in,r_w", GRID)
def test_expert_gemm_fakequant_matches_jax(r_in, r_w):
    x, w, lg, bt = _gemm_inputs(r_in * 5 + r_w)
    jc = JCIM(mode="fakequant", r_in=r_in, r_w=r_w)
    tc = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w)
    jf = jax.jit(lambda x, w, l, b: (jm._expert_gemm(x, w, jc, (l, b)),
                                     jm._expert_gemm(x, w, jc)))
    want, want_default = jf(x, w, lg, bt)
    tt = [torch.from_numpy(a) for a in (x, w, lg, bt)]
    got = tm._expert_gemm(tt[0], tt[1], tc, (tt[2], tt[3]))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(tm._expert_gemm(tt[0], tt[1], tc)),
                                  _bits(want_default))


def _f32_leaves(noise):
    return noise.replace(**{f: jnp.float32(getattr(noise, f))
                            for f in tnm.LEAF_FIELDS})


@pytest.mark.parametrize("r_in,r_w", [(8, 4), (4, 2), (1, 1)])
def test_noisy_expert_gemm_matches_jax(r_in, r_w):
    x, w, lg, bt = _gemm_inputs(3)
    jc = JCIM(mode="fakequant", r_in=r_in, r_w=r_w,
              noise=_f32_leaves(jnm.NoiseConfig()))
    tc = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w,
                   noise=tnm.NoiseConfig())
    with jax.disable_jit():
        want = jm._expert_gemm(*(jnp.asarray(a) for a in (x, w)), jc,
                               (jnp.asarray(lg), jnp.asarray(bt)),
                               key=jax.random.PRNGKey(11))
    key = convert.key_from_numpy(np.asarray(jax.random.PRNGKey(11)))
    tt = [torch.from_numpy(a) for a in (x, w, lg, bt)]
    got = tm._expert_gemm(tt[0], tt[1], tc, (tt[2], tt[3]), key=key)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    clean = tm._expert_gemm(tt[0], tt[1], tc, (tt[2], tt[3]))
    assert not torch.equal(got, clean)


# ---- moe_block against JAX --------------------------------------------------

@pytest.mark.parametrize("mode", ["bypass", "fakequant"])
def test_moe_block_matches_jax(mode):
    jp, x = _jax_bank(), _x()
    jc, tc = JCIM(mode=mode, r_in=8, r_w=4), CIMConfig(mode=mode, r_in=8,
                                                        r_w=4)
    want, want_aux = jax.jit(lambda p, x: jm.moe_block(
        p, x, n_experts=E, top_k=2, capacity_factor=1.25, cim=jc))(jp, x)
    got, aux = _block(_bank(), x, tc)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    xf = jnp.asarray(x.reshape(-1, D))
    _, jidx = jax.lax.top_k(jax.nn.softmax(xf @ jp["router"], -1), 2)
    _, _, tidx = tm.route(torch.from_numpy(x.reshape(-1, D)),
                          torch.from_numpy(jp["router"]), E, 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


# ---- engine mode in the port ----------------------------------------------

@pytest.mark.parametrize("r_in,r_w", GRID)
def test_moe_block_engine_equals_fakequant(r_in, r_w):
    params, x = _bank(), _x()
    cim = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w)
    a, _ = _block(params, x, cim)
    b, _ = _block(params, x, cim.replace(mode="engine"))
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("r_in,r_w", [(8, 4), (2, 1)])
def test_moe_block_engine_equals_fakequant_with_capacity_drops(r_in, r_w):
    params, x = _bank(), _x()
    cim = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w)
    a, _ = _block(params, x, cim, cf=0.4)
    b, _ = _block(params, x, cim.replace(mode="engine"), cf=0.4)
    _, _, keep = tm.capacity_grid(*tm.route(
        torch.from_numpy(x.reshape(-1, D)), params["router"], E, 2)[1:],
        n_experts=E, top_k=2, capacity_factor=0.4)
    assert not keep.all()
    assert bool(torch.isfinite(a).all())
    np.testing.assert_array_equal(_bits(a), _bits(b))


def test_moe_unknown_cim_mode_raises():
    with pytest.raises(ValueError, match="does not support CIM mode"):
        _block(_bank(), _x(), CIMConfig(mode="sim", r_in=4, r_w=2))


def _programs(cim, c):
    bucket = tprog.DEFAULT_BUCKETS.bucket_for(c)
    return [tprog.compile_program(
        [mapping.LayerSpec(m=bucket, k=k, n=n, r_in=cim.r_in, r_w=cim.r_w,
                           r_out=cim.r_out)], _engine_config(cim),
        device="cpu") for k, n in ((D, F_), (F_, D))]


def test_moe_engine_program_reuse_is_expertfold():
    """The E experts of a bank serve through ONE program per GEMM shape:
    the (d->f) program serves gate and up (>= 2E a block), the (f->d)
    one the down bank (>= E), each planned once."""
    params, x = _bank(), _x()
    cim = CIMConfig(mode="engine", r_in=4, r_w=2)
    t = x.shape[0] * x.shape[1]
    up, dn = _programs(cim, tm.capacity(t, E, 2, 1.25))
    up0, dn0 = up.stats()["serve_calls"], dn.stats()["serve_calls"]
    _block(params, x, cim)
    assert up.stats()["serve_calls"] - up0 >= 2 * E
    assert dn.stats()["serve_calls"] - dn0 >= E
    assert up.stats()["plans_built"] == dn.stats()["plans_built"] == 1


def test_bound_for_binds_each_expert_once():
    """A second block binds nothing; an in-place bank update re-binds and
    equals a fresh bank; a bank's binds leave with it."""
    params, x = _bank(9), _x(3)
    cim = CIMConfig(mode="engine", r_in=8, r_w=4)
    s0 = tprog.bound_cache_stats()
    first, _ = _block(params, x, cim)
    s1 = tprog.bound_cache_stats()
    assert s1["binds"] - s0["binds"] == 3 * E
    again, _ = _block(params, x, cim)
    s2 = tprog.bound_cache_stats()
    assert s2["binds"] == s1["binds"] and s2["weights"] == s1["weights"]
    assert s2["hits"] - s1["hits"] == 3 * E
    assert torch.equal(first, again)
    with torch.no_grad():
        params["w_up"].mul_(0.5)
    changed, _ = _block(params, x, cim)
    s3 = tprog.bound_cache_stats()
    assert s3["rebinds"] - s2["rebinds"] == E
    fresh = {k: v.clone() for k, v in params.items()}
    assert torch.equal(changed, _block(fresh, x, cim)[0])
    assert not torch.equal(changed, first)
    weights = tprog.bound_cache_stats()["weights"]
    del params, fresh
    gc.collect()
    assert tprog.bound_cache_stats()["weights"] == weights - 2 * 3 * E


def test_bank_views_leave_with_the_bank():
    params = _bank(10)
    tm._expert_params(params["w_up"], None)
    wid = id(params["w_up"])
    assert wid in tm._BANK_VIEWS
    del params
    gc.collect()
    assert wid not in tm._BANK_VIEWS


def test_moe_engine_noise_kernel_matches_reference():
    """Under one noise key the engine's kernel path equals its plain
    oracle bit for bit and repeats; another key differs."""
    params, x = _bank(), _x()
    cim = CIMConfig(mode="engine", r_in=4, r_w=2, noise=tnm.NoiseConfig())
    key = prng.key(321)
    a, _ = _block(params, x, cim, key=key)
    b, _ = _block(params, x, cim, key=key, reference=True)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(a),
                                  _bits(_block(params, x, cim, key=key)[0]))
    other, _ = _block(params, x, cim, key=prng.key(77))
    assert not torch.equal(a, other)
