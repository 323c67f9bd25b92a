"""The port's KV caches and cached attention against the JAX package's
(`repro/models/common.py`, `repro/models/transformer.py`), on the CPU,
at OLMo-1B's smoke widths (d 64, 4 heads of 16).

What is held, and to what:

- the cache functions (`init_kv_cache`, `init_slot_kv_cache`,
  `write_slot_kv`, `free_slot_kv` and the model-level `init_cache`,
  `init_slot_cache`, `write_slot_cache`, `free_slot_cache`): data
  movement only, so bit for bit, dtypes included;
- `plain_attention` with per-row (B, Sq) / (B, Sk) positions: within
  1e-6 (absolute and relative) in float32;
- the streaming `flash_attention` with `kv_block` below Sk (padding and
  several blocks), GQA rep 2, causal and windowed: within 1e-5;
- `attention_block` over a ring cache (one token and several, with a
  wrapped cursor and a clamped start) and over a slot-mapped cache (one
  token a row at per-row cursors): the output and the written rings
  within 1e-5, the cursors exactly.  The projections run in bypass mode in float32, with a
  float32 cache, so the comparison sees the cache logic and not the
  CIM codes (the serving tests hold those).

The port writes the rings in place; each port call here gets its own
copy of the inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.cim_layers import CIMConfig as JaxCIM
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.models import common as tcm
from repro_torch.models import transformer as ttf


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(jtree, ttree):
    """Bit for bit, dtype included (bfloat16 compared as float32)."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _assert_tree_equal(jtree[k], ttree[k])
        return
    want = convert.cache_from_numpy({"a": np.asarray(jtree)})["a"]
    assert want.dtype == ttree.dtype, (want.dtype, ttree.dtype)
    assert want.shape == ttree.shape
    assert torch.equal(want, ttree.cpu())


def _rand_cache(rng, b, length, g, hd, idx, dtype=np.float32):
    return {"k": rng.standard_normal((b, length, g, hd)).astype(dtype),
            "v": rng.standard_normal((b, length, g, hd)).astype(dtype),
            "idx": np.asarray(idx, np.int32)}


# ---------------------------------------------------------------------------
# the cache functions: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_kv_caches_match_jax(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _assert_tree_equal(jcm.init_kv_cache(3, 7, 2, 16, jd),
                       tcm.init_kv_cache(3, 7, 2, 16, td))
    _assert_tree_equal(jcm.init_slot_kv_cache(4, 9, 4, 8, jd),
                       tcm.init_slot_kv_cache(4, 9, 4, 8, td))


@pytest.mark.parametrize("slot", [0, 2])
def test_write_and_free_slot_kv_match_jax(slot):
    rng = np.random.default_rng(slot)
    cache = _rand_cache(rng, 3, 6, 2, 8, [4, 1, 9])
    pre = _rand_cache(rng, 1, 6, 2, 8, 5)
    jw = jcm.write_slot_kv({k: jnp.asarray(v) for k, v in cache.items()},
                           slot, {k: jnp.asarray(v) for k, v in pre.items()})
    tcache = convert.cache_from_numpy(cache)
    tw = tcm.write_slot_kv(tcache, slot, convert.cache_from_numpy(pre))
    _assert_tree_equal(_np(jw), tw)
    assert tw["k"] is tcache["k"]          # written in place
    _assert_tree_equal(_np(jcm.free_slot_kv(jw, slot)),
                       tcm.free_slot_kv(tw, slot))


def _model_cfgs():
    jcfg = jax_smoke("olmo_1b").replace(dtype="float32")
    tcfg = get_smoke_config("olmo_1b").replace(dtype="float32")
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_model_caches_match_jax(dtype):
    jcfg, tcfg = _model_cfgs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _assert_tree_equal(_np(jtf.init_cache(jcfg, 3, 11, jd)),
                       ttf.init_cache(tcfg, 3, 11, td))
    _assert_tree_equal(_np(jtf.init_slot_cache(jcfg, 4, 11, jd)),
                       ttf.init_slot_cache(tcfg, 4, 11, td))


def test_write_and_free_slot_cache_match_jax():
    jcfg, tcfg = _model_cfgs()
    rng = np.random.default_rng(3)
    slot_cache = _np(jtf.init_slot_cache(jcfg, 3, 8))
    kv = slot_cache["layers"]["kv"]
    kv["k"] = rng.standard_normal(kv["k"].shape).astype(np.float32)
    kv["idx"] = rng.integers(0, 20, size=kv["idx"].shape).astype(np.int32)
    slot_cache["pos"] = np.asarray([3, 7, 1], np.int32)
    pre = _np(jtf.init_cache(jcfg, 1, 8))
    pkv = pre["layers"]["kv"]
    pkv["k"] = rng.standard_normal(pkv["k"].shape).astype(np.float32)
    pkv["v"] = rng.standard_normal(pkv["v"].shape).astype(np.float32)
    pkv["idx"] = np.asarray([5, 5], np.int32)
    pre["pos"] = np.asarray(5, np.int32)
    jw = jtf.write_slot_cache(jax.tree.map(jnp.asarray, slot_cache), 1,
                              jax.tree.map(jnp.asarray, pre))
    tw = ttf.write_slot_cache(convert.cache_from_numpy(slot_cache), 1,
                              convert.cache_from_numpy(pre))
    _assert_tree_equal(_np(jw), tw)
    _assert_tree_equal(_np(jtf.free_slot_cache(jw, 1)),
                       ttf.free_slot_cache(tw, 1))


# ---------------------------------------------------------------------------
# attention: per-row masks and the streaming path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0)])
def test_plain_attention_per_row_positions(causal, window):
    rng = np.random.default_rng(11)
    b, sq, sk, h, g, d = 3, 2, 7, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    q_pos = np.asarray([[4, 5], [0, 1], [8, 9]])
    k_pos = np.asarray([[0, 1, 2, 3, 4, 5, -10**9],
                        [0, 1, -10**9, -10**9, -10**9, -10**9, -10**9],
                        [7, 8, 9, 3, 4, 5, 6]])
    for qp in (q_pos, q_pos[0]):          # per-row queries, or shared
        want = jax.jit(lambda *a: jcm.plain_attention(
            *a[:3], q_pos=a[3], k_pos=a[4], causal=causal,
            window=window))(q, k, v, qp, k_pos)
        got = tcm.plain_attention(
            *map(torch.from_numpy, (q, k, v)), q_pos=torch.from_numpy(qp),
            k_pos=torch.from_numpy(k_pos), causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9),
                                           (False, 0), (False, 9)])
def test_streaming_flash_attention(causal, window):
    rng = np.random.default_rng(5)
    b, sq, sk, h, g, d = 2, 13, 45, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    q_pos = np.arange(sk - sq, sk)
    k_pos = np.arange(sk)
    want = jax.jit(lambda *a: jcm.flash_attention(
        *a[:3], q_pos=a[3], k_pos=a[4], causal=causal, window=window,
        kv_block=16))(q, k, v, q_pos, k_pos)
    got = tcm.flash_attention(
        *map(torch.from_numpy, (q, k, v)), q_pos=torch.from_numpy(q_pos),
        k_pos=torch.from_numpy(k_pos), causal=causal, window=window,
        kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the streaming path equals the materialized one
    plain = tcm.plain_attention(
        *map(torch.from_numpy, (q, k, v)), q_pos=torch.from_numpy(q_pos),
        k_pos=torch.from_numpy(k_pos), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# attention_block over a cache
# ---------------------------------------------------------------------------

def _block_setup(seed):
    geom = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                rope_theta=1e4)
    acfg_j, acfg_t = jcm.AttnConfig(**geom), tcm.AttnConfig(**geom)
    jp = jcm.init_attention(jax.random.PRNGKey(seed), acfg_j)
    tp = convert.train_params_from_numpy(_np(jp))
    return jp, tp, acfg_j, acfg_t


@pytest.mark.parametrize("s,idx", [(1, 5), (1, 11), (3, 2), (3, 6)])
def test_attention_block_ring_cache(s, idx):
    """One token at cursor 5 and at 11 (wrapped past L 8), three tokens
    at 2, and three at 6 (the start clamped to 5, as JAX clamps it)."""
    jp, tp, acfg_j, acfg_t = _block_setup(1)
    rng = np.random.default_rng(idx + 10 * s)
    b, length = 2, 8
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    cache = _rand_cache(rng, b, length, 4, 16, idx)
    pos = np.arange(idx, idx + s)
    jout, jc = jax.jit(lambda p, x_, c, ps: jcm.attention_block(
        p, x_, acfg_j, JaxCIM(mode="bypass"), positions=ps, cache=c))(
        jp, x, {k: jnp.asarray(v) for k, v in cache.items()}, pos)
    tout, tc = tcm.attention_block(
        tp, torch.from_numpy(x), acfg_t, CIMConfig(mode="bypass"),
        positions=torch.from_numpy(pos),
        cache=convert.cache_from_numpy(cache))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)
    assert int(tc["idx"]) == int(jc["idx"])


def test_attention_block_slot_cache():
    jp, tp, acfg_j, acfg_t = _block_setup(2)
    rng = np.random.default_rng(7)
    b, length = 4, 8
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    cache = _rand_cache(rng, b, length, 4, 16, [0, 3, 9, 2])
    pos = np.asarray([[0], [3], [9], [2]])
    jout, jc = jax.jit(lambda p, x_, c, ps: jcm.attention_block(
        p, x_, acfg_j, JaxCIM(mode="bypass"), positions=ps, cache=c))(
        jp, x, {k: jnp.asarray(v) for k, v in cache.items()}, pos)
    tout, tc = tcm.attention_block(
        tp, torch.from_numpy(x), acfg_t, CIMConfig(mode="bypass"),
        positions=torch.from_numpy(pos),
        cache=convert.cache_from_numpy(cache))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    with pytest.raises(ValueError, match="single-token"):
        tcm.attention_block(
            tp, torch.zeros((b, 2, 64)), acfg_t, CIMConfig(mode="bypass"),
            positions=torch.zeros((b, 2), dtype=torch.long),
            cache=convert.cache_from_numpy(cache))


def test_cross_attention_and_kv_repeat_raise():
    """Cross-attention is ported (held against JAX in
    tests/test_torch_audio.py): over `x_kv` with a cache of {} the block
    returns the projected {"k", "v"}, and the same queries over them as
    `cross_kv` give the same output and return them as they are.
    kv_repeat_to (ported with the sharding slice; held against JAX in
    tests/test_torch_sharding.py) raises only where JAX's does, past the
    query heads (8 KV heads for 4 queries), and at the KV head count
    leaves the block as it was."""
    _, tp, _, acfg_t = _block_setup(3)
    x = torch.zeros((1, 2, 64))
    gen = torch.Generator().manual_seed(1)
    xq, enc = torch.randn((1, 2, 64), generator=gen), torch.randn(
        (1, 5, 64), generator=gen)
    xcfg = dataclasses.replace(acfg_t, causal=False, use_rope=False)
    out, kv = tcm.attention_block(tp, xq, xcfg, CIMConfig(mode="bypass"),
                                  positions=torch.arange(2), x_kv=enc,
                                  cache={})
    assert set(kv) == {"k", "v"} and kv["k"].shape == (1, 5, 4, 16)
    out2, kv2 = tcm.attention_block(tp, xq, xcfg, CIMConfig(mode="bypass"),
                                    positions=torch.arange(2), cross_kv=kv,
                                    cache={})
    assert kv2 is kv
    torch.testing.assert_close(out2, out, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        tcm.attention_block(tp, x, acfg_t, CIMConfig(mode="bypass"),
                            positions=torch.arange(2), kv_repeat_to=8)
    xr = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(0))
    outs = [tcm.attention_block(tp, xr, acfg_t, CIMConfig(mode="bypass"),
                                positions=torch.arange(2), **kw)[0]
            for kw in ({}, {"kv_repeat_to": 4})]
    assert torch.equal(outs[0], outs[1])
