"""The port's macro model (repro_torch.core) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; every
comparison is bit for bit (the integer-domain contract has no tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abn as jabn
from repro.core import cim_layers as jcl
from repro.core import digital_ref as jdr
from repro.core import mapping as jmap
from repro.core import quantization as jq
from repro_torch.core import abn as tabn
from repro_torch.core import cim_layers as tcl
from repro_torch.core import digital_ref as tdr
from repro_torch.core import mapping as tmap
from repro_torch.core import quantization as tq


def bits_equal(a, b):
    """Bitwise equality of two float32/int arrays (JAX array vs tensor)."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        a, b = a.astype(np.float32).view(np.int32), b.astype(np.float32).view(
            np.int32)
    np.testing.assert_array_equal(a, b)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("r_in", range(1, 9))
def test_quantize_act_matches_jax(r_in, seed):
    rng = np.random.default_rng(seed * 10 + r_in)
    x = (rng.normal(0, 3, size=(37, 29)) * rng.uniform(0.01, 5)).astype(
        np.float32)
    if seed == 2:
        x = np.maximum(x, 0)            # relu'd activations: zero = 0
    j = jax.jit(jq.quantize_act, static_argnums=1)(jnp.asarray(x), r_in)
    t = tq.quantize_act(_t(x), r_in)
    bits_equal(j.q, t.q)
    bits_equal(j.scale, t.scale)
    bits_equal(j.zero, t.zero)


def test_quantize_act_segments_not_ported():
    """Segment-wise quantization is ported now (held to the JAX package in
    tests/test_torch_segments.py): a segment's statistics are its own, so
    rows of a 100x-swing batchmate leave its codes untouched."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 7)).astype(np.float32)
    x[2:] *= 100.0
    seg = tq.quantize_act(_t(x), 4, segment_ids=torch.tensor([0, 0, 1, 1]))
    solo = tq.quantize_act(_t(x[:2]), 4)
    assert torch.equal(seg.q[:2], solo.q)
    assert torch.equal(seg.scale[:2], solo.scale.expand(2, 1))
    assert not torch.equal(tq.quantize_act(_t(x), 4).q[:2], solo.q)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("r_w", range(1, 5))
def test_quantize_weight_matches_jax(r_w, seed):
    rng = np.random.default_rng(100 + seed * 10 + r_w)
    w = (rng.normal(0, 1, size=(150, 40)) * rng.uniform(0.01, 3)).astype(
        np.float32)
    j = jax.jit(jq.quantize_weight, static_argnums=1)(jnp.asarray(w), r_w)
    t = tq.quantize_weight(_t(w), r_w)
    bits_equal(j.q, t.q)
    bits_equal(j.scale, t.scale)


def test_static_reciprocal_matches_jax():
    for levels in (1.0, 3.0, 7.0, 15.0, 255.0, 0.8 / 128):
        assert tq._static_reciprocal(levels) == jq._static_reciprocal(levels)


def test_exp2_matches_xla_pow():
    """2**x as XLA rounds it, over a wide seeded range and edge cases."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-8, 8, 50000),
                        rng.uniform(-160, 140, 20000),
                        [0.0, -0.0, 127.99, 128.0, -150.0, -149.5,
                         np.inf, -np.inf]]).astype(np.float32)
    j = np.asarray(jax.jit(lambda v: 2.0 ** v)(jnp.asarray(x)))
    bits_equal(j, tabn.exp2_f32(_t(x)))


@pytest.mark.parametrize("max_gamma", (32.0, 8.0))
@pytest.mark.parametrize("gamma_bits", (-1, 0, 2, 3, 5))
def test_abn_gamma_matches_jax(gamma_bits, max_gamma):
    rng = np.random.default_rng(gamma_bits + 11)
    lg = rng.uniform(-6, 7, size=4096).astype(np.float32)
    beta = np.zeros_like(lg)
    j = jax.jit(lambda a, b: jabn.abn_gamma(
        jabn.ABNParams(a, b), gamma_bits=gamma_bits,
        max_gamma=max_gamma))(jnp.asarray(lg), jnp.asarray(beta))
    t = tabn.abn_gamma(tabn.ABNParams(_t(lg), _t(beta)),
                       gamma_bits=gamma_bits, max_gamma=max_gamma)
    bits_equal(j, t)


@pytest.mark.parametrize("r_in,r_w,r_out,n_dp", [
    (8, 4, 8, 1152), (4, 2, 4, 36), (1, 1, 1, 144), (5, 3, 6, 720)])
def test_adc_code_and_dequant_match_jax(r_in, r_w, r_out, n_dp):
    rng = np.random.default_rng(r_in * 100 + n_dp)
    full = n_dp * (2**r_in - 1) * (2**r_w - 1)
    dp = rng.integers(-full // 4, full // 4, size=(64, 12)).astype(np.int32)
    gamma = (2.0 ** rng.uniform(0, 5, size=12)).astype(np.float32)
    beta = rng.uniform(-8, 8, size=12).astype(np.float32)
    macro = jcl.DEFAULT_MACRO
    kw = dict(r_in=r_in, r_w=r_w, r_out=r_out, n_dp=n_dp,
              swing=macro.swing_efficiency(n_dp // 36),
              alpha_adc=macro.alpha_adc())
    assert tdr.adc_gain_factor(r_in, r_w, r_out, n_dp) == \
        jdr.adc_gain_factor(r_in, r_w, r_out, n_dp)
    jc = jdr.dsci_adc_code(jnp.asarray(dp), gamma=jnp.asarray(gamma),
                           beta_codes=jnp.asarray(beta), **kw)
    tc = tdr.dsci_adc_code(_t(dp), gamma=_t(gamma), beta_codes=_t(beta),
                           **kw)
    bits_equal(jc, tc)
    jd = jdr.dequantize_code(jc, gamma=jnp.asarray(gamma),
                             beta_codes=jnp.asarray(beta), **kw)
    td = tdr.dequantize_code(tc, gamma=_t(gamma), beta_codes=_t(beta), **kw)
    bits_equal(jd, td)


@pytest.mark.parametrize("r_w", range(1, 5))
def test_weight_planes_and_macro_ref_match_jax(r_w):
    rng = np.random.default_rng(r_w)
    full = 2**r_w - 1
    w = 2 * rng.integers(-(full + 1) // 2, (full + 1) // 2,
                         size=(40, 9)) + 1
    x = rng.integers(0, 2**6, size=(5, 40)).astype(np.int32)
    jp = jdr.encode_weight_planes(jnp.asarray(w, jnp.int32), r_w)
    tp = tdr.encode_weight_planes(_t(w), r_w)
    bits_equal(jp, tp)
    bits_equal(jdr.decode_weight_planes(jp), tdr.decode_weight_planes(tp))
    np.testing.assert_array_equal(tdr.decode_weight_planes(tp).numpy(), w)
    gamma = np.full(9, 4.0, np.float32)
    jc = jdr.cim_matmul_ref(jnp.asarray(x), jp, r_in=6, r_out=8,
                            gamma=jnp.asarray(gamma))
    tc = tdr.cim_matmul_ref(_t(x), tp, r_in=6, r_out=8, gamma=_t(gamma))
    bits_equal(jc, tc)


SPECS = [(4, 36, 16, 8, 4), (8, 1568, 128, 4, 2), (2, 1152, 64, 2, 1),
         (3, 1153, 257, 1, 3), (16, 4000, 10, 8, 4), (1, 7, 300, 5, 2)]


@pytest.mark.parametrize("m,k,n,r_in,r_w", SPECS)
def test_map_layer_matches_jax(m, k, n, r_in, r_w):
    js = jmap.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
    ts = tmap.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
    jm, tm = jmap.map_layer(js), tmap.map_layer(ts)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert jmap.split_k_slices(k, jm.row_tiles) == \
        tmap.split_k_slices(k, tm.row_tiles)
    assert jmap.split_even_slices(n, jm.col_tiles) == \
        tmap.split_even_slices(n, tm.col_tiles)
    cfg_j = jcl.CIMConfig(r_in=r_in, r_w=r_w)
    cfg_t = tcl.CIMConfig(r_in=r_in, r_w=r_w)
    assert jcl._code_gain(cfg_j, k) == tcl._code_gain(cfg_t, k)
    assert jcl.analytic_log_gamma_init(k, cfg_j) == \
        tcl.analytic_log_gamma_init(k, cfg_t)


def test_map_layer_rejects_wide_weights():
    for mod in (jmap, tmap):
        with pytest.raises(ValueError, match="r_w=5"):
            mod.map_layer(mod.LayerSpec(m=1, k=9, n=4, r_w=5))


CONVS = [dict(batch=2, h=28, w=28, c_in=1, c_out=16),
         dict(batch=3, h=9, w=6, c_in=4, c_out=8, stride=2, padding="SAME"),
         dict(batch=1, h=7, w=7, c_in=3, c_out=5, padding="VALID"),
         dict(batch=2, h=5, w=5, c_in=2, c_out=4, kh=1, kw=1, padding=0),
         dict(batch=1, h=8, w=8, c_in=4, c_out=8, stride=2,
              padding=((0, 1), (2, 0)))]


@pytest.mark.parametrize("kw", CONVS)
def test_conv_layer_spec_matches_jax(kw):
    js, ts = jmap.conv_layer_spec(**kw), tmap.conv_layer_spec(**kw)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert ts.conv is not None


@pytest.mark.parametrize("kw,match", [
    (dict(stride=0), "stride"), (dict(padding=-1), "padding"),
    (dict(padding="HALF"), "padding"),
    (dict(h=4, w=4, kh=7, kw=7, padding="VALID"), "does not fit"),
    (dict(c_in=0), "dims must be >= 1")])
def test_conv_layer_spec_validation(kw, match):
    args = dict(batch=1, h=8, w=8, c_in=4, c_out=8) | kw
    for mod in (jmap, tmap):
        with pytest.raises(ValueError, match=match):
            mod.conv_layer_spec(**args)
    assert tmap.resolve_padding("SAME", 3, 3, 7, 7, 2) == \
        jmap.resolve_padding("SAME", 3, 3, 7, 7, 2) == ((1, 1), (1, 1))
