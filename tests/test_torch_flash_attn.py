"""The port's flash attention (plain versions on the CPU) against the JAX
package's Pallas flash kernels in interpret mode, as
`tests/test_flash_attn.py` runs them.

Tolerances are the JAX tests' own: forward within 2e-5 and gradients
within 5e-5 in float32 (both sides compute in float32, with sums in
another order), 2e-2 in bfloat16 (the output is rounded to bfloat16 on
both sides, and a float32 difference can move that rounding by one ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import kernel as jkernel
from repro.kernels.flash_attn.ops import flash_attention as jflash
from repro_torch.kernels.flash_attn import kernel as tkernel
from repro_torch.kernels.flash_attn import ref as tref
from repro_torch.kernels.flash_attn.ops import flash_attention as tflash

# b, sq, sk, h, g, d, causal, window: the CASES of tests/test_flash_attn.py
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 100, 100, 4, 4, 32, True, 0),     # ragged: padding path in JAX
    (2, 64, 64, 8, 1, 64, True, 16),      # MQA + sliding window
    (1, 256, 256, 2, 2, 128, False, 0),   # non-causal (encoder)
    (1, 96, 192, 3, 1, 32, False, 0),     # cross-shaped Sq != Sk
]


def _inputs(b, sq, sk, h, g, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, sk, g, d)).astype(dtype),
            rng.standard_normal((b, sk, g, d)).astype(dtype))


def _torch(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


def _offset(off):
    return jnp.full((1, 1), off, jnp.int32), torch.full((1, 1), off,
                                                         dtype=torch.int32)


@pytest.mark.parametrize("b,sq,sk,h,g,d,causal,window", CASES)
def test_flash_fwd_matches_jax(b, sq, sk, h, g, d, causal, window):
    q, k, v = _inputs(b, sq, sk, h, g, d, sq + h)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                  window, 64, 64)
    got = tflash(*_torch(q, k, v), causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_fwd_q_offset_matches_jax():
    """A query block at global position 100 (the context-parallel shard's
    offset): causal and window masks follow q_off + row."""
    q, k, v = _inputs(1, 64, 192, 4, 2, 32, 7)
    j_off, t_off = _offset(100)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 48,
                  64, 64, q_offset=j_off)
    got = tflash(*_torch(q, k, v), True, 48, q_offset=t_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal,window,off", [
    (True, 0, 0), (True, 16, 0), (False, 0, 0), (True, 24, 40)])
def test_flash_grads_match_jax(causal, window, off):
    q, k, v = _inputs(1, 96, 96, 4, 2, 32, 0)
    j_off, t_off = _offset(off)
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jflash(
        q, k, v, causal, window, 32, 32, q_offset=j_off))),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = _torch(q, k, v, grad=True)
    torch.sin(tflash(*ts, causal, window, q_offset=t_off)).sum().backward()
    for w, t in zip(want, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-5)


def test_flash_bf16_matches_jax():
    q, k, v = _inputs(1, 64, 64, 2, 2, 32, 1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jflash(jq, jk, jv, True, 0, 32, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tflash(tq, tk, tv, True, 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("causal,window,off", [
    (True, 0, 0), (False, 0, 0), (True, 32, 64)])
def test_plain_kernels_match_jax_kernels(causal, window, off):
    """The three plain versions against the three Pallas kernels
    themselves: O and lse of the forward, dq and the per-query-head dk/dv
    of the backward (B, H, S, D layout, block-multiple shapes)."""
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((1, 4, 128, 32)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
            for _ in range(2))
    j_off, t_off = _offset(off)
    kw = dict(causal=causal, window=window)
    jo, jlse = jkernel.flash_attention_bhsd(
        *map(jnp.asarray, (q, k, v)), j_off, rep=2, bq=64, bk=64, **kw)
    to, tlse = tref.flash_fwd_ref(*_torch(q, k, v), t_off, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=2e-5)
    delta = np.sum(do * np.asarray(jo), axis=-1)
    jgrads = jkernel.flash_attention_bwd_bhsd(
        *map(jnp.asarray, (q, k, v, do)), jlse, jnp.asarray(delta)[..., None],
        j_off, rep=2, bq=64, bk=64, **kw)
    targs = _torch(q, k, v, do) + [torch.from_numpy(np.array(jlse)[..., 0]),
                                   torch.from_numpy(delta), t_off]
    tgrads = (tref.flash_bwd_dq_ref(*targs, **kw),
              *tref.flash_bwd_dkv_ref(*targs, **kw))
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-5,
                                   rtol=5e-5)


def test_attention_ref_matches_jax_oracle():
    from repro.kernels.flash_attn.ref import attention_ref as jref
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 6, 40, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 50, 16)).astype(np.float32)
            for _ in range(2))
    for causal, window, valid in ((True, 0, 0), (False, 8, 45)):
        kw = dict(causal=causal, window=window, sk_valid=valid)
        want = jref(*map(jnp.asarray, (q, k, v)), **kw)
        got = tref.attention_ref(*_torch(q, k, v), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_cpu_path_runs_no_kernel_and_keeps_layout():
    """On the CPU the wrappers run the plain versions (no launch counted);
    the autograd Function keeps the (B, S, H, D) layout and gives k/v
    gradients in their own shape."""
    before = [f.launches for f in (tkernel.flash_fwd, tkernel.flash_bwd_dq,
                                   tkernel.flash_bwd_dkv)]
    q, k, v = _torch(*_inputs(2, 33, 33, 6, 3, 16, 9), grad=True)
    out = tflash(q, k, v, True, 0)
    assert out.shape == q.shape and out.dtype == q.dtype
    out.square().sum().backward()
    assert k.grad.shape == k.shape and v.grad.shape == v.shape
    assert [f.launches for f in (tkernel.flash_fwd, tkernel.flash_bwd_dq,
                                 tkernel.flash_bwd_dkv)] == before


def test_flash_autograd_matches_plain_autograd():
    """The hand-written backward (dq, per-head dk/dv, rep sum, delta)
    against autograd through the plain softmax oracle."""
    q, k, v = _inputs(2, 50, 70, 4, 2, 16, 11)
    grads = []
    for fn in (lambda a, b_, c: tflash(a, b_, c, False, 20),
               lambda a, b_, c: tref.attention_ref(
                   a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
                   causal=False, window=20).transpose(1, 2)):
        ts = _torch(q, k, v, grad=True)
        torch.cos(fn(*ts)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("bad", ["heads", "head_dim", "dtype", "offset",
                                 "no_keys"])
def test_flash_rejects_what_it_cannot_take(bad):
    q, k, v = _torch(*_inputs(1, 8, 8, 4, 2, 16, 0))
    off = torch.zeros((1, 1), dtype=torch.int32)
    if bad == "heads":
        k = v = torch.zeros((1, 8, 3, 16))
    elif bad == "head_dim":
        k = v = torch.zeros((1, 8, 2, 8))
    elif bad == "dtype":
        k = k.double()
    elif bad == "offset":
        off = off.long()
    else:
        k = v = torch.zeros((1, 0, 2, 16))
    with pytest.raises(ValueError):
        tkernel.flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), off, causal=True)
