"""The port's flash attention above head dim 128 (recurrentgemma-2b's 256)
against the JAX package's Pallas kernels in interpret mode, as
`tests/test_torch_flash_attn.py` holds D <= 128: the plain versions on
the CPU (the CUDA-core kernels' second head-dimension bound, D <= 256,
and the bf16 tensor-core forward, dq and dk/dv at D 256 are held to them
on the card in `tests/test_torch_gpu.py`; their arithmetic is emulated in
`tests/test_torch_flash_split.py`).

Tolerances are the JAX tests' own: forward within 2e-5 and gradients
within 5e-5 in float32.
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


def _inputs(b, sq, sk, h, g, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, g, d)).astype(np.float32),
            rng.standard_normal((b, sk, g, d)).astype(np.float32))


def _torch(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


def test_head_dim_bound_is_256():
    """The CUDA-core kernels take D up to 256; the tensor-core forward, dq
    and dk/dv are each built for D 64, 128 and 256."""
    assert tkernel.FLASH_MAX_HEAD_DIM == 256
    assert tkernel.FLASH_TC_HEAD_DIMS == {"flash_fwd": (64, 128, 256),
                                          "flash_bwd_dq": (64, 128, 256),
                                          "flash_bwd_dkv": (64, 128, 256)}


# b, sq, h, g, d, causal, window: rep 2 with a window, MQA at rep 10 (the
# recurrentgemma shape, cut in length), non-causal, and D 192
@pytest.mark.parametrize("b,sq,h,g,d,causal,window", [
    (1, 96, 4, 2, 256, True, 32),
    (1, 64, 10, 1, 256, True, 48),
    (1, 70, 2, 1, 256, False, 0),
    (2, 64, 4, 2, 192, True, 0),
])
def test_flash_d256_fwd_and_grads_match_jax(b, sq, h, g, d, causal, window):
    q, k, v = _inputs(b, sq, sq, h, g, d, sq + d)
    fwd = jflash(*map(jnp.asarray, (q, k, v)), causal, window, 32, 32)
    got = tflash(*_torch(q, k, v), causal, window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(fwd),
                               atol=2e-5, rtol=2e-5)
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jflash(
        q, k, v, causal, window, 32, 32))), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = _torch(q, k, v, grad=True)
    torch.sin(tflash(*ts, causal, window)).sum().backward()
    for w, t in zip(want, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-5)


def test_plain_kernels_match_jax_kernels_at_d256():
    """The three plain versions against the three Pallas kernels at D 256,
    rep 2, a window and a query offset: O and lse, dq and the per-head
    dk/dv (B, H, S, D layout)."""
    rng = np.random.default_rng(8)
    q, do = (rng.standard_normal((1, 4, 64, 256)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 64, 256)).astype(np.float32)
            for _ in range(2))
    j_off = jnp.full((1, 1), 16, jnp.int32)
    t_off = torch.full((1, 1), 16, dtype=torch.int32)
    kw = dict(causal=True, window=24)
    jo, jlse = jkernel.flash_attention_bhsd(
        *map(jnp.asarray, (q, k, v)), j_off, rep=2, bq=32, bk=32, **kw)
    to, tlse = tref.flash_fwd_ref(*_torch(q, k, v), t_off, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=2e-5)
    delta = np.sum(do * np.asarray(jo), axis=-1)
    jgrads = jkernel.flash_attention_bwd_bhsd(
        *map(jnp.asarray, (q, k, v, do)), jlse, jnp.asarray(delta)[..., None],
        j_off, rep=2, bq=32, bk=32, **kw)
    targs = _torch(q, k, v, do) + [torch.from_numpy(np.array(jlse)[..., 0]),
                                   torch.from_numpy(delta), t_off]
    tgrads = (tref.flash_bwd_dq_ref(*targs, **kw),
              *tref.flash_bwd_dkv_ref(*targs, **kw))
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-5,
                                   rtol=5e-5)
