"""Ring-buffer decode attention: the port's plain version against the JAX
package's Pallas kernel (interpret mode), and its row invariance.

Tolerance: rtol = atol = 1e-5.  Both sides compute in float32, but XLA and
PyTorch sum the dot products and the softmax denominator in other orders
(and XLA may turn the divide by sqrt(hd) into a reciprocal multiply), so
the results agree to a few ulps, not bit for bit.  Within the port the
plain version is row-invariant bit for bit: row r of an R-row call equals
a one-row call on that row, the property fused decode rests on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import ring_decode_attention as jring
from repro_torch.kernels.flash_attn import kernel as tkernel
from repro_torch.kernels.flash_attn import ops as tops

# the shapes tests/test_scheduler.py holds the JAX kernel to
SHAPES = [(1, 4, 2, 8), (5, 16, 4, 12), (8, 16, 1, 16)]


def _inputs(r, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((r, h, hd)).astype(np.float32)
    k = rng.standard_normal((r, l, h, hd)).astype(np.float32)
    v = rng.standard_normal((r, l, h, hd)).astype(np.float32)
    valid = rng.integers(1, l + 1, size=r)
    bias = np.where(np.arange(l)[None, :] < valid[:, None], 0.0,
                    -1e9).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("r,l,h,hd", SHAPES)
def test_plain_ring_decode_matches_jax(r, l, h, hd):
    q, k, v, bias = _inputs(r, l, h, hd, r * l + hd)
    want = np.asarray(jring(*(jnp.asarray(a) for a in (q, k, v, bias))))
    got = tops.ring_decode_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v, bias)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r,l,h,hd", SHAPES)
def test_plain_ring_decode_rows_are_invariant(r, l, h, hd):
    q, k, v, bias = (torch.from_numpy(a)
                     for a in _inputs(r, l, h, hd, 7 + r))
    whole = tops.ring_decode_attention_ref(q, k, v, bias)
    for i in range(r):
        one = tops.ring_decode_attention_ref(q[i:i + 1], k[i:i + 1],
                                             v[i:i + 1], bias[i:i + 1])
        assert torch.equal(whole[i:i + 1], one)


def test_plain_ring_decode_on_strided_state_views():
    """The scheduler passes one block's slab of the (rows, depth, L, H, hd)
    state; a strided view gives the bits of its contiguous copy."""
    rng = np.random.default_rng(1)
    state = torch.from_numpy(
        rng.standard_normal((3, 2, 16, 4, 12)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 4, 12)).astype(np.float32))
    bias = torch.zeros(3, 16)
    bias[0, 5:] = -1e9
    kv = state[:, 1]
    assert not kv.is_contiguous()
    assert torch.equal(tops.ring_decode_attention(q, kv, kv, bias),
                       tops.ring_decode_attention(q, kv.contiguous(),
                                                  kv.contiguous(), bias))


def test_masked_slots_do_not_count():
    """Slots with a -1e9 bias get probability zero: changing what they hold
    changes no bit."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 8, 3))
    bias[:, 3:] = -1e9
    out = tops.ring_decode_attention(q, k, v, bias)
    k2, v2 = k.clone(), v.clone()
    k2[:, 3:] = 5.0
    v2[:, 3:] = -7.0
    assert torch.equal(out, tops.ring_decode_attention(q, k2, v2, bias))


def test_wrapper_rejects_bad_shapes_and_devices():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 8, 4))
    with pytest.raises(ValueError, match="shapes do not fit"):
        tkernel.ring_decode(q, k, v[:, :4], bias)
    with pytest.raises(ValueError, match="shapes do not fit"):
        tkernel.ring_decode(q, k, v, bias[:, :4])
    with pytest.raises(ValueError, match="need q"):
        tkernel.ring_decode(q[0], k, v, bias)
    with pytest.raises(ValueError, match="no ring_decode kernel"):
        tkernel.ring_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                            bias.to("meta"))
    before = tkernel.ring_decode.launches
    tkernel.ring_decode(q, k, v, bias)      # CPU: the plain version
    assert tkernel.ring_decode.launches == before
