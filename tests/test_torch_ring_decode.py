"""Ring-buffer decode attention: the port's plain version against the JAX
package's Pallas kernel (interpret mode), and its row invariance; and the
CUDA kernel's split-L order (`csrc/ring_decode.cu`), emulated, against
both.

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
from repro.kernels.flash_attn.ops import \
    ring_decode_attention_ref as jring_ref
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
    # the meta device: no launch, one recorded op of its cost
    # (kernels/costs.py), the result's shape
    from repro_torch.kernels import costs
    seen = []
    before = tkernel.ring_decode.launches
    costs.add_listener(lambda n, c: seen.append((n, c)))
    try:
        out = tkernel.ring_decode(q.to("meta"), k.to("meta"),
                                  v.to("meta"), bias.to("meta"))
    finally:
        costs._LISTENERS.clear()
    assert out.device.type == "meta" and out.shape == q.shape
    assert seen == [("ring_decode", costs.ring_decode(
        q.shape[0], k.shape[1], q.shape[1], q.shape[2]))]
    assert tkernel.ring_decode.launches == before
    tkernel.ring_decode(q, k, v, bias)      # CPU: the plain version
    assert tkernel.ring_decode.launches == before


class _StubLibrary:
    """Stands in for the built ring_decode library: records each launch
    and reports success."""

    def __init__(self):
        self.calls = []

    def ring_decode_launch(self, *args):
        self.calls.append(args)
        return 0


def test_launch_counts_both_kernels(monkeypatch):
    """A call launches the chunk kernel and the merge kernel, and the
    counter counts both: two a call, whatever the shape."""
    lib = _StubLibrary()
    monkeypatch.setattr(tkernel, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    before = tkernel.ring_decode.launches
    for r, l, h, hd in SHAPES + [(4, 300, 2, 8)]:
        q, k, v, bias = (torch.from_numpy(a) for a in _inputs(r, l, h, hd, 0))
        tkernel._launch(q, k, v, bias, torch.empty((r, h, hd)))
    assert tkernel.RING_KERNELS == 2 and len(lib.calls) == 4
    assert tkernel.ring_decode.launches - before == 2 * len(lib.calls)
    # the work buffer holds every chunk's partials (o, max, sum)
    assert lib.calls[-1][6] == 4 * 2 * 3 * (8 + 2)


# ---------------------------------------------------------------------------
# the kernel's split-L order, emulated
# ---------------------------------------------------------------------------


def _split_l(q, k, v, bias, chunk):
    """ring_decode in the CUDA kernel's order, one row at a time: per
    chunk of `chunk` slots its max m_c, sum l_c = sum exp(s - m_c) and
    unnormalised output o_c = sum exp(s - m_c) v; then the chunks merged in
    ascending order, w_c = exp(m_c - m) with m = max m_c, out =
    (sum o_c w_c) / (sum l_c w_c)."""
    scale = torch.tensor(q.shape[-1] ** 0.5, dtype=torch.float32)
    outs = []
    for r in range(q.shape[0]):
        s = torch.einsum("hd,lhd->hl", q[r], k[r]) / scale + bias[r]
        parts = []
        for j0 in range(0, s.shape[1], chunk):
            sc = s[:, j0:j0 + chunk]
            m_c = sc.amax(dim=1)
            e = torch.exp(sc - m_c[:, None])
            parts.append((m_c, e.sum(dim=1),
                          torch.einsum("hl,lhd->hd", e, v[r, j0:j0 + chunk])))
        m = parts[0][0]
        for m_c, _, _ in parts[1:]:
            m = torch.maximum(m, m_c)
        l = torch.zeros_like(m)
        o = torch.zeros_like(q[r])
        for m_c, l_c, o_c in parts:
            w = torch.exp(m_c - m)
            l = l + l_c * w
            o = o + o_c * w[:, None]
        outs.append(o / l[:, None])
    return torch.stack(outs)


def _ring_case(r, l, h, hd, seed, chunk, last_chunk):
    """_inputs, with the valid slots first or, with `last_chunk`, only in
    the last chunk of `chunk` slots (every earlier chunk fully masked)."""
    q, k, v, bias = _inputs(r, l, h, hd, seed)
    if last_chunk:
        rng = np.random.default_rng(seed + 1)
        tail = l - chunk * ((l - 1) // chunk)
        valid = rng.integers(1, tail + 1, size=r)
        bias = np.where(np.arange(l)[None, :] >= l - valid[:, None], 0.0,
                        -1e9).astype(np.float32)
    return q, k, v, bias


# (chunk, L): below, on and across the chunk edges; 128 is the kernel's
SPLIT_CASES = [(128, l) for l in (1, 100, 128, 129, 300)] + [
    (16, l) for l in (1, 15, 16, 17, 50)]


@pytest.mark.parametrize("last_chunk", (False, True),
                         ids=("first_slots", "last_chunk"))
@pytest.mark.parametrize("chunk,l", SPLIT_CASES)
def test_split_l_order_matches_plain_and_jax(chunk, l, last_chunk):
    """Within 1e-5 of the port's plain version and of JAX's
    ring_decode_attention_ref, and every row of a 3-row call bit for bit
    equal to its one-row call.  A fully masked chunk (bias -1e9) gets
    weight exp(m_c - m) = 0 exactly."""
    args = _ring_case(3, l, 4, 16, chunk + l, chunk, last_chunk)
    t_args = [torch.from_numpy(a) for a in args]
    got = _split_l(*t_args, chunk)
    plain = tops.ring_decode_attention_ref(*t_args)
    want = np.asarray(jring_ref(*(jnp.asarray(a) for a in args)))
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i in range(3):
        one = _split_l(*(a[i:i + 1] for a in t_args), chunk)
        assert torch.equal(got[i:i + 1], one)


def test_split_l_masked_chunks_contribute_nothing():
    """With the valid slots in the last chunk only, what the masked chunks
    hold changes no bit of the split-L result."""
    q, k, v, bias = (torch.from_numpy(a)
                     for a in _ring_case(2, 300, 2, 8, 5, 128, True))
    out = _split_l(q, k, v, bias, 128)
    k2, v2 = k.clone(), v.clone()
    k2[:, :256] = 3.0
    v2[:, :256] = -9.0
    assert torch.equal(out, _split_l(q, k2, v2, bias, 128))
