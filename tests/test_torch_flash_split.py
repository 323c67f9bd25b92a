"""The arithmetic of the tensor-core flash kernels (`flash_fwd_tc.cu`,
`flash_bwd_dq_tc.cu`, `flash_bwd_dkv_tc.cu`), emulated in plain PyTorch
on the CPU, against the port's plain versions (`ref.flash_fwd_ref`,
`ref.flash_bwd_dq_ref`, `ref.flash_bwd_dkv_ref`).

The kernels multiply bf16 inputs on the tensor cores: a bf16 x bf16
product is exact in float32 and the sums are float32.  The softmax
probabilities P and the score gradients dS are float32, and the kernels
feed them to the tensor cores as two bf16 pieces, hi = bf16(x) and lo =
bf16(x - hi), leaving at most 2^-18 of each term.  The emulation does the
same: float32 products of bf16-exact values, the pieces rounded with
torch's bf16 rounding (round to nearest even, as the kernels' cvt.rn),
the forward as the kernels' online softmax over 128-key tiles (64-key
tiles at D 256) with the scale applied after the product, the backward's
scores as two chains over the halves of D added in float32.  At D 256
the dk/dv and dq kernels form S and dP for (query, key) tiles and pass
the pieces of P and dS through shared memory; dq there sums its 64-key
tiles in order, each warpgroup over half of D's columns.

Two pieces hold the float32 limits the card is held to (2e-5 forward,
5e-5 dq, dk and dv).  One piece, the control, does not: it shows that the
limit is sharp enough to need the split.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import ref as tref

NEG_INF = tref.NEG_INF
KEY_TILE = 128   # the forward kernel's key tile
KEY_TILE_D256 = 64   # and at D 256
F_TOL, B_TOL = 2e-5, 5e-5

# sq, sk, rep, causal, window (B 1, H 2, D 64)
CASES = [
    (77, 77, 1, True, 0),
    (128, 128, 2, False, 0),
    (256, 256, 1, True, 64),
    (100, 256, 2, False, 0),
]


def _inputs(sq, sk, rep, seed, d=64):
    """q, dO (1, 2, Sq, d) and k, v (1, 2 / rep, Sk, d): float32 holding
    bf16-exact values, so both sides multiply the same numbers."""
    rng = np.random.default_rng(seed)
    h, g = 2, 2 // rep

    def bf16(shape):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(torch.bfloat16).float()
    return (bf16((1, h, sq, d)), bf16((1, g, sk, d)), bf16((1, g, sk, d)),
            bf16((1, h, sq, d)))


def _pieces(x, n):
    """x as the sum of n bf16 pieces (n = 1: one rounding)."""
    out, rest = [], x
    for _ in range(n):
        piece = rest.to(torch.bfloat16).float()
        out.append(piece)
        rest = rest - piece
    return out


def _split_matmul(a, b, n):
    """a . b with a cut into n bf16 pieces and b bf16-exact: one float32
    product per piece, summed in float32, as the tensor cores run it."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for piece in _pieces(a, n):
        acc = acc + torch.matmul(piece, b)
    return acc


def _kv_heads(t, rep):
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _emulated_fwd(q, k, v, q_off, causal, window, n, key_tile=KEY_TILE):
    """The forward kernel's arithmetic: per key tile (128 keys, 64 at D
    256) s = scale * (q . k), masked (-1e30) or absent (-inf past Sk), the
    online softmax in float32, O += P . V with P in n bf16 pieces;
    O / max(l, 1e-30)."""
    rep = q.shape[1] // k.shape[1]
    kf, vf = _kv_heads(k, rep), _kv_heads(v, rep)
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / d ** 0.5
    keep = tref.flash_keep_mask(sq, sk, q_off, causal=causal, window=window)
    m = torch.full(q.shape[:3] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, sk, key_tile):
        k1 = min(k0 + key_tile, sk)
        s = scale * torch.matmul(q, kf[:, :, k0:k1].transpose(-1, -2))
        s = torch.where(keep[:, k0:k1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _split_matmul(p, vf[:, :, k0:k1], n)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return acc / l_safe, (m + torch.log(l_safe))[..., 0]


def _emulated_dkv(q, k, v, do, lse, delta, q_off, causal, window, n):
    """The dk/dv kernel's arithmetic: P^T = exp(scale * (k . q) - lse)
    where kept, dS^T = P^T (dP^T - delta) scale, then dV = P^T . dO and
    dK = dS^T . Q with P^T and dS^T in n bf16 pieces."""
    rep = q.shape[1] // k.shape[1]
    kf, vf = _kv_heads(k, rep), _kv_heads(v, rep)
    scale = 1.0 / q.shape[3] ** 0.5
    keep = tref.flash_keep_mask(q.shape[2], k.shape[2], q_off,
                                causal=causal, window=window)
    st = scale * torch.matmul(kf, q.transpose(-1, -2))
    pt = torch.where(keep.T, torch.exp(st - lse[..., None, :]), 0.0)
    dpt = torch.matmul(vf, do.transpose(-1, -2))
    dst = pt * (dpt - delta[..., None, :]) * scale
    return _split_matmul(dst, q, n), _split_matmul(pt, do, n)


def _emulated_dkv_d256(q, k, v, do, lse, delta, q_off, causal, window, n):
    """The D 256 dk/dv kernel's arithmetic: s = scale * (q . k) with q . k
    as two float32 chains over the halves of D, added; P = exp(s - lse)
    where kept, dS = P (dP - delta) scale with dP = dO . v one chain; then
    dV = P^T . dO and dK = dS^T . Q with P and dS in n bf16 pieces (each
    warpgroup over its half of D's columns: the same sums)."""
    rep = q.shape[1] // k.shape[1]
    kf, vf = _kv_heads(k, rep), _kv_heads(v, rep)
    half = q.shape[3] // 2
    scale = 1.0 / q.shape[3] ** 0.5
    keep = tref.flash_keep_mask(q.shape[2], k.shape[2], q_off,
                                causal=causal, window=window)
    dot = (torch.matmul(q[..., :half], kf[..., :half].transpose(-1, -2))
           + torch.matmul(q[..., half:], kf[..., half:].transpose(-1, -2)))
    p = torch.where(keep, torch.exp(scale * dot - lse[..., None]), 0.0)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (_split_matmul(ds.transpose(-1, -2), q, n),
            _split_matmul(p.transpose(-1, -2), do, n))


def _emulated_dq(q, k, v, do, lse, delta, q_off, causal, window, n):
    """The dq kernel's arithmetic: s = scale * (q . k) with q . k as two
    float32 chains over the halves of D, added; P = exp(s - lse) where
    kept, dS = P (dP - delta) scale, then dQ = dS . K with dS in n bf16
    pieces."""
    rep = q.shape[1] // k.shape[1]
    kf, vf = _kv_heads(k, rep), _kv_heads(v, rep)
    half = q.shape[3] // 2
    scale = 1.0 / q.shape[3] ** 0.5
    keep = tref.flash_keep_mask(q.shape[2], k.shape[2], q_off,
                                causal=causal, window=window)
    dot = (torch.matmul(q[..., :half], kf[..., :half].transpose(-1, -2))
           + torch.matmul(q[..., half:], kf[..., half:].transpose(-1, -2)))
    p = torch.where(keep, torch.exp(scale * dot - lse[..., None]), 0.0)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return _split_matmul(ds, kf, n)


def _emulated_dq_d256(q, k, v, do, lse, delta, q_off, causal, window, n,
                      key_tile=KEY_TILE_D256):
    """The D 256 dq kernel's arithmetic: per 64-key tile s = scale * (q .
    k) with q . k as two float32 chains over the halves of D, added; P =
    exp(s - lse) where kept, dS = P (dP - delta) scale with dP = dO . v one
    chain; then dQ += dS_tile . K_tile with dS in n bf16 pieces, piece by
    piece and tile by tile in the kernel's order, each warpgroup over its
    half of D's columns."""
    rep = q.shape[1] // k.shape[1]
    kf, vf = _kv_heads(k, rep), _kv_heads(v, rep)
    sk, d = k.shape[2], q.shape[3]
    half = d // 2
    scale = 1.0 / d ** 0.5
    keep = tref.flash_keep_mask(q.shape[2], sk, q_off, causal=causal,
                                window=window)
    cols = []
    for c0 in (0, half):
        acc = torch.zeros(q.shape[:3] + (half,), dtype=torch.float32)
        for k0 in range(0, sk, key_tile):
            kt = kf[:, :, k0:k0 + key_tile]
            kt_t = kt.transpose(-1, -2)
            dot = (torch.matmul(q[..., :half], kt_t[..., :half, :])
                   + torch.matmul(q[..., half:], kt_t[..., half:, :]))
            p = torch.where(keep[:, k0:k0 + key_tile],
                            torch.exp(scale * dot - lse[..., None]), 0.0)
            dp = torch.matmul(do, vf[:, :, k0:k0 + key_tile].transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            for piece in _pieces(ds, n):
                acc = acc + torch.matmul(piece, kt[..., c0:c0 + half])
        cols.append(acc)
    return torch.cat(cols, dim=-1)


def _case(sq, sk, rep, causal, window, seed, d=64):
    q, k, v, do = _inputs(sq, sk, rep, seed, d)
    q_off = torch.zeros((1, 1), dtype=torch.int32)
    kw = dict(causal=causal, window=window)
    o_ref, lse_ref = tref.flash_fwd_ref(q, k, v, q_off, **kw)
    delta = torch.sum(do * o_ref, dim=-1)
    bwd = (q, k, v, do, lse_ref, delta, q_off)
    return q, k, v, do, q_off, kw, o_ref, lse_ref, bwd


def _outside(got, want, tol):
    return not torch.allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,rep,causal,window", CASES)
def test_two_piece_forward_within_float32_limits(sq, sk, rep, causal,
                                                 window):
    q, k, v, _, q_off, kw, o_ref, lse_ref, _ = _case(sq, sk, rep, causal,
                                                     window, sq + sk)
    o, lse = _emulated_fwd(q, k, v, q_off, causal, window, 2)
    torch.testing.assert_close(o, o_ref, rtol=F_TOL, atol=F_TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=F_TOL, atol=F_TOL)


@pytest.mark.parametrize("sq,sk,rep,causal,window", CASES)
def test_two_piece_dkv_within_float32_limits(sq, sk, rep, causal, window):
    *_, kw, _, _, bwd = _case(sq, sk, rep, causal, window, sq + sk)
    dk, dv = _emulated_dkv(*bwd, causal, window, 2)
    dk_ref, dv_ref = tref.flash_bwd_dkv_ref(*bwd, **kw)
    torch.testing.assert_close(dk, dk_ref, rtol=B_TOL, atol=B_TOL)
    torch.testing.assert_close(dv, dv_ref, rtol=B_TOL, atol=B_TOL)


@pytest.mark.parametrize("sq,sk,rep,causal,window", CASES)
def test_two_piece_dq_within_float32_limits(sq, sk, rep, causal, window):
    *_, kw, _, _, bwd = _case(sq, sk, rep, causal, window, sq + sk)
    dq = _emulated_dq(*bwd, causal, window, 2)
    torch.testing.assert_close(dq, tref.flash_bwd_dq_ref(*bwd, **kw),
                               rtol=B_TOL, atol=B_TOL)


# the forward and dk/dv (ids as the cases), and dq
ONE_PIECE = ([pytest.param(*c, "fwd_dkv", id="-".join(map(str, c)))
              for c in CASES]
             + [pytest.param(*c, "dq", id="dq-" + "-".join(map(str, c)))
                for c in CASES])


@pytest.mark.parametrize("sq,sk,rep,causal,window,kernel", ONE_PIECE)
def test_one_piece_breaks_the_limits(sq, sk, rep, causal, window, kernel):
    """The control: P and dS rounded to bf16 once put O outside 2e-5 and
    dq, dk and dv outside 5e-5 (dv by more than 20x), so the limits see
    the rounding the split removes."""
    q, k, v, _, q_off, kw, o_ref, _, bwd = _case(sq, sk, rep, causal,
                                                 window, sq + sk)
    if kernel == "dq":
        dq = _emulated_dq(*bwd, causal, window, 1)
        assert _outside(dq, tref.flash_bwd_dq_ref(*bwd, **kw), B_TOL)
        return
    o, _ = _emulated_fwd(q, k, v, q_off, causal, window, 1)
    dk, dv = _emulated_dkv(*bwd, causal, window, 1)
    dk_ref, dv_ref = tref.flash_bwd_dkv_ref(*bwd, **kw)
    assert _outside(o, o_ref, F_TOL)
    assert _outside(dk, dk_ref, B_TOL) and _outside(dv, dv_ref, B_TOL)
    assert float((dv - dv_ref).abs().max()) > 20 * B_TOL


# D 256, recurrentgemma-2b's head dim, at the kernels' own tiles: sq, sk,
# rep, causal, window (B 1, H 2); ragged edges of the 64-key tiles, a
# window that skips key tiles, rows that keep no key
D256_CASES = [
    (77, 77, 1, True, 0),
    (130, 200, 2, False, 0),
    (200, 200, 2, True, 64),
    (160, 40, 1, True, 24),
]


@pytest.mark.parametrize("sq,sk,rep,causal,window", D256_CASES)
def test_two_piece_forward_d256_within_float32_limits(sq, sk, rep, causal,
                                                      window):
    q, k, v, _, q_off, kw, o_ref, lse_ref, _ = _case(
        sq, sk, rep, causal, window, sq + sk, d=256)
    o, lse = _emulated_fwd(q, k, v, q_off, causal, window, 2,
                           key_tile=KEY_TILE_D256)
    torch.testing.assert_close(o, o_ref, rtol=F_TOL, atol=F_TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=F_TOL, atol=F_TOL)


@pytest.mark.parametrize("sq,sk,rep,causal,window", D256_CASES)
def test_two_piece_dkv_d256_within_float32_limits(sq, sk, rep, causal,
                                                  window):
    *_, kw, _, _, bwd = _case(sq, sk, rep, causal, window, sq + sk, d=256)
    dk, dv = _emulated_dkv_d256(*bwd, causal, window, 2)
    dk_ref, dv_ref = tref.flash_bwd_dkv_ref(*bwd, **kw)
    torch.testing.assert_close(dk, dk_ref, rtol=B_TOL, atol=B_TOL)
    torch.testing.assert_close(dv, dv_ref, rtol=B_TOL, atol=B_TOL)


@pytest.mark.parametrize("sq,sk,rep,causal,window", D256_CASES)
def test_two_piece_dq_d256_within_float32_limits(sq, sk, rep, causal,
                                                 window):
    *_, kw, _, _, bwd = _case(sq, sk, rep, causal, window, sq + sk, d=256)
    dq = _emulated_dq_d256(*bwd, causal, window, 2)
    torch.testing.assert_close(dq, tref.flash_bwd_dq_ref(*bwd, **kw),
                               rtol=B_TOL, atol=B_TOL)


@pytest.mark.parametrize("sq,sk,rep,causal,window", D256_CASES)
def test_one_piece_dq_d256_breaks_the_limit(sq, sk, rep, causal, window):
    """The control for dq at D 256: dS rounded to bf16 once puts dq
    outside 5e-5."""
    *_, kw, _, _, bwd = _case(sq, sk, rep, causal, window, sq + sk, d=256)
    dq = _emulated_dq_d256(*bwd, causal, window, 1)
    assert _outside(dq, tref.flash_bwd_dq_ref(*bwd, **kw), B_TOL)


@pytest.mark.parametrize("sq,sk,rep,causal,window", D256_CASES)
def test_one_piece_d256_breaks_the_limits(sq, sk, rep, causal, window):
    """The control at D 256: P and dS rounded to bf16 once put O outside
    2e-5 and dk and dv outside 5e-5."""
    q, k, v, _, q_off, kw, o_ref, _, bwd = _case(
        sq, sk, rep, causal, window, sq + sk, d=256)
    o, _ = _emulated_fwd(q, k, v, q_off, causal, window, 1,
                         key_tile=KEY_TILE_D256)
    dk, dv = _emulated_dkv_d256(*bwd, causal, window, 1)
    dk_ref, dv_ref = tref.flash_bwd_dkv_ref(*bwd, **kw)
    assert _outside(o, o_ref, F_TOL)
    assert _outside(dk, dk_ref, B_TOL) and _outside(dv, dv_ref, B_TOL)
