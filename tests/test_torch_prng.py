"""The port's threefry PRNG and its copies of XLA's float32 routines,
against JAX 0.9.0 on the CPU, bit for bit.

Keys, `fold_in` (int32 ids that wrap, uint32 ids above 2^31, batched
tensors of ids), `split`, random bits, uniforms and normals over several
keys and the shapes (1,), (7,), (128, 16), (3, 5, 7) and (70000,), plus
2^20 normals in one draw; `log1p`, `erf_inv` and `exp` each over more
than 2 M float32 points covering both of log1p's branches, erf_inv's
w >= 5 tail and exp's flush to zero; the exact float32 fma the copies
rest on, against rational arithmetic.  Also chip_smoke.py's count of the
draw kernel's own SASS instructions (`draw_trip_of`, its bound), on
listings in the two forms nvcc gave the kernel (one normal a trip, and
four with a vector store), the integer divide the kernel finds a stream
with, and the draw wrappers' CPU paths and refusals.

One difference of the reference is shown rather than hidden
(ROADMAP Queue 3): for a uniform whose span is not a power of two, XLA's
CPU code fuses `f * span + minval` into one rounding, where the JAX
source (and the port) round twice.  The JAX package draws no such
uniform.
"""
import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.analysis import sass
from repro_torch.convert import key_from_numpy
from repro_torch.core import prng, xla_f32


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = (0, 1, 42, -7, 2**31 - 1)
SHAPES = ((1,), (7,), (128, 16), (3, 5, 7), (70000,))


def _bits_equal(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("seed", KEYS + (-2**31,))
def test_key_matches_jax(seed):
    assert _bits_equal(jax.random.PRNGKey(seed), prng.key(seed))
    assert torch.equal(key_from_numpy(np.asarray(jax.random.PRNGKey(seed))),
                       prng.key(seed))


def test_key_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="int32"):
        prng.key(2**31)
    with pytest.raises(ValueError):
        prng.fold_in(prng.key(0), 2**32)
    with pytest.raises(ValueError, match="integers"):
        prng.fold_in(prng.key(0), torch.tensor([0.5]))
    with pytest.raises(ValueError, match="uint32"):
        key_from_numpy(np.zeros(3, np.uint32))


@pytest.mark.parametrize("data", (0, 1, 7, 29, 2**31 - 1, -1, -5, 2**31,
                                  2**32 - 1))
def test_fold_in_matches_jax(data):
    """uint32(data) as JAX folds it: an int32 id wraps, an id above 2^31
    folds as the uint32 it is."""
    jdata = np.uint32(data) if data > 2**31 - 1 else jnp.int32(data)
    for seed in (3, -7):
        k = jax.random.PRNGKey(seed)
        assert _bits_equal(jax.random.fold_in(k, jdata),
                           prng.fold_in(prng.key(seed), data))


def test_fold_in_batched_matches_jax():
    """A (S, 2) stack of keys folded with an (S,) tensor of ids, and one
    key with a tensor of ids, in one pass each."""
    ids = np.array([0, 1, -1, 2**31 - 1, -2**31, 12345], np.int32)
    base = jax.random.PRNGKey(9)
    keys = jnp.stack([jax.random.fold_in(base, i) for i in range(6)])
    want = jnp.stack([jax.random.fold_in(keys[i], ids[i]) for i in range(6)])
    got = prng.fold_in(key_from_numpy(np.asarray(keys)),
                       torch.from_numpy(ids))
    assert _bits_equal(want, got)
    want1 = jnp.stack([jax.random.fold_in(base, i) for i in ids])
    assert _bits_equal(want1, prng.fold_in(prng.key(9),
                                           torch.from_numpy(ids)))
    assert prng.fold_in_int(prng.key_ints(prng.key(9)), -1) == \
        tuple(int(v) for v in np.asarray(jax.random.fold_in(
            base, jnp.int32(-1))))


@pytest.mark.parametrize("num", (1, 2, 5, 64, 65, 1568))
def test_split_matches_jax(num):
    for seed in (0, 11):
        assert _bits_equal(jax.random.split(jax.random.PRNGKey(seed), num),
                           prng.split(prng.key(seed), num))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", KEYS)
def test_bits_uniform_normal_match_jax(seed, shape):
    k, tk = jax.random.PRNGKey(seed), prng.key(seed)
    assert _bits_equal(jax.random.bits(k, shape), prng.random_bits(tk, shape))
    assert _bits_equal(jax.random.uniform(k, shape), prng.uniform(tk, shape))
    # a power-of-two span: the fused and the rounded chain agree
    assert _bits_equal(jax.random.uniform(k, shape, minval=-3.0, maxval=5.0),
                       prng.uniform(tk, shape, -3.0, 5.0))
    assert _bits_equal(jax.random.normal(k, shape), prng.normal(tk, shape))


def test_a_million_normals_match_jax():
    n = 1 << 20
    k = jax.random.fold_in(jax.random.PRNGKey(2024), 77)
    assert _bits_equal(jax.random.normal(k, (n,)),
                       prng.normal(key_from_numpy(np.asarray(k)), (n,)))


def test_normal_rows_is_normal_per_stream():
    """Row s of normal_rows(keys, n) is normal(keys[s], (n,)), and a
    stream's prefix does not depend on its length (the counter is the
    flat index), which lets one launch serve streams of two lengths."""
    keys = prng.split(prng.key(5), 3)
    rows = prng.normal_rows(keys, 300)
    for s in range(3):
        assert torch.equal(rows[s], prng.normal(keys[s], (300,)))
        assert torch.equal(rows[s, :129], prng.normal(keys[s], (129,)))
    jk = jax.random.split(jax.random.PRNGKey(5), 3)
    assert _bits_equal(jax.random.normal(jk[1], (20, 15)),
                       rows[1, :300].reshape(20, 15))


def test_uniform_general_span_is_fused_by_xla():
    """ROADMAP Queue 3: XLA's CPU code contracts uniform's
    `f * (maxval - minval) + minval` into one fma.  The port rounds the
    product and the sum as the JAX source writes them; the smallest input
    that shows it is uniform(PRNGKey(3), (7,), -3, 5.5), element 3."""
    k = jax.random.PRNGKey(3)
    f = prng.uniform(prng.key(3), (7,)).numpy().astype(np.float64)
    fused = (f * 8.5 - 3.0).astype(np.float32)
    rounded = (np.float32(f * 8.5) - np.float32(3.0)).astype(np.float32)
    got = prng.uniform(prng.key(3), (7,), -3.0, 5.5).numpy()
    want = np.asarray(jax.random.uniform(k, (7,), minval=-3.0, maxval=5.5))
    assert np.array_equal(got, rounded)
    assert np.array_equal(want, fused)
    assert got[3] != want[3]


def _sweep_log1p():
    g = np.random.default_rng(0)
    return np.concatenate([
        g.uniform(-1, 1, 1_500_000),                  # both branches
        g.uniform(-0.42, 0.42, 300_000),              # around sqrt(2) - 1
        -1 + g.uniform(0, 1e-3, 200_000),             # log of tiny a
        g.uniform(-1, 50, 100_000),
        [-1, 1, 0, -0.0, 0.41421354, -0.41421354, 0.4142135, 1e-30, -1e-30,
         1e-39, -2e-40, 1e-20, 2, -2, np.inf, -np.inf, np.nan],
    ]).astype(np.float32)


def _sweep_erf_inv():
    g = np.random.default_rng(1)
    return np.concatenate([
        g.uniform(-1, 1, 1_600_000),
        1 - g.uniform(0, 1e-2, 200_000),              # w >= 5
        -1 + g.uniform(0, 1e-4, 200_000),
        [-1, 1, 0, 0.9999999, -0.99999994, 1e-39, 2, np.nan],
    ]).astype(np.float32)


def _sweep_exp():
    g = np.random.default_rng(2)
    return np.concatenate([
        g.uniform(-10, 10, 1_500_000),
        g.uniform(-100, 100, 400_000),
        g.uniform(-88, -86, 100_000),                 # flushed subnormals
        [-88, -87.5, 88.5, 89, 0, -0.0, 1e-39, -1e-39, 1e-41, 1.0],
    ]).astype(np.float32)


@pytest.mark.parametrize("name,jfn,tfn,sweep", [
    ("log1p", jnp.log1p, xla_f32.log1p_f32, _sweep_log1p),
    ("erf_inv", jax.lax.erf_inv, xla_f32.erf_inv_f32, _sweep_erf_inv),
    ("exp", jnp.exp, xla_f32.exp_f32, _sweep_exp),
])
def test_xla_float_routine_matches_bit_for_bit(name, jfn, tfn, sweep):
    x = sweep()
    assert x.size >= 2_000_000
    want = np.asarray(jax.jit(jfn)(x))
    got = tfn(torch.from_numpy(x)).numpy()
    same = (want.view(np.int32) == got.view(np.int32)) \
        | (np.isnan(want) & np.isnan(got))
    assert same.all(), (name, x[~same][:5], want[~same][:5], got[~same][:5])


def _fma_exact(a, b, c) -> np.float32:
    """Correctly rounded a * b + c (float32), by rational arithmetic."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda t: (abs(Fraction(float(t)) - v),
                                     int(np.float32(t).view(np.int32)) & 1))


def test_fma_f32_is_one_rounding():
    g = np.random.default_rng(3)
    n = 1500
    a = g.standard_normal(n).astype(np.float32)
    b = g.standard_normal(n).astype(np.float32)
    c = (g.standard_normal(n) * g.choice([1e-9, 1.0, 1e9], n)) \
        .astype(np.float32)
    # products that land a sum on a float32 midpoint (double rounding)
    a[:300] = np.float32(1 + 2.0**-12)
    b[:300] = np.float32(1 + 2.0**-12)
    c[:300] = (np.float32(2.0**-70) * g.choice([-1, 1], 300)).astype(
        np.float32)
    got = xla_f32.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# a grid-stride loop in the form nvcc gave the first design of
# threefry_normal_kernel (trimmed; one normal a trip): the i / n divide
# (a called 64-bit path, a 32-bit fast one), the key's address and
# loads, the counter, work on the key, a constant moved into a register,
# a guarded block (log's), an IEEE divide whose FCHK calls a slow path,
# erf_inv's if / else, the store and the loop's back edge.  Each line's
# note: what the count makes of it
_DRAW_SASS = """Function : draw
        /*0000*/ S2R R2, SR_TID.X ;
        /*0010*/ ISETP.GE.U32.AND P0, PT, R2, UR4, PT ;
        /*0020*/ @P0 EXIT ;
        /*0030*/ ISETP.NE.U32.AND P0, PT, R5, RZ, PT ;
        /*0040*/ @!P0 BRA 0x70 ;
        /*0050*/ CALL.REL.NOINC 0x300 ;
        /*0060*/ BRA 0x90 ;
        /*0070*/ I2F.U32.RP R0, UR9 ;
        /*0080*/ MUFU.RCP R6, R0 ;
        /*0090*/ LEA R8, P0, R6, UR10, 0x4 ;
        /*00a0*/ LDG.E.CONSTANT R0, desc[UR6][R8.64] ;
        /*00b0*/ LDG.E.CONSTANT R3, desc[UR6][R8.64+0x8] ;
        /*00c0*/ IMAD.WIDE.U32 R6, R2, UR16, R4 ;
        /*00d0*/ IADD3 R7, R6, R3, R0 ;
        /*00e0*/ SHF.L.W.U32.HI R6, R7, 0xd, R7 ;
        /*00f0*/ MOV R9, 0x3f7fffff ;
        /*0100*/ FFMA R10, R6, 2, -R9 ;
        /*0110*/ FSETP.NEU.AND P2, PT, R10, RZ, PT ;
        /*0120*/ @!P2 BRA 0x150 ;
        /*0130*/ FMUL R11, R10, R10 ;
        /*0140*/ @!P2 MOV R11, 0xffffffff ;
        /*0150*/ MUFU.RCP R12, R11 ;
        /*0160*/ FCHK P0, R10, R11 ;
        /*0170*/ @!P0 BRA 0x190 ;
        /*0180*/ CALL.REL.NOINC 0x380 ;
        /*0190*/ FSETP.GT.AND P0, PT, R12, -5, PT ;
        /*01a0*/ @P0 BRA 0x1e0 ;
        /*01b0*/ MUFU.RSQ R13, -R12 ;
        /*01c0*/ FADD R13, R13, -3 ;
        /*01d0*/ BRA 0x1f0 ;
        /*01e0*/ FADD R13, -R12, -2.5 ;
        /*01f0*/ FMUL R3, R13, R10 ;
        /*0200*/ LEA R8, P0, R4, UR12, 0x2 ;
        /*0210*/ IMAD.WIDE.U32 R4, R2, 0x100, R4 ;
        /*0220*/ STG.E desc[UR6][R8.64], R3 ;
        /*0230*/ ISETP.GE.U32.AND P0, PT, R4, UR18, PT ;
        /*0240*/ @!P0 BRA 0x30 ;
        /*0250*/ EXIT ;
        /*0260*/ BRA 0x260 ;
        /*0300*/ IADD3 R6, R5, 0x1, RZ ;
        /*0310*/ RET.REL.NODEC R20 0x0 ;
        /*0380*/ FMUL R11, R10, 0.5 ;
        /*0390*/ RET.REL.NODEC R20 0x0 ;
"""


# the redesigned kernel's form (trimmed from its sm_90a listing): a loop
# rotated so that its head is the unit's divide by a multiply-high, one
# 16-byte key load, the key schedule and four counters, a uniform, an
# IEEE divide whose FCHK calls a slow path, a constant moved into a
# register, erf_inv's tail side as four if-then blocks (one a normal),
# the vector store under the kernel's flag and the ragged row end's
# scalar stores it skips, and the back edge
_DRAW4_SASS = """Function : draw4
        /*0000*/ S2R R9, SR_TID.X ;
        /*0010*/ ISETP.GE.U32.AND P0, PT, R9, UR11, PT ;
        /*0020*/ @P0 EXIT ;
        /*0030*/ IMAD.HI.U32 R0, R9, UR6, RZ ;
        /*0040*/ IMAD.IADD R4, R9, 0x1, -R0 ;
        /*0050*/ SHF.R.U32.HI R11, RZ, UR8, R4 ;
        /*0060*/ IMAD.WIDE.U32 R4, R11, 0x10, R2 ;
        /*0070*/ LDG.E.128.CONSTANT R4, desc[UR4][R4.64] ;
        /*0080*/ IMAD R8, R11, UR9, R9 ;
        /*0090*/ LOP3.LUT R0, R4, 0x1bd11bda, R6, 0x96, !PT ;
        /*00a0*/ LEA R13, R8, R6, 0x2 ;
        /*00b0*/ IADD3 R14, R13, 0x1, RZ ;
        /*00c0*/ SHF.L.W.U32.HI R7, R13, 0xd, R13 ;
        /*00d0*/ LOP3.LUT R7, R7, R0, RZ, 0x3c, !PT ;
        /*00e0*/ SHF.L.W.U32.HI R15, R14, 0xd, R14 ;
        /*00f0*/ IMAD.IADD R16, R15, 0x1, R7 ;
        /*0100*/ LEA.HI R17, R16, 0x40000000, RZ, 0x17 ;
        /*0110*/ FADD R17, R17, -2 ;
        /*0120*/ IMAD.MOV.U32 R20, RZ, RZ, 0x383de04b ;
        /*0130*/ FFMA R18, R17, R20, 0.5 ;
        /*0140*/ BSSY B0, 0x1a0 ;
        /*0150*/ MUFU.RCP R19, R18 ;
        /*0160*/ FCHK P0, R17, R18 ;
        /*0170*/ FFMA R21, R19, R17, RZ ;
        /*0180*/ @!P0 BRA 0x1a0 ;
        /*0190*/ CALL.REL.NOINC 0x400 ;
        /*01a0*/ BSYNC B0 ;
        /*01b0*/ FSETP.GT.AND P1, PT, R21, -5, PT ;
        /*01c0*/ @P1 BRA 0x1f0 ;
        /*01d0*/ MUFU.RSQ R22, -R21 ;
        /*01e0*/ FADD R21, R22, -3 ;
        /*01f0*/ FSETP.GT.AND P2, PT, R16, -5, PT ;
        /*0200*/ @P2 BRA 0x230 ;
        /*0210*/ MUFU.RSQ R23, -R16 ;
        /*0220*/ FADD R16, R23, -3 ;
        /*0230*/ FSETP.GT.AND P3, PT, R17, -5, PT ;
        /*0240*/ @P3 BRA 0x270 ;
        /*0250*/ MUFU.RSQ R24, -R17 ;
        /*0260*/ FADD R17, R24, -3 ;
        /*0270*/ FSETP.GT.AND P4, PT, R7, -5, PT ;
        /*0280*/ @P4 BRA 0x2c0 ;
        /*0290*/ MUFU.RSQ R25, -R7 ;
        /*02a0*/ ISETP.NE.AND P5, PT, R7, RZ, PT ;
        /*02b0*/ FADD R7, R25, -3 ;
        /*02c0*/ ISETP.NE.AND P0, PT, RZ, UR10, PT ;
        /*02d0*/ @P0 IMAD.WIDE.U32 R12, R9, 0x10, R12 ;
        /*02e0*/ @P0 STG.E.128 desc[UR4][R12.64], R4 ;
        /*02f0*/ @P0 BRA 0x340 ;
        /*0300*/ ISETP.GE.U32.AND P1, PT, R8, UR12, PT ;
        /*0310*/ @!P1 STG.E desc[UR4][R10.64], R21 ;
        /*0320*/ STG.E desc[UR4][R10.64+0x4], R16 ;
        /*0330*/ STG.E desc[UR4][R10.64+0x8], R17 ;
        /*0340*/ IADD3 R9, R9, UR5, RZ ;
        /*0350*/ ISETP.GE.U32.AND P0, PT, R9, UR11, PT ;
        /*0360*/ @!P0 BRA 0x30 ;
        /*0370*/ EXIT ;
        /*0380*/ BRA 0x380 ;
        /*0400*/ FMUL R21, R17, 0.5 ;
        /*0410*/ RET.REL.NODEC R20 0x0 ;
"""


def _chip_smoke():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    return chip_smoke


def _trip_of(listing, edit=None):
    cs = _chip_smoke()
    text = listing if edit is None else listing.replace(*edit)
    name = listing.split()[2]
    return cs.draw_trip_of(sass.parse_functions(text)[name])


@pytest.mark.parametrize("form", ("one_normal_a_trip", "four_normals_a_trip"))
def test_draw_bound_counts_a_normals_own_instructions(form):
    """A trip in the bulk, and a normal's own work on it: what the keys
    reach, over the normals the trip stores; not the index, divide,
    address, loop control, constant or store.  Where the code takes
    another shape, the count raises.

    One normal a trip (the first design's form): the divide's fast path,
    the guarded block run, the FCHK's call skipped, erf_inv's shorter
    side (28 instructions).  6 on the integer pipe (the add, the rotate, the
    compares, the guarded move), 4 on the FMA pipes, the reciprocal and
    the 3 key-guarded branches; the square root's side is the tail (2).

    Four normals a trip (the redesign's form): one vector store of 16
    bytes, so 4 normals; the FCHK's call and the scalar stores skipped,
    each normal's square-root block the tail (38 instructions, 22 of
    them own: 12 on the integer pipe, 4 FMA, the reciprocal, 5 key-
    guarded branches; 9 on the four tails), each count over 4."""
    cs = _chip_smoke()
    n = 1 << 20
    if form == "one_normal_a_trip":
        trip = _trip_of(_DRAW_SASS)
        assert (trip.trip, trip.normals, trip.stores) == (28, 1, 1)
        assert trip.work == {"alu": 6, "fma": 4, "mufu": 1, "other": 3,
                             "all": 14}
        assert trip.tail == {"alu": 0, "fma": 1, "mufu": 1, "other": 0,
                             "all": 2}
        assert (trip.own(), trip.layout()) == (14, 14)
        # per normal: 14 + 2 x the tail's share of warps at the issue
        # rate, 6 on the integer pipe, 4 FMA-pipe ones (two operations
        # each); so few that the bytes bound it
        ms, by, terms = cs.draw_bound_ms(1, n, trip, 0.5)
        assert terms == {"bytes": 1e3 * (16 + 4 * n) / cs.PEAK_BYTES,
                         "instructions": 1e3 * 15 * n / cs.PEAK_INSTRUCTIONS,
                         "alu": 1e3 * 6 * n / cs.PEAK_INT32_OPS,
                         "fma": 1e3 * 2 * 4.5 * n / cs.PEAK_F32_OPS}
        listing, edits = _DRAW_SASS, (
            (("@!P0 BRA 0x30", "NOP"), "backward branch"),
            (("@!P0 BRA 0x70", "NOP"), "a call on every"),
            (("MUFU.RSQ R13, -R12", "FMUL R13, R12, R12"), "square root"),
            (("BRA 0x1f0", "BRA 0x400"), "leaves the loop"))
    else:
        trip = _trip_of(_DRAW4_SASS)
        assert (trip.trip, trip.normals, trip.stores) == (38, 4, 1)
        assert trip.work == {"alu": 3, "fma": 1, "mufu": 0.25,
                             "other": 1.25, "all": 5.5}
        assert trip.tail == {"alu": 0.25, "fma": 1, "mufu": 1, "other": 0,
                             "all": 2.25}
        assert (trip.own(), trip.layout()) == (5.5, 4)
        # per normal: 5.5 + 2.25 x the share at the issue rate, 3.125 on
        # the integer pipe, 1.5 FMA-pipe ones; the bytes bound it
        ms, by, terms = cs.draw_bound_ms(1, n, trip, 0.5)
        assert terms == {"bytes": 1e3 * ((16 + 4 * n) / cs.PEAK_BYTES),
                         "instructions":
                             1e3 * (6.625 * n / cs.PEAK_INSTRUCTIONS),
                         "alu": 1e3 * (3.125 * n / cs.PEAK_INT32_OPS),
                         "fma": 1e3 * (2 * 1.5 * n / cs.PEAK_F32_OPS)}
        listing, edits = _DRAW4_SASS, (
            (("@!P0 BRA 0x30", "NOP"), "backward branch"),
            (("@!P0 BRA 0x1a0", "NOP"), "a call on every"),
            (("MUFU.RSQ R24, -R17", "FMUL R24, R17, R17"), "square root"),
            (("@P1 BRA 0x1f0", "@P1 BRA 0x500"), "leaves the loop"),
            # run the scalar stores too: 7 normals stored, 4 tails
            (("@P0 BRA 0x340", "NOP"), "4 for 7 normals"))
    assert (ms, by) == (terms["bytes"], "bytes")
    for edit, match in edits:
        with pytest.raises(ValueError, match=match):
            _trip_of(listing, edit)


@pytest.mark.parametrize("d", (1, 2, 3, 5, 7, 512, 513, 1_536_000,
                               2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1))
def test_divider_is_an_exact_integer_divide(d):
    """The draw kernel finds a unit's stream as (t + ((u - t) >> sh1)) >>
    sh2 with t = (u * mul) >> 32 on 32-bit words, from the divisor the
    wrapper precomputes (`kernel._divider`): u // d for every u < 2^32,
    checked at the edges of each quotient and on random u."""
    from repro_torch.kernels.prng.kernel import _divider
    mul, sh1, sh2 = _divider(d)
    assert 0 < mul < 1 << 32 and sh1 in (0, 1) and 0 <= sh2 < 32
    g = np.random.default_rng(d)
    qs = np.unique(np.concatenate([[0, 1, 2, (2**32 - 1) // d],
                                   g.integers(0, (2**32 - 1) // d + 1,
                                              2000)]))
    us = np.concatenate([qs * d, qs * d + d - 1, qs * d - 1,
                         g.integers(0, 2**32, 4000), [2**32 - 1]])
    us = np.unique(us[(us >= 0) & (us < 2**32)]).astype(object)
    for u in us:
        t = (u * mul) >> 32
        assert (t + ((u - t) >> sh1)) >> sh2 == u // d, u
    with pytest.raises(ValueError):
        _divider(0)
    with pytest.raises(ValueError):
        _divider(1 << 32)


def test_draw_wrappers_on_the_cpu_and_refusals():
    """On a CPU tensor the draw and normal_of_bits are their plain
    versions; on the meta device the draw returns its shape and records
    one op of its cost (`kernels/costs.py`), launching and counting
    nothing, while normal_of_bits (no main-path entry) raises; keys of
    another shape or type and bits of another type raise (a CUDA tensor
    launches the kernel or raises: tests/test_torch_gpu.py)."""
    from repro_torch.kernels.prng import kernel as pk
    keys = prng.split(prng.key(3), 5)
    before = pk.threefry_normal.launches
    assert torch.equal(pk.threefry_normal(keys, 37),
                       prng.normal_rows(keys, 37))
    assert pk.threefry_normal.launches == before
    bits = prng.random_bits(prng.key(4), (1000,))
    assert torch.equal(pk.normal_of_bits(bits),
                       prng.normal(prng.key(4), (1000,)))
    with pytest.raises(ValueError, match="normal_of_bits kernel"):
        pk.normal_of_bits(bits.to("meta"))
    with pytest.raises(ValueError, match="int64"):
        pk.normal_of_bits(bits.to(torch.int32))
    from repro_torch.kernels import costs
    seen = []
    costs.add_listener(lambda n, c: seen.append((n, c)))
    try:
        z = pk.threefry_normal(keys.to("meta"), 4)
    finally:
        costs._LISTENERS.clear()
    assert z.device.type == "meta" and tuple(z.shape) == (5, 4)
    assert seen == [("threefry_normal", costs.threefry_normal(5, 4))]
    assert pk.threefry_normal.launches == before
    with pytest.raises(ValueError, match=r"\(S, 2\)"):
        pk.threefry_normal(keys.reshape(-1), 4)
    with pytest.raises(ValueError, match=">= 0"):
        pk.threefry_normal(keys, -1)
