"""The port's threefry PRNG and its copies of XLA's float32 routines,
against JAX 0.9.0 on the CPU, bit for bit.

Keys, `fold_in` (int32 ids that wrap, uint32 ids above 2^31, batched
tensors of ids), `split`, random bits, uniforms and normals over several
keys and the shapes (1,), (7,), (128, 16), (3, 5, 7) and (70000,), plus
2^20 normals in one draw; `log1p`, `erf_inv` and `exp` each over more
than 2 M float32 points covering both of log1p's branches, erf_inv's
w >= 5 tail and exp's flush to zero; the exact float32 fma the copies
rest on, against rational arithmetic.  Also chip_smoke.py's count of the
draw kernel's own SASS instructions (`draw_trip_of`, its bound), on a
listing in the form nvcc gives the kernel.

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


# a grid-stride loop in the form nvcc gives threefry_normal_kernel's
# (trimmed): the i / n divide (a called 64-bit path, a 32-bit fast one),
# the key's address and loads, the counter, work on the key, a constant
# moved into a register, a guarded block (log's), an IEEE divide whose
# FCHK calls a slow path, erf_inv's if / else, the store and the loop's
# back edge.  Each line's note: what the count makes of it
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


def _chip_smoke():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    return chip_smoke


def test_draw_bound_counts_a_normals_own_instructions():
    """The trip of a normal in the bulk: the divide's fast path, the
    guarded block run, the FCHK's call skipped, erf_inv's shorter side
    (28 instructions).  Its own work is what the key reaches: 6 on the
    integer pipe (the add, the rotate, the compares, the guarded move),
    4 on the FMA pipes, the reciprocal and the 3 key-guarded branches;
    not the index, divide, address, loop control, constant or store.
    The square root's side is the tail (2 more).  Where the code takes
    another shape, the count raises."""
    cs = _chip_smoke()
    trip = cs.draw_trip_of(sass.parse_functions(_DRAW_SASS)["draw"])
    assert (trip.trip, trip.stores) == (28, 1)
    assert trip.work == {"alu": 6, "fma": 4, "mufu": 1, "other": 3,
                         "all": 14}
    assert trip.tail == {"alu": 0, "fma": 1, "mufu": 1, "other": 0,
                         "all": 2}
    # per normal: 14 + 2 x the tail's share of warps at the issue rate,
    # 6 on the integer pipe, 4 FMA-pipe ones (two operations each); so
    # few that the bytes bound it
    n = 1 << 20
    ms, by, terms = cs.draw_bound_ms(1, n, trip, 0.5)
    assert terms == {"bytes": 1e3 * (16 + 4 * n) / cs.PEAK_BYTES,
                     "instructions": 1e3 * 15 * n / cs.PEAK_INSTRUCTIONS,
                     "alu": 1e3 * 6 * n / cs.PEAK_INT32_OPS,
                     "fma": 1e3 * 2 * 4.5 * n / cs.PEAK_F32_OPS}
    assert (ms, by) == (terms["bytes"], "bytes")
    for edit, match in ((("@!P0 BRA 0x30", "NOP"), "backward branch"),
                        (("@!P0 BRA 0x70", "NOP"), "a call on every"),
                        (("MUFU.RSQ R13, -R12", "FMUL R13, R12, R12"),
                         "square root"),
                        (("BRA 0x1f0", "BRA 0x400"), "leaves the loop")):
        with pytest.raises(ValueError, match=match):
            cs.draw_trip_of(sass.parse_functions(
                _DRAW_SASS.replace(*edit))["draw"])
