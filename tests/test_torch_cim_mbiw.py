"""The cim_mbiw kernel's plain PyTorch version against the JAX package.

On the CPU the port's wrapper runs the plain version; it is held bit for
bit to the JAX Pallas kernel (interpret mode) and to the JAX oracles.  The
CUDA kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import digital_ref as jdr
from repro.core.hw import DEFAULT_MACRO
from repro.kernels.cim_mbiw import ops as jops
from repro.kernels.cim_mbiw import ref as jref
from repro_torch.kernels.cim_mbiw import kernel as tkernel
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.kernels.cim_mbiw import ref as tref

# the eight shapes of tests/test_kernels.py: (m, k, n, r_in, r_w, r_out)
SHAPES = [
    (8, 36, 4, 1, 1, 1), (16, 144, 16, 4, 2, 4), (32, 256, 64, 8, 4, 8),
    (100, 1152, 64, 8, 4, 8), (17, 300, 33, 5, 3, 6), (64, 1000, 40, 8, 4, 4),
    (1, 128, 1, 8, 4, 8), (256, 512, 128, 7, 2, 8),
]


def make_case(m, k, n, r_in, r_w, seed, beta_rows=False):
    """Seeded numpy inputs: codes, odd weights, pow2 gains, offsets."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**r_in, size=(m, k)).astype(np.int32)
    full = 2**r_w - 1
    w = (2 * rng.integers(-(full + 1) // 2, (full + 1) // 2, size=(k, n))
         + 1).astype(np.int32)
    gamma = (2.0 ** rng.integers(0, 6, size=n)).astype(np.float32)
    shape = (m, n) if beta_rows else (n,)
    beta = rng.uniform(-16, 16, size=shape).astype(np.float32)
    return x, w, gamma, beta


def layer_g0(k, r_in, r_w, r_out):
    cfg = DEFAULT_MACRO
    units = cfg.units_for_rows(min(k, cfg.n_rows))
    return jdr.adc_gain_factor(r_in, r_w, r_out, units * cfg.rows_per_unit,
                               cfg.swing_efficiency(units), cfg.alpha_adc())


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


@pytest.mark.parametrize("fuse_adc", (True, False))
@pytest.mark.parametrize("beta_rows", (False, True))
@pytest.mark.parametrize("m,k,n,r_in,r_w,r_out", SHAPES)
def test_plain_kernel_matches_pallas(m, k, n, r_in, r_w, r_out, beta_rows,
                                     fuse_adc):
    x, w, gamma, beta = make_case(m, k, n, r_in, r_w, m + k + n, beta_rows)
    g0 = layer_g0(k, r_in, r_w, r_out)
    (jx, jw, jg, jb), (tx, tw, tg, tb) = both(x, w, gamma, beta)
    want = jops.cim_matmul(jx, jw, jg, jb, r_in=r_in, r_out=r_out, g0=g0,
                           interpret=True, fuse_adc=fuse_adc)
    got = tops.cim_matmul(tx, tw, tg, tb, r_in=r_in, r_out=r_out, g0=g0,
                          fuse_adc=fuse_adc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if fuse_adc:
        oracle = jref.cim_matmul_ref(jx, jw, jg, jb, g0=g0, r_out=r_out)
        np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


@pytest.mark.parametrize("seed", range(3))
def test_fma_canary_gives_rounded_chain(seed):
    """On the canary, a fused multiply-add would move codes; the plain
    version (and the JAX oracle) give the contract's rounded chain."""
    c = tref.fma_canary(seed)
    assert np.any(c["codes"] != c["codes_fma"])
    (jx, jw, jg, jb), (tx, tw, tg, tb) = both(c["x"], c["w"], c["gamma"],
                                              c["beta"])
    for got in (tops.cim_matmul(tx, tw, tg, tb, r_in=8, r_out=c["r_out"],
                                g0=c["g0"]),
                tref.cim_matmul_ref(tx, tw, tg, tb, g0=c["g0"],
                                    r_out=c["r_out"])):
        np.testing.assert_array_equal(got.numpy(), c["codes"])
    want = jref.cim_matmul_ref(jx, jw, jg, jb, g0=c["g0"], r_out=c["r_out"])
    np.testing.assert_array_equal(np.asarray(want), c["codes"])


@pytest.mark.parametrize("r_in", (None, 3, 7, 8))
def test_split_planes_matches_jax(r_in):
    rng = np.random.default_rng(3)
    bits = 8 if r_in is None else r_in
    x = rng.integers(0, 2**bits, size=(9, 13)).astype(np.int32)
    for shift in (None, 1, 4):
        if r_in is None and shift is None:
            continue
        r = bits
        jp, jn = jops.split_planes(jnp.asarray(x), r, shift)
        tp, tn = tops.split_planes(torch.from_numpy(x), r, shift)
        assert jn == tn and tp.dtype == torch.int8
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("rows,k,n", [(1, 9, 16), (200704, 9, 16),
                                      (50176, 144, 32), (256, 784, 64),
                                      (256, 128, 10), (17, 1152, 300)])
def test_block_candidates_match_jax(rows, k, n):
    """Each package lists the schedule tuner's space for one dispatched
    tile, its own shape's choice among them: JAX the Pallas blocks
    clamped to the tile, the port the Hopper tiles of the route the tile
    takes (`kernel.legal_tiles`), each of which that route runs in place
    of its own.  The Pallas blocks a variant records clamp as JAX's."""
    assert jops.block_candidates(rows, k, n)
    for planes in (1, 2):
        cands = tops.block_candidates(rows, k, n, planes)
        assert cands == tkernel.legal_tiles(rows, n, k, planes)
        own = tkernel.route_for(rows, n, k, planes)
        assert own.tile in cands and len(set(cands)) == len(cands)
        for tile in cands:
            r = tkernel.route_for(rows, n, k, planes, tile)
            assert r.tuned and r.tile == tile and r.name == own.name
    for pref in (8, 128, 256, 512):
        assert tops._clamp_block(pref, k) == jops._clamp_block(pref, k)


def test_kernel_variant_cache_and_precision():
    a = tops.kernel_variant_for_tile(tops.KernelPrecision(8, 4, 8), 100, 1152,
                                     64, bm=128, bn=128, bk=256)
    b = tops.kernel_variant_for_tile(tops.KernelPrecision(5, 2, 8), 100, 1152,
                                     64, bm=128, bn=128, bk=256)
    assert a is b                       # r_in 5-8 share the nibble walk
    assert (a.plane_shift, a.n_planes, a.blocks) == (4, 2, (104, 64, 256))
    with pytest.raises(ValueError):
        tops.KernelPrecision(9, 4, 8)
    assert tkernel.plane_layout(2) == (1, 2)


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    x, w, gamma, beta = make_case(5, 40, 6, 4, 2, 0)
    before = tkernel.cim_mbiw_matmul_planes.launches
    planes, _ = tops.split_planes(torch.from_numpy(x), 4, 4)
    out = tkernel.cim_mbiw_matmul_planes(
        planes, torch.from_numpy(w).to(torch.int8),
        torch.from_numpy(gamma)[None], torch.from_numpy(beta)[None],
        plane_shift=4, g0=0.01, r_out=8)
    assert out.shape == (5, 6)
    assert tkernel.cim_mbiw_matmul_planes.launches == before
    with pytest.raises(ValueError):
        tkernel.cim_mbiw_matmul_planes(
            planes, torch.from_numpy(w).to(torch.int8),
            torch.from_numpy(gamma)[None, :3], torch.from_numpy(beta)[None],
            plane_shift=4, g0=0.01, r_out=8)


def test_cim_linear_matches_jax():
    x, w, gamma, beta = make_case(16, 2000, 32, 8, 4, 11)
    (jx, jw, jg, jb), (tx, tw, tg, tb) = both(x, w, gamma, beta)
    want = jops.cim_linear(jx, jw, jg, jb, r_in=8, r_w=4, r_out=8)
    got = tops.cim_linear(tx, tw, tg, tb, r_in=8, r_w=4, r_out=8)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
