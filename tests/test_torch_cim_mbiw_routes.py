"""The routes of the port's cim_mbiw kernel, held on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold them to the plain version there).  What a CPU can hold
is the choice of route and the integer arithmetic of each route:

  * the route table: `kernel.route_for` on every LeNet tile at batch 256
    and 1, every decode tile, the full-macro tile, the FMA canary and
    ragged shapes, and no TMA operand with an unaligned stride;
  * each route's integer walk, emulated with int64 numpy arrays reduced
    mod 2^32 as the kernels' int32 accumulators wrap: route A ("tc") K
    zero-padded to whole 128-value stages of four 32-value k-steps with
    one accumulator per plane, combined as acc0 + (acc1 << shift); route B
    ("splitk") the planes combined per element, K in chunks, the chunk
    sums added in permuted orders; route C ("cuda_core") K stages of 32
    with each plane's partial scaled into one accumulator;
  * the ADC epilogue as the kernels round it (each float32 step on its
    own), applied to the emulated dp, the FMA canary included.

The schedule tuner's tiles (`kernel.legal_tiles`, a tile `route_for`
runs in place of its own) are held too: every legal tile of each route -
route A's (BM, BN) blocks, split-K at every KC, route C's widths - walked
block by block with the ragged edges zero-filled as the kernels mask
them, gives the plain version's dp and codes bit for bit.

Each is held bit for bit against the plain version and against the JAX
Pallas kernel in interpret mode, on random inputs (the JAX kernel's
interpret mode contracts the epilogue into an FMA on canary-class inputs,
a fault of the frozen reference; only the plain version and the JAX
oracle are held on the canary).  And the fakequant forward stays bit-equal
to JAX with TF32 requested, leaving the caller's setting as it found it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_layers as jcl
from repro.kernels.cim_mbiw import ops as jops
from repro.kernels.cim_mbiw import ref as jref
from repro_torch.core import cim_layers as tcl
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.kernels.cim_mbiw import kernel as tk
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.kernels.cim_mbiw import ref as tref
from repro_torch.models import cnn

from test_torch_cim_mbiw import layer_g0, make_case

MASK = (1 << 32) - 1


# -- the route table --------------------------------------------------------

# (label, m, n, k, planes) -> (route, bm, bn, kc)
TABLE = [
    # LeNet at batch 256, (4, 2) then (8, 4): conv1, conv2, fc1, fc2
    ("conv1 (4,2)", 200704, 16, 9, 1, ("cuda_core", 256, 16, 0)),
    ("conv2 (4,2)", 50176, 32, 144, 1, ("tc", 128, 32, 0)),
    ("fc1 (4,2)", 256, 128, 784, 1, ("tc", 64, 16, 0)),
    ("fc2 (4,2)", 256, 10, 128, 1, ("tc", 64, 16, 0)),
    ("conv1 (8,4)", 200704, 16, 9, 2, ("cuda_core", 256, 16, 0)),
    ("conv2 (8,4)", 50176, 32, 144, 2, ("tc", 128, 32, 0)),
    ("fc1 (8,4)", 256, 64, 784, 2, ("tc", 64, 16, 0)),
    ("fc2 (8,4)", 256, 10, 128, 2, ("tc", 64, 16, 0)),
    # LeNet at batch 1
    ("conv1 b1", 784, 16, 9, 2, ("cuda_core", 256, 16, 0)),
    ("conv2 b1", 196, 32, 144, 2, ("tc", 64, 16, 0)),
    ("fc1 b1 (4,2)", 1, 128, 784, 1, ("splitk", 0, 64, 12)),
    ("fc1 b1 (8,4)", 1, 64, 784, 2, ("splitk", 0, 64, 8)),
    ("fc2 b1", 1, 10, 128, 2, ("splitk", 0, 64, 8)),
    # decode tiles: M 1-4, K 1024, N 128 at (4, 2), 64 at (8, 4)
    ("decode M1 (4,2)", 1, 128, 1024, 1, ("splitk", 0, 64, 16)),
    ("decode M4 (4,2)", 4, 128, 1024, 1, ("splitk", 0, 64, 16)),
    ("decode M1 (8,4)", 1, 64, 1024, 2, ("splitk", 0, 64, 8)),
    ("decode M4 (8,4)", 4, 64, 1024, 2, ("splitk", 0, 64, 8)),
    ("decode M3 (8,4)", 3, 64, 1024, 2, ("splitk", 0, 64, 8)),
    # the full-macro tile and the FMA canary
    ("full macro", 16384, 256, 1152, 2, ("tc", 128, 64, 0)),
    ("canary", 64, 64, 144, 2, ("tc", 64, 16, 0)),
    # ragged shapes and the edges between routes
    ("ragged 17x300x33", 17, 33, 300, 2, ("splitk", 0, 64, 8)),
    ("ragged 100x1152x64", 100, 64, 1152, 2, ("tc", 64, 16, 0)),
    ("ragged 1x9x1", 1, 1, 9, 2, ("cuda_core", 256, 16, 0)),
    ("K 37 unaligned", 129, 65, 37, 2, ("cuda_core", 64, 64, 0)),
    ("K 200 unaligned", 70, 40, 200, 2, ("cuda_core", 64, 64, 0)),
    ("M 63", 63, 16, 64, 2, ("splitk", 0, 64, 8)),
    ("M 64", 64, 16, 64, 2, ("tc", 64, 16, 0)),
    ("M 127", 127, 33, 64, 1, ("tc", 64, 16, 0)),
    ("M 128", 128, 33, 64, 1, ("tc", 64, 16, 0)),
    ("K 31", 256, 16, 31, 1, ("cuda_core", 256, 16, 0)),
    ("K 32", 256, 16, 32, 1, ("tc", 64, 16, 0)),
    ("K 32 M 1", 1, 16, 32, 1, ("splitk", 0, 64, 8)),
    ("three planes", 256, 64, 144, 3, ("cuda_core", 64, 64, 0)),
    ("N 300", 256, 300, 128, 1, ("tc", 64, 16, 0)),
    ("N 300 two planes", 256, 300, 128, 2, ("tc", 64, 16, 0)),
    ("N 65 two planes", 64, 65, 128, 2, ("tc", 64, 16, 0)),
    ("full macro P1", 16384, 256, 1152, 1, ("tc", 128, 128, 0)),
    # a grid of a few waves: the largest tile that still fills one
    ("1024x2048x512", 1024, 512, 2048, 2, ("tc", 64, 32, 0)),
    ("M 8448 N 16", 8448, 16, 64, 1, ("tc", 64, 16, 0)),
    ("M 16896 N 16", 16896, 16, 64, 1, ("tc", 128, 16, 0)),
    ("N 33 core", 70, 33, 9, 1, ("cuda_core", 64, 64, 0)),
    ("N 17 core", 70, 17, 9, 1, ("cuda_core", 128, 32, 0)),
]


@pytest.mark.parametrize("label,m,n,k,planes,want", TABLE,
                         ids=[t[0] for t in TABLE])
def test_route_table(label, m, n, k, planes, want):
    r = tk.route_for(m, n, k, planes)
    assert (r.name, r.bm, r.bn, r.kc) == want
    if r.name == "tc":
        # TMA reads x as (K, P, M): the plane and row strides, K and P * K
        # bytes, must be multiples of 16
        assert k % 16 == 0 and (planes * k) % 16 == 0 and planes <= 2
        assert r.grid == (-(-n // r.bn), -(-m // r.bm))
        # the plane accumulators take at most 64 registers a thread
        assert r.bn in tk.TC_BN and r.bn * planes <= 128
        assert r.bm in tk.TC_BM and (r.bm == 64 or m >= 128)
        # a wave of blocks, or the narrowest tile when none fills one
        assert r.grid[0] * r.grid[1] >= tk.WAVE or (r.bm, r.bn) == (64, 16)
    elif r.name == "splitk":
        assert m < 64 and k >= 32 and 1 <= r.kc <= 128
        assert r.grid == (-(-n // 64), -(-k // r.kc))
        # about one block per SM, never fewer than the K rows allow
        assert r.grid[0] * r.grid[1] <= 2 * tk.WAVE
    else:
        assert r.bn in tk.CORE_BN and r.bm * (r.bn // 4) == 4 * 256


@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4)])
@pytest.mark.parametrize("batch", (256, 1))
def test_lenet_tiles_route_as_planned(r_in, r_w, batch):
    """Every call of a LeNet forward, from its plan: conv1 (K 9) on route
    C, every call with K >= 32 on route A (batch 256) or, for the fc
    layers at batch 1, route B; one call a row tile, over every col
    tile (fc1 at r_w 4: two row tiles of four macro tiles)."""
    prog = cnn.lenet_program(batch, cim=CIMConfig(r_in=r_in, r_w=r_w),
                             device="cpu")
    calls = prog.plan.tile_calls(batch)
    assert len(calls) == sum(len(lp.k_slices) for lp in prog.plan.layers)
    assert [n for _, n, _, _ in calls] == [
        lp.n_pad for lp in prog.plan.layers for _ in lp.k_slices]
    for m, n, k, p in calls:
        route = tk.route_for(m, n, k, p).name
        if k < 32:
            assert route == "cuda_core"
        else:
            assert route == ("tc" if m >= 64 else "splitk")
    counts = tk.route_counts(calls)
    assert counts["cuda_core"] == 1
    assert sum(counts.values()) == len(calls)


def test_route_for_refuses_empty_shapes():
    for shape in ((0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, -1)):
        with pytest.raises(ValueError):
            tk.route_for(*shape)


@pytest.mark.parametrize("m,n,k,planes,route,count", [
    (256, 128, 784, 1, "tc", 8), (256, 64, 784, 2, "tc", 6),
    (4, 64, 1024, 2, "splitk", 121), (17, 33, 40, 2, "splitk", 33),
    (200704, 16, 9, 1, "cuda_core", 3)])
def test_legal_tiles_and_tuned_routes(m, n, k, planes, route, count):
    """legal_tiles is the tile set of the route the shape takes; each one
    runs in place of the shape's own (tuned, its grid recomputed), a tile
    of another route is ignored, and a tile its route does not launch
    raises."""
    tiles = tk.legal_tiles(m, n, k, planes)
    own = tk.route_for(m, n, k, planes)
    assert len(tiles) == count == len(set(tiles)) and own.name == route
    assert own.tile in tiles and not own.tuned
    for tile in tiles:
        r = tk.route_for(m, n, k, planes, tile)
        assert r.tuned and r.tile == tile
        assert r.grid == tk._grid(route, m, n, k, *tile[1:])
        if route == "tc":
            assert tile[1] in tk.TC_BM and tile[2] * planes <= 128
        elif route == "splitk":
            assert tile[1:3] == (0, 64) and 8 <= tile[3] <= min(128, k)
    other = {"tc": ("splitk", 0, 64, 16), "splitk": ("tc", 64, 16, 0),
             "cuda_core": ("tc", 64, 16, 0)}[route]
    assert tk.route_for(m, n, k, planes, other) == own
    bad = {"tc": ("tc", 64, 256, 0), "splitk": ("splitk", 0, 64, 129),
           "cuda_core": ("cuda_core", 64, 16, 0)}[route]
    with pytest.raises(ValueError, match="not a"):
        tk.route_for(m, n, k, planes, bad)


# -- each route's integer arithmetic, emulated --------------------------------

def _to_i32(a: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) & MASK).astype(np.uint32).view(np.int32)


def _planes(x_planes: np.ndarray, k: int) -> np.ndarray:
    """(M, P*K) -> (P, M, K) int64"""
    m, pk = x_planes.shape
    return x_planes.astype(np.int64).reshape(m, pk // k, k).transpose(1, 0, 2)


def emulate_tc(x_planes, w, k, shift):
    """Route A: K zero-padded to whole 128-value stages, four 32-value
    k-steps a stage, one accumulator per plane (mod 2^32), combined as
    acc0 + (acc1 << shift)."""
    xp = _planes(x_planes, k)
    kp = -(-k // tk.TC_BK) * tk.TC_BK
    xp = np.pad(xp, ((0, 0), (0, 0), (0, kp - k)))
    wp = np.pad(w.astype(np.int64), ((0, kp - k), (0, 0)))
    acc = np.zeros((xp.shape[0], x_planes.shape[0], w.shape[1]), np.int64)
    for s in range(0, kp, 32):
        for p in range(xp.shape[0]):
            acc[p] = (acc[p] + xp[p][:, s:s + 32] @ wp[s:s + 32]) & MASK
    dp = acc[0]
    if xp.shape[0] == 2:
        dp = dp + (acc[1] << shift)
    return _to_i32(dp)


def emulate_splitk(x_planes, w, k, shift, kc, order):
    """Route B: xc = sum_p x_p << (shift p) mod 2^32 per element, chunk
    sums of kc rows mod 2^32, the chunks added in `order`."""
    xp = _planes(x_planes, k)
    xc = np.zeros(xp.shape[1:], np.int64)
    for p in range(xp.shape[0]):
        xc = (xc + (xp[p] << (shift * p))) & MASK
    w64 = w.astype(np.int64)
    parts = [(xc[:, c:c + kc] @ w64[c:c + kc]) & MASK
             for c in range(0, k, kc)]
    total = np.zeros((x_planes.shape[0], w.shape[1]), np.int64)
    for i in order:
        total = (total + parts[i]) & MASK
    return _to_i32(total)


def emulate_cuda_core(x_planes, w, k, shift):
    """Route C: K stages of 32; each plane's partial sum of a stage enters
    the accumulator scaled by 2^(shift p), mod 2^32."""
    xp = _planes(x_planes, k)
    w64 = w.astype(np.int64)
    acc = np.zeros((x_planes.shape[0], w.shape[1]), np.int64)
    for s in range(0, k, 32):
        for p in range(xp.shape[0]):
            part = xp[p][:, s:s + 32] @ w64[s:s + 32]
            acc = (acc + part * (1 << (shift * p))) & MASK
    return _to_i32(acc)


def epilogue_f32(dp, gamma, beta, g0, r_out):
    """The kernels' epilogue, one rounded float32 step at a time:
    gain = gamma * g0, t = gain * dp, code = floor((mid + t) + beta)."""
    f32 = np.float32
    gain = (gamma.astype(f32).reshape(1, -1) * f32(g0)).astype(f32)
    t = (gain * dp.astype(f32)).astype(f32)
    s = (f32(2.0 ** (r_out - 1)) + t).astype(f32)
    code = np.floor((s + beta.astype(f32).reshape(-1, dp.shape[1]))
                    .astype(f32))
    return np.clip(code, 0, 2.0 ** r_out - 1).astype(np.int32)


# (m, k, n, r_in, r_w, r_out) per route, small enough for interpret mode
ROUTE_SHAPES = {
    "tc": [(64, 144, 40, 8, 4, 8), (65, 48, 16, 1, 1, 1),
           (128, 288, 10, 2, 2, 4), (96, 160, 33, 4, 2, 6),
           (4224, 256, 16, 4, 2, 8)],
    "splitk": [(1, 1024, 64, 8, 4, 8), (4, 1024, 128, 4, 2, 8),
               (17, 300, 33, 8, 4, 6), (63, 40, 10, 2, 1, 4)],
    "cuda_core": [(70, 9, 16, 4, 2, 8), (129, 37, 65, 8, 4, 8),
                  (5, 20, 3, 8, 4, 4), (100, 200, 40, 3, 2, 6)],
}
ROUTE_CASES = [(route, *s) for route, shapes in ROUTE_SHAPES.items()
               for s in shapes]


def _emulate(route, x_planes, w, k, shift, seed=0):
    r = tk.route_for(x_planes.shape[0], w.shape[1], k,
                     x_planes.shape[1] // k)
    assert r.name == route
    if route == "tc":
        return emulate_tc(x_planes, w, k, shift)
    if route == "splitk":
        n_chunks = -(-k // r.kc)
        order = np.random.default_rng(seed).permutation(n_chunks)
        return emulate_splitk(x_planes, w, k, shift, r.kc, order)
    return emulate_cuda_core(x_planes, w, k, shift)


@pytest.mark.parametrize("beta_rows", (False, True))
@pytest.mark.parametrize("route,m,k,n,r_in,r_w,r_out", ROUTE_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-r{c[4]}"
                              for c in ROUTE_CASES])
def test_route_arithmetic_matches_plain_and_jax(route, m, k, n, r_in, r_w,
                                                r_out, beta_rows):
    """The emulated route's dp and codes equal the plain version's and the
    JAX kernel's (interpret mode), bit for bit, in both ADC modes."""
    x, w, gamma, beta = make_case(m, k, n, r_in, r_w, 7 * m + k + n,
                                  beta_rows)
    shift, _ = tk.plane_layout(r_in)
    planes, _ = tops.split_planes(torch.from_numpy(x), r_in, shift)
    dp = _emulate(route, planes.numpy(), w, k, shift, seed=m)
    codes = epilogue_f32(dp, gamma, beta, layer_g0(k, r_in, r_w, r_out),
                         r_out)
    g0 = layer_g0(k, r_in, r_w, r_out)
    tw = torch.from_numpy(w).to(torch.int8)
    tg = torch.from_numpy(gamma)[None]
    tb = torch.from_numpy(beta) if beta_rows else torch.from_numpy(beta)[None]
    for fuse, want in ((False, dp), (True, codes)):
        plain = tref.cim_mbiw_matmul_planes_ref(
            planes, tw, tg, tb, plane_shift=shift, g0=g0, r_out=r_out,
            fuse_adc=fuse)
        np.testing.assert_array_equal(plain.numpy(), want)
        jx = jnp.asarray(x)
        jout = jops.cim_matmul(jx, jnp.asarray(w), jnp.asarray(gamma),
                               jnp.asarray(beta), r_in=r_in, r_out=r_out,
                               g0=g0, plane_shift=shift, interpret=True,
                               fuse_adc=fuse)
        np.testing.assert_array_equal(np.asarray(jout), want)


def emulate_blocked(walk, x_planes, w, k, bm, bn):
    """A route's walk block by block at a bm x bn tile: each block's rows
    and columns past M and N zero-filled (TMA's fill, the kernels' masks),
    only its live outputs kept."""
    m, n = x_planes.shape[0], w.shape[1]
    out = np.zeros((m, n), np.int32)
    for i in range(0, m, bm):
        xb = np.zeros((bm, x_planes.shape[1]), x_planes.dtype)
        xb[:min(bm, m - i)] = x_planes[i:i + bm]
        for j in range(0, n, bn):
            wb = np.zeros((k, bn), w.dtype)
            wb[:, :min(bn, n - j)] = w[:, j:j + bn]
            out[i:i + bm, j:j + bn] = walk(xb, wb)[:m - i, :n - j]
    return out


@pytest.mark.parametrize("route,m,k,n,r_in,r_w,r_out", ROUTE_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-r{c[4]}"
                              for c in ROUTE_CASES])
def test_every_legal_tile_matches_plain(route, m, k, n, r_in, r_w, r_out):
    """Every tile the tuner may pick for the shape (`legal_tiles`) walks
    to the plain version's dp and, through the epilogue, its codes, bit
    for bit: the tile moves no bit."""
    x, w, gamma, beta = make_case(m, k, n, r_in, r_w, 3 * m + k, False)
    shift, _ = tk.plane_layout(r_in)
    planes, p = tops.split_planes(torch.from_numpy(x), r_in, shift)
    xp = planes.numpy()
    g0 = layer_g0(k, r_in, r_w, r_out)
    tw = torch.from_numpy(w).to(torch.int8)
    tg, tb = torch.from_numpy(gamma)[None], torch.from_numpy(beta)[None]
    want = {fuse: tref.cim_mbiw_matmul_planes_ref(
        planes, tw, tg, tb, plane_shift=shift, g0=g0, r_out=r_out,
        fuse_adc=fuse).numpy() for fuse in (False, True)}
    tiles = tk.legal_tiles(m, n, k, p)
    assert tiles and all(t[0] == route for t in tiles)
    for name, bm, bn, kc in tiles:
        if name == "tc":
            dp = emulate_blocked(lambda a, b: emulate_tc(a, b, k, shift),
                                 xp, w, k, bm, bn)
        elif name == "splitk":
            chunks = -(-k // kc)
            order = np.random.default_rng(kc).permutation(chunks)
            dp = emulate_splitk(xp, w, k, shift, kc, order)
        else:
            dp = emulate_blocked(
                lambda a, b: emulate_cuda_core(a, b, k, shift), xp, w, k,
                bm, bn)
        np.testing.assert_array_equal(dp, want[False])
        np.testing.assert_array_equal(
            epilogue_f32(dp, gamma, beta, g0, r_out), want[True])


@pytest.mark.parametrize("seed", range(4))
def test_splitk_chunk_order_is_immaterial(seed):
    """Route B's chunk sums in any order give the same dp (integer adds
    mod 2^32 are associative), including sums that wrap."""
    rng = np.random.default_rng(seed)
    m, k, n = 3, 1024, 64
    x_planes = rng.integers(-128, 128, size=(m, 2 * k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    r = tk.route_for(m, n, k, 2)
    chunks = -(-k // r.kc)
    shift = 20                       # the second plane wraps the int32 sum
    want = emulate_splitk(x_planes, w, k, shift, r.kc, range(chunks))
    got = emulate_splitk(x_planes, w, k, shift, r.kc,
                         rng.permutation(chunks))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_tc(x_planes, w, k, shift), want)
    np.testing.assert_array_equal(emulate_cuda_core(x_planes, w, k, shift),
                                  want)


@pytest.mark.parametrize("route", ("tc", "splitk", "cuda_core"))
def test_route_wraparound_matches_plain(route):
    """A dp that overflows int32 (a plane shift of 20 over int8 planes)
    wraps the same way on every route as in the plain version."""
    m = {"tc": 64, "splitk": 4, "cuda_core": 70}[route]
    k = 200 if route == "cuda_core" else 256
    rng = np.random.default_rng(5)
    x_planes = rng.integers(-128, 128, size=(m, 2 * k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, 24)).astype(np.int8)
    dp = _emulate(route, x_planes, w, k, 20)
    wide = (_planes(x_planes, k)[0] @ w.astype(np.int64)
            + (_planes(x_planes, k)[1] @ w.astype(np.int64) << 20))
    assert np.any(np.abs(wide) > 2**31)          # the case does wrap
    plain = tref.cim_mbiw_matmul_planes_ref(
        torch.from_numpy(x_planes), torch.from_numpy(w),
        torch.ones((1, 24)), torch.zeros((1, 24)), plane_shift=20, g0=1.0,
        r_out=8, fuse_adc=False)
    np.testing.assert_array_equal(plain.numpy(), dp)
    np.testing.assert_array_equal(dp, _to_i32(wide))


@pytest.mark.parametrize("seed", range(3))
def test_fma_canary_through_route_a(seed):
    """The canary (64 x 144 @ 144 x 64, r_in 8: two nibble planes) takes
    route A; its emulated dp and the rounded epilogue give the contract's
    codes, the plain version's and the JAX oracle's, and not the codes of
    a fused multiply-add."""
    c = tref.fma_canary(seed)
    shift, _ = tk.plane_layout(8)
    planes, p = tops.split_planes(torch.from_numpy(c["x"]), 8, shift)
    assert tk.route_for(64, 64, 144, p).name == "tc"
    dp = emulate_tc(planes.numpy(), c["w"], 144, shift)
    np.testing.assert_array_equal(dp, c["x"].astype(np.int64) @ c["w"])
    codes = epilogue_f32(dp, c["gamma"], c["beta"], c["g0"], c["r_out"])
    np.testing.assert_array_equal(codes, c["codes"])
    assert np.any(codes != c["codes_fma"])
    plain = tref.cim_mbiw_matmul_planes_ref(
        planes, torch.from_numpy(c["w"]).to(torch.int8),
        torch.from_numpy(c["gamma"])[None], torch.from_numpy(c["beta"])[None],
        plane_shift=shift, g0=c["g0"], r_out=c["r_out"])
    np.testing.assert_array_equal(plain.numpy(), codes)
    oracle = jref.cim_matmul_ref(*(jnp.asarray(c[k]) for k in
                                   ("x", "w", "gamma", "beta")),
                                 g0=c["g0"], r_out=c["r_out"])
    np.testing.assert_array_equal(np.asarray(oracle), codes)


# -- the TF32 repair ----------------------------------------------------------

def _set_tf32(api: str) -> None:
    mm = torch.backends.cuda.matmul
    if api == "flag":
        mm.allow_tf32 = True
    elif api == "precision":
        torch.set_float32_matmul_precision("high")
    else:
        mm.fp32_precision = "tf32"


def _precision_state() -> tuple:
    mm = torch.backends.cuda.matmul
    out = []
    for read in (torch.get_float32_matmul_precision, lambda: mm.allow_tf32,
                 lambda: getattr(mm, "fp32_precision", None)):
        try:
            out.append(read())
        except RuntimeError:
            out.append("mixed")
    return tuple(out)


@pytest.mark.parametrize("api", ("flag", "precision", "backend"))
def test_fakequant_forward_exact_with_tf32_requested(api):
    """With TF32 requested through any of PyTorch's settings, the fakequant
    forward still equals JAX's bit for bit (its integer products run in
    full float32), and the setting reads as the caller left it."""
    mm = torch.backends.cuda.matmul
    if api == "backend" and not hasattr(mm, "fp32_precision"):
        api = "flag"       # this PyTorch has only the legacy settings
    rng = np.random.default_rng(3)
    k, n = 1152, 24
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
         "abn_log_gamma": rng.uniform(0, 9, n).astype(np.float32),
         "abn_beta": rng.uniform(-3, 3, n).astype(np.float32)}
    want = np.asarray(jcl.cim_linear_apply(
        {kk: jnp.asarray(v) for kk, v in p.items()}, jnp.asarray(x),
        jcl.CIMConfig(mode="fakequant", max_gamma=2.0**16)))
    default = _precision_state()
    try:
        _set_tf32(api)
        before = _precision_state()
        got = tcl.cim_linear_apply(
            {kk: torch.from_numpy(v) for kk, v in p.items()},
            torch.from_numpy(x),
            tcl.CIMConfig(mode="fakequant", max_gamma=2.0**16))
        assert _precision_state() == before
        if api != "backend":
            assert mm.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
        if hasattr(mm, "fp32_precision"):
            mm.fp32_precision = "none"
    assert _precision_state() == default
    np.testing.assert_array_equal(want.view(np.uint32),
                                  got.numpy().view(np.uint32))


def test_exact_float32_matmul_pins_and_restores():
    mm = torch.backends.cuda.matmul
    try:
        torch.set_float32_matmul_precision("medium")
        with tcl.exact_float32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not mm.allow_tf32
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")
        if hasattr(mm, "fp32_precision"):
            mm.fp32_precision = "none"
