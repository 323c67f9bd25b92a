"""The CIM-MBIW quantized matmul with fused DSCI-ADC, on Hopper.

Counterpart of `repro/kernels/cim_mbiw/kernel.py`.  The kernels are CUDA
C++ (`csrc/`, built by `kernels/build.py` and called through a plain C
interface with ctypes); this module is their wrapper.

`cim_mbiw_matmul_planes` picks one of three routes from the shape, up
front (`route_for`), and launches it for tensors on a CUDA device:

  * "tc"        (route A, `csrc/cim_mbiw_tc.cu`): int8 `wgmma` on the
                tensor cores, x by TMA, for M >= 64, K >= 32 with K a
                multiple of 16 (TMA's 16-byte strides) and at most two
                planes;
  * "splitk"    (route B, `csrc/cim_mbiw_splitk.cu`): the grid split over
                K, for M < 64 and K >= 32 (every decode tile);
  * "cuda_core" (route C, `csrc/cim_mbiw.cu`): the first port's
                `__dp4a` kernel with a tile width fitted to N, for the rest
                (K < 32: LeNet's conv1).

The tile within the route is the shape's own unless the caller passes a
tuned one (`tile=`, a `(route, bm, bn, kc)` tuple from `legal_tiles`, the
schedule tuner's candidates): a tile of the route the shape takes runs in
its place; a tile of another route is ignored, since the dispatched rows
move with the batch bucket and a layer tuned at its design rows may land
on another route at a small bucket.  Every tile computes the same integers
(exact int32 sums; route B's chunk sums are associative), so a tile moves
no bit.

Tensors on the CPU run the plain PyTorch version
(`ref.cim_mbiw_matmul_planes_ref`), which ignores tiles.  A CUDA tensor
never reaches the plain version or another route: a launch of the chosen
route either happens or raises.  `cim_mbiw_matmul_planes.launches` counts
every launch, `.launches_tc` and `.launches_splitk` those of routes A and
B, `.launches_tuned` those that ran a tuned tile.  A CUDA graph replay
runs no Python, so a captured dispatch adds what its capture launched
(`launch_counts`, `add_launches`).  On the `meta` device (a dry run) the
wrapper launches and counts nothing: it returns an empty meta tensor and
records one op of the function's work (`kernels/costs.py`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build, costs


def plane_layout(r_in: int) -> tuple[int, int]:
    """(plane_shift, n_planes) of the input-serial walk at a given r_in.

    Bit-serial below 3b (the macro's high-throughput binary modes),
    nibble-serial at 3-8b.  Weights stay *parallel* at every r_w - the
    MBIW combines weight bits spatially across adjacent columns, so the
    kernel sees them as pre-decoded odd integers.
    """
    if not 1 <= r_in <= 8:
        raise ValueError(f"r_in={r_in} outside the macro's 1-8b range")
    shift = 1 if r_in <= 2 else 4
    return shift, -(-r_in // shift)


# route A: tile heights (one or two consumer warpgroups) and widths of the
# int8 wgmma (one accumulator of BN / 2 registers a plane, at most 64
# registers: BN 128 at one plane, 64 at two), K values a stage, the
# alignment TMA needs of K (its plane and row strides)
TC_BM = (128, 64)
TC_BN = (16, 32, 64, 128)
TC_BK = 128
TC_K_ALIGN = 16
TC_MAX_PLANES = 2
# one wave of blocks (the H100's SM count): route A's tile and route B's
# K chunks aim at it
WAVE = 132
# route B: columns a block, K rows a chunk; M below SPLITK_MAX_M
SPLITK_BN = 64
SPLITK_KC = (8, 128)
SPLITK_MAX_M = 63
# route C: tile widths (the tile is 256 threads x 4 x 4 outputs)
CORE_BN = (16, 32, 64)
# routes A and B need a K of at least one k-step of 32
MIN_K = 32


# a tile: (route name, bm, bn, kc), as a Route spells it
Tile = Tuple[str, int, int, int]


@dataclasses.dataclass(frozen=True)
class Route:
    """One launch plan: the route and its tile.  `bm` rows and `bn`
    columns a block (route B puts every row in a block, bm = 0); `kc` the
    K rows of a chunk (route B only); `grid` the blocks, (N tiles, M
    tiles) on route A, (N tiles, K chunks) on B, (M tiles, N tiles) on
    C.  `tuned` marks a tile the caller chose in place of the shape's."""
    name: str
    bm: int
    bn: int
    kc: int
    grid: tuple
    tuned: bool = False

    @property
    def tile(self) -> Tile:
        return (self.name, self.bm, self.bn, self.kc)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _grid(name: str, m: int, n: int, k: int, bm: int, bn: int,
          kc: int) -> tuple:
    if name == "tc":
        return (_cdiv(n, bn), _cdiv(m, bm))
    if name == "splitk":
        return (_cdiv(n, bn), _cdiv(k, kc))
    return (_cdiv(m, bm), _cdiv(n, bn))


def _launchable(tile, planes: int) -> bool:
    if not (isinstance(tile, tuple) and len(tile) == 4):
        return False
    name, bm, bn, kc = tile
    if not all(type(v) is int for v in (bm, bn, kc)):
        return False
    if name == "tc":
        return (bm in TC_BM and bn in TC_BN and kc == 0
                and 1 <= planes <= TC_MAX_PLANES and bn * planes <= TC_BN[-1])
    if name == "splitk":
        return bm == 0 and bn == SPLITK_BN and 1 <= kc <= SPLITK_KC[1]
    if name == "cuda_core":
        return bn in CORE_BN and bm == 4 * 256 // (bn // 4) and kc == 0
    return False


def check_tile(tile: Tile, planes: int) -> None:
    """Raise ValueError unless `tile` is one its route launches at
    `planes` input planes: route A a TC_BM x TC_BN tile with
    bn * planes <= 128 (one or two planes); route B 64 columns and a kc
    the launcher takes, 1-128 (the shape's own kc may fall below
    SPLITK_KC's 8 at K < 64); route C a CORE_BN width with its fixed
    height."""
    if not _launchable(tile, planes):
        raise ValueError(
            f"tile {tile!r} is not a (route, bm, bn, kc) tile that a "
            f"cim_mbiw route launches at {planes} plane(s)")


def legal_tiles(m: int, n: int, k: int, planes: int) -> Tuple[Tile, ...]:
    """Every tile of the route the shape takes (`route_for`): the schedule
    tuner's candidates for one dispatch.  Route A: TC_BM x TC_BN with
    bn * planes <= 128; route B: every kc of SPLITK_KC's range up to K;
    route C: the CORE_BN widths."""
    name = route_for(m, n, k, planes).name
    if name == "tc":
        return tuple(("tc", bm, bn, 0) for bm in TC_BM for bn in TC_BN
                     if bn * planes <= TC_BN[-1])
    if name == "splitk":
        lo, hi = SPLITK_KC
        return tuple(("splitk", 0, SPLITK_BN, kc)
                     for kc in range(lo, min(hi, k) + 1))
    return tuple(("cuda_core", 4 * 256 // (bn // 4), bn, 0)
                 for bn in CORE_BN)


@functools.lru_cache(maxsize=4096)
def route_for(m: int, n: int, k: int, planes: int,
              tile: Optional[Tile] = None) -> Route:
    """The route and tile for an (M, K) x (K, N) call over `planes` input
    planes.  With `tile` (a tuned tile) of the route the shape takes, that
    tile (`tuned` set; ValueError if its route does not launch it at
    `planes`); a tile of another route is ignored.  Otherwise the tile
    from the shape alone:

      "tc"        M >= 64, K >= 32, K % 16 == 0, planes <= 2: the largest
                  BM x BN (BM 64, or 128 from M 128 up; BN 16..128, no
                  wider than the width that holds N, at most 128 //
                  planes; the wider BN first at equal size) whose grid
                  has a wave of 132 blocks, or the smallest, 64 x 16,
                  when no tile fills the card (a block walks all of K,
                  so a small grid wants narrow tiles);
      "splitk"    M < 64, K >= 32: 64 columns a block, K in ceil(K / KC)
                  chunks of KC rows (8..128) so that the grid has about
                  132 blocks;
      "cuda_core" everything else: BN 16, 32 or 64 from N, BM = 4 * 256 /
                  (BN / 4).
    """
    own = _shape_route(m, n, k, planes)
    if tile is None or tile[0] != own.name:
        return own
    check_tile(tile, planes)
    _, bm, bn, kc = tile
    return Route(own.name, bm, bn, kc, _grid(own.name, m, n, k, bm, bn, kc),
                 tuned=True)


def _shape_route(m: int, n: int, k: int, planes: int) -> Route:
    if min(m, n, k) < 1 or planes < 0:
        raise ValueError(f"no route for M={m} N={n} K={k} P={planes}")
    if m >= 64 and k >= MIN_K and k % TC_K_ALIGN == 0 \
            and 1 <= planes <= TC_MAX_PLANES:
        top = next((b for b in TC_BN if b >= n), TC_BN[-1])
        tiles = sorted(((bm * bn, bn, bm) for bm in TC_BM
                        for bn in TC_BN if (bm == 64 or m >= 128)
                        and bn <= top and bn * planes <= TC_BN[-1]),
                       reverse=True)
        _, bn, bm = next((t for t in tiles
                          if _cdiv(m, t[2]) * _cdiv(n, t[1]) >= WAVE),
                         tiles[-1])
        return Route("tc", bm, bn, 0, _grid("tc", m, n, k, bm, bn, 0))
    if m <= SPLITK_MAX_M and k >= MIN_K:
        tiles = _cdiv(n, SPLITK_BN)
        lo, hi = SPLITK_KC
        chunks = max(1, min(_cdiv(k, lo), _cdiv(WAVE, tiles)))
        kc = min(hi, _cdiv(k, chunks))
        return Route("splitk", 0, SPLITK_BN, kc,
                     _grid("splitk", m, n, k, 0, SPLITK_BN, kc))
    bn = next((b for b in CORE_BN if b >= n), CORE_BN[-1])
    bm = 4 * 256 // (bn // 4)
    return Route("cuda_core", bm, bn, 0,
                 _grid("cuda_core", m, n, k, bm, bn, 0))


def route_counts(tiles) -> Dict[str, int]:
    """Launches per route for an iterable of (m, n, k, planes) calls."""
    out = {"tc": 0, "splitk": 0, "cuda_core": 0}
    for t in tiles:
        out[route_for(*t).name] += 1
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# library -> (entry point, its argument types after the five tensors x, w,
# gamma, beta, out)
_ENTRIES = {
    "cim_mbiw": ("cim_mbiw_launch",
                 [_I] * 5 + [_F] + [_I] * 4),     # M N K P shift g0 r_out
                                                  # fuse beta_rows bn
    "cim_mbiw_tc": ("cim_mbiw_tc_launch",
                    [_I] * 5 + [_F] + [_I] * 6),  # .. bm bn wvec
    "cim_mbiw_splitk": ("cim_mbiw_splitk_launch",
                        [_P, _P] + [_I] * 5 + [_F] + [_I] * 5),
                                                  # ws tickets .. kc wvec
}
_LIBRARY = {"tc": "cim_mbiw_tc", "splitk": "cim_mbiw_splitk",
            "cuda_core": "cim_mbiw"}


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    entry, args = _ENTRIES[name]
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + args + [_P]      # .. cudaStream_t
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


# route B's int32 workspace per device: tickets and partial sums, zero
# between calls (each call leaves it zero); grown, never shrunk.  A CUDA
# graph bakes in the address it captured, so a workspace outgrown keeps
# living in _RETIRED_WORKSPACES: the graphs that hold it replay on it
_WORKSPACE: Dict[torch.device, torch.Tensor] = {}
_RETIRED_WORKSPACES: List[torch.Tensor] = []


def _splitk_workspace(device: torch.device, numel: int) -> torch.Tensor:
    """At least `numel` zero int32 on `device`, the same tensor for every
    call that fits.  It grows only outside a CUDA graph capture (an eager
    run of the shape first, as a capture's warm-up is): a capture would
    record the zero fill instead of running it."""
    ws = _WORKSPACE.get(device)
    if ws is None or ws.numel() < numel:
        if device.type == "cuda" \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"route B's workspace must grow to {numel} int32 during a "
                "CUDA graph capture; run the shape eagerly first")
        if ws is not None:
            _RETIRED_WORKSPACES.append(ws)
        ws = torch.zeros(max(numel, 2 * (0 if ws is None else ws.numel())),
                         dtype=torch.int32, device=device)
        _WORKSPACE[device] = ws
    return ws


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def launch(route: Route, x_planes: torch.Tensor, w_q: torch.Tensor,
           gamma: torch.Tensor, beta: torch.Tensor, out: torch.Tensor, *,
           plane_shift: int, g0: float, r_out: int, fuse_adc: bool) -> None:
    """Launch `route` on checked CUDA tensors (the wrapper's shapes) into
    `out`; raises on a refused launch or a tensor map that cannot be
    built.  Counts nothing: `cim_mbiw_matmul_planes` counts its launches,
    and a caller that forces a route (to time one beside another) is not
    the main path."""
    m, pk = x_planes.shape
    k_dim, n = w_q.shape
    p = pk // k_dim
    beta_rows = int(beta.shape[0] == m and m != 1)
    lib_name = _LIBRARY[route.name]
    lib = _library(lib_name)
    stream = torch.cuda.current_stream(x_planes.device).cuda_stream
    tensors = (x_planes.data_ptr(), w_q.data_ptr(), gamma.data_ptr(),
               beta.data_ptr(), out.data_ptr())
    common = (m, n, k_dim, p, plane_shift, ctypes.c_float(g0), r_out,
              int(fuse_adc), beta_rows)
    wvec = int(n % 16 == 0 and w_q.data_ptr() % 16 == 0)
    if route.name == "tc":
        if x_planes.data_ptr() % 16:
            raise ValueError("x_planes must be 16-byte aligned for TMA")
        err = lib.cim_mbiw_tc_launch(*tensors, *common, route.bm, route.bn,
                                     wvec, stream)
    elif route.name == "splitk":
        tiles = route.grid[0]
        ws = _splitk_workspace(x_planes.device, tiles + m * n).data_ptr()
        err = lib.cim_mbiw_splitk_launch(
            *tensors, ws + 4 * tiles, ws, *common, route.kc, wvec, stream)
    else:
        err = lib.cim_mbiw_launch(*tensors, *common, route.bn, stream)
    if err:
        msg = getattr(lib, f"{lib_name}_error_string")(err).decode()
        raise RuntimeError(f"cim_mbiw {route.name} launch failed: error "
                           f"{err} ({msg})")


def cim_mbiw_matmul_planes(x_planes: torch.Tensor, w_q: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor, *,
                           plane_shift: int, g0: float, r_out: int,
                           fuse_adc: bool = True,
                           tile: Optional[Tile] = None) -> torch.Tensor:
    """CIM matmul over input planes (any M, N, K: the kernels mask edges).

    x_planes : (M, P*K) int8 - P planes laid out plane-major along the last
               axis; plane p carries bits [p*plane_shift, ...).
    w_q      : (K, N) int8 odd weights (+/-(2^r_w - 1))
    gamma    : (1, N) float32 ABN gain
    beta     : (1, N) float32 ABN offset in ADC codes - or (M, N) for a
               per-GEMM-row offset
    tile     : a tuned (route, bm, bn, kc) tile, run where the shape takes
               its route (`route_for`); None for the shape's own
    returns  : (M, N) int32 ADC codes in [0, 2^r_out - 1], or the raw int32
               dp accumulator when `fuse_adc=False`
    """
    m, pk = x_planes.shape
    k_dim, n = w_q.shape
    if k_dim < 1 or pk % k_dim:
        raise ValueError(f"x_planes width {pk} is not a multiple of K={k_dim}")
    if tuple(gamma.shape) != (1, n) or tuple(beta.shape) not in ((1, n),
                                                                 (m, n)):
        raise ValueError(f"gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} do not fit (M, N)=({m}, {n})")
    if x_planes.device.type == "cpu":
        from repro_torch.kernels.cim_mbiw.ref import cim_mbiw_matmul_planes_ref
        return cim_mbiw_matmul_planes_ref(
            x_planes, w_q, gamma, beta, plane_shift=plane_shift, g0=g0,
            r_out=r_out, fuse_adc=fuse_adc)
    if x_planes.device.type == "meta":
        costs.record("cim_mbiw", costs.cim_mbiw(
            m, k_dim, n, pk // k_dim, beta.shape[0] == m and m != 1))
        return torch.empty((m, n), dtype=torch.int32, device="meta")
    if x_planes.device.type != "cuda":
        raise ValueError(f"no cim_mbiw kernel for device {x_planes.device}")
    dev = x_planes.device
    _check(x_planes, "x_planes", torch.int8, dev)
    _check(w_q, "w_q", torch.int8, dev)
    _check(gamma, "gamma", torch.float32, dev)
    _check(beta, "beta", torch.float32, dev)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    route = route_for(m, n, k_dim, pk // k_dim, tile)
    launch(route, x_planes, w_q, gamma, beta, out, plane_shift=plane_shift,
           g0=g0, r_out=r_out, fuse_adc=fuse_adc)
    fn = cim_mbiw_matmul_planes
    fn.launches += 1
    if route.name == "tc":
        fn.launches_tc += 1
    elif route.name == "splitk":
        fn.launches_splitk += 1
    if route.tuned:
        fn.launches_tuned += 1
    return out


cim_mbiw_matmul_planes.launches = 0
cim_mbiw_matmul_planes.launches_tc = 0
cim_mbiw_matmul_planes.launches_splitk = 0
cim_mbiw_matmul_planes.launches_tuned = 0


LAUNCH_COUNTERS = ("launches", "launches_tc", "launches_splitk",
                   "launches_tuned")


def launch_counts() -> Dict[str, int]:
    """The wrapper's launch counters by name (LAUNCH_COUNTERS)."""
    return {c: getattr(cim_mbiw_matmul_planes, c) for c in LAUNCH_COUNTERS}


def add_launches(counts: Dict[str, int]) -> None:
    """Add `counts` to the launch counters: a CUDA graph replay adds the
    launches its capture recorded (negated, they take back what a capture
    counted but did not launch)."""
    for c, n in counts.items():
        setattr(cim_mbiw_matmul_planes, c,
                getattr(cim_mbiw_matmul_planes, c) + n)
