"""The port on the card: the CUDA cim_mbiw, ring_decode, flash and
threefry_normal kernels against their plain versions, LeNet on the card
(clean and noisy) against the host run, fused in-flight decode at full
OLMo-1B width against solo decode, a train step at full OLMo-1B width
through the flash kernels, and the bound programs' captured CUDA graphs
(replay == eager engine._forward at every rung, no capture after
warm-up, replays out of capture order, launch counts, the route-B
workspace, results held across replays, the eager routes), and the LM
serving path (`launch/serve.py` at OLMo-1B's smoke config in engine
mode: graph replays == the eager step, engine == fakequant bit for bit,
no capture, plan or eager dispatch after the first decode step, the
card's logits and tokens against the host run, in-flight == solo), and
precision serving (calibration on the card == on the host, ladder rungs
through their graphs == reference == host, `--precision-policy mixed`
fused == solo with no growth after warm-up), and the schedule tuner
(every tile of `kernel.legal_tiles` == plain, `compile_program(tune=...)`
in both modes == untuned, and the analytic cost's ranking of JAX's five
pinned shapes against CUDA-event times at Spearman >= 0.7), and CIM-aware
LeNet training (the card's fakequant logits == the host's, clean and
noisy, gradients within `_close_grad`), engine-mode convs against
fakequant and the host, and the sim mode against the host, and the moe
and vlm families (an expert bank in fakequant on the card == the host,
the engine == fakequant or its reference; phi3.5-moe's and internvl2's
smoke serve on the card against fakequant and the host), and the hybrid
and ssm families (flash at head dims 192-256 and the raise above 256;
mamba2's and recurrentgemma's smoke serves and a train step on the card
against the host), and the last slice (each kernel's meta route beside
its card route, the dry run's argument bytes equal to the card's, the
folded moe split on the card against the host).

These tests need an NVIDIA GPU (marker `gpu`) and skip without one.  They
import neither JAX nor the JAX package, so they run where only PyTorch
is installed:  python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import digital_ref
from repro_torch.core import mapping as tmap
from repro_torch.core import prng
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.hw import DEFAULT_MACRO
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.kernels.cim_mbiw import kernel as tkernel
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.kernels.cim_mbiw import ref as tref
from repro_torch.kernels.flash_attn import kernel as rkernel
from repro_torch.kernels.flash_attn import ref as rref
from repro_torch.kernels.prng import kernel as pkernel
from repro_torch.kernels.prng.ref import threefry_normal_ref
from repro_torch.models import cnn
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog
from repro_torch.runtime.scheduler import (CIMDecodeLM, InflightScheduler,
                                           Request, decode_sequential)

SHAPES = [
    (8, 36, 4, 1, 1, 1), (16, 144, 16, 4, 2, 4), (32, 256, 64, 8, 4, 8),
    (100, 1152, 64, 8, 4, 8), (17, 300, 33, 5, 3, 6), (64, 1000, 40, 8, 4, 4),
    (1, 128, 1, 8, 4, 8), (256, 512, 128, 7, 2, 8),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cim_mbiw kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _case(m, k, n, r_in, r_w, seed, beta_rows):
    rng = np.random.default_rng(seed)
    full = 2**r_w - 1
    x = rng.integers(0, 2**r_in, size=(m, k))
    w = 2 * rng.integers(-(full + 1) // 2, (full + 1) // 2, size=(k, n)) + 1
    gamma = 2.0 ** rng.integers(0, 6, size=(1, n))
    beta = rng.uniform(-16, 16, size=(m if beta_rows else 1, n))
    shift, _ = tkernel.plane_layout(r_in)
    planes, _ = tops.split_planes(torch.from_numpy(x), r_in, shift)
    return shift, [planes, torch.from_numpy(w).to(torch.int8),
                   torch.from_numpy(gamma).float(),
                   torch.from_numpy(beta).float()]


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_adc", (True, False))
@pytest.mark.parametrize("beta_rows", (False, True))
@pytest.mark.parametrize("m,k,n,r_in,r_w,r_out", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, m, k, n, r_in, r_w, r_out,
                                   beta_rows, fuse_adc):
    shift, args = _case(m, k, n, r_in, r_w, m * k + n, beta_rows)
    units = DEFAULT_MACRO.units_for_rows(min(k, DEFAULT_MACRO.n_rows))
    g0 = digital_ref.adc_gain_factor(r_in, r_w, r_out, units * 36)
    kw = dict(plane_shift=shift, g0=g0, r_out=r_out, fuse_adc=fuse_adc)
    dev_args = [a.to(cuda_device) for a in args]
    before = tkernel.cim_mbiw_matmul_planes.launches
    got = tkernel.cim_mbiw_matmul_planes(*dev_args, **kw)
    torch.cuda.synchronize()
    assert tkernel.cim_mbiw_matmul_planes.launches == before + 1
    assert torch.equal(got, tref.cim_mbiw_matmul_planes_ref(*dev_args, **kw))
    assert torch.equal(got.cpu(), tref.cim_mbiw_matmul_planes_ref(*args,
                                                                   **kw))


@pytest.mark.gpu
def test_cuda_kernel_fma_canary(cuda_device):
    c = tref.fma_canary(0)
    before = tkernel.cim_mbiw_matmul_planes.launches_tc
    got = tops.cim_matmul(*(torch.from_numpy(c[k]).to(cuda_device)
                            for k in ("x", "w", "gamma", "beta")),
                          r_in=8, r_out=c["r_out"], g0=c["g0"])
    # 64 x 144 @ 144 x 64 at two nibble planes: the tensor-core route
    assert tkernel.cim_mbiw_matmul_planes.launches_tc == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), c["codes"])


# the edges of the routes (kernel.route_for): M around route A's 64 and
# 128-row tiles and route B's 63, N around the tile widths, K unaligned
# (no TMA: route C at M >= 64), across route A's 128-value stages and
# route B's chunks, and past 1024
ROUTE_M = (1, 4, 63, 64, 65, 129)
ROUTE_N = (10, 16, 33, 64, 128, 256)
ROUTE_K = (37, 48, 144, 1040)


@pytest.mark.gpu
@pytest.mark.parametrize("n", ROUTE_N)
@pytest.mark.parametrize("m", ROUTE_M)
def test_cuda_routes_match_plain(cuda_device, m, n):
    """torch.equal against the plain version at each route's edges, over
    K in ROUTE_K, one and two planes, both beta shapes and both ADC modes;
    each call raises the counter of the route route_for names."""
    kern = tkernel.cim_mbiw_matmul_planes
    for k in ROUTE_K:
        for r_in, r_w in ((4, 2), (8, 4)):
            for beta_rows in (False, True):
                for fuse_adc in (True, False):
                    shift, args = _case(m, k, n, r_in, r_w,
                                        m * 7 + n * 3 + k, beta_rows)
                    p = args[0].shape[1] // k
                    route = tkernel.route_for(m, n, k, p).name
                    kw = dict(plane_shift=shift, g0=0.003, r_out=8,
                              fuse_adc=fuse_adc)
                    dev_args = [a.to(cuda_device) for a in args]
                    counts = (kern.launches, kern.launches_tc,
                              kern.launches_splitk)
                    got = kern(*dev_args, **kw)
                    torch.cuda.synchronize()
                    assert (kern.launches - counts[0],
                            kern.launches_tc - counts[1],
                            kern.launches_splitk - counts[2]) == \
                        (1, int(route == "tc"), int(route == "splitk"))
                    want = tref.cim_mbiw_matmul_planes_ref(*dev_args, **kw)
                    assert torch.equal(got, want), \
                        (route, m, k, n, p, beta_rows, fuse_adc)


@pytest.mark.gpu
@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4)])
def test_lenet_on_card_matches_host(cuda_device, r_in, r_w):
    cim = CIMConfig(r_in=r_in, r_w=r_w)
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(3), cim=cim))
    x = torch.from_numpy(make_dataset(1, 5, seed=1)[2][..., None])
    gpu = cnn.lenet_program(5, cim=cim).bind(params)
    cpu = cnn.lenet_program(5, cim=cim, device="cpu").bind(params)
    before = tkernel.cim_mbiw_matmul_planes.launches
    y = gpu.serve(x)
    torch.cuda.synchronize()
    assert tkernel.cim_mbiw_matmul_planes.launches - before == \
        gpu.plan.total_macro_evals
    assert torch.equal(y, gpu.reference(x))
    assert torch.equal(y.cpu(), cpu.serve(x))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", (256, 1))
@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4)])
def test_lenet_on_card_routes(cuda_device, r_in, r_w, batch):
    """A LeNet forward launches each route as route_for names it for the
    plan's tiles: conv1 on the CUDA cores, every K >= 32 tile on the
    tensor cores (batch 256) or split-K (the fc layers at batch 1)."""
    cim = CIMConfig(r_in=r_in, r_w=r_w)
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(3), cim=cim))
    x = torch.from_numpy(make_dataset(1, batch, seed=2)[2][..., None])
    gpu = cnn.lenet_program(batch, cim=cim).bind(params)
    want = tkernel.route_counts(gpu.plan.tile_calls(batch))
    assert want["cuda_core"] == 1
    kern = tkernel.cim_mbiw_matmul_planes
    counts = (kern.launches, kern.launches_tc, kern.launches_splitk)
    y = gpu.serve(x)
    torch.cuda.synchronize()
    got = (kern.launches - counts[0], kern.launches_tc - counts[1],
           kern.launches_splitk - counts[2])
    assert got == (sum(want.values()), want["tc"], want["splitk"])
    assert torch.equal(y, gpu.reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("streams,n", [
    (1, 1), (3, 127), (3, 129), (1568, 2048), (1, 1 << 22),
    # many short streams packed into a block, rows ragged against a
    # thread's 4 normals, and whisper's served frames
    (1568, 1), (1568, 3), (1568, 5), (7, 1023), (1, 6_144_000)])
def test_threefry_normal_kernel_matches_plain(cuda_device, streams, n):
    """One launch draws every stream bit for bit as the plain version does
    on the card and on the host; keys from key, fold_in (an id above
    2^31) and split."""
    base = prng.key(1)
    keys = torch.cat([base[None], prng.fold_in(base, 2**31 + 5)[None],
                      prng.split(base, max(streams - 2, 1))])[:streams]
    before = pkernel.threefry_normal.launches
    got = pkernel.threefry_normal(keys.to(cuda_device), n)
    torch.cuda.synchronize()
    assert pkernel.threefry_normal.launches == before + 1
    assert torch.equal(got, threefry_normal_ref(keys.to(cuda_device), n))
    if streams * n <= 1 << 22:
        assert torch.equal(got.cpu(), threefry_normal_ref(keys, n))


@pytest.mark.gpu
def test_threefry_normal_past_2_32_counters(cuda_device):
    """Counters past 2^32 (their high word 1) on the 32-bit loop (one
    stream of 2^32 + 2003: 2^30 + 501 units), and the 64-bit loop (two
    such streams: past 2^31 units) with scalar stores (n odd): windows
    of the draw, across 2^32 and at each row's ends, against the plain
    threefry of their counters.  Up to 32 GiB of normals."""
    keys = prng.split(prng.key(3), 2).to(cuda_device)
    w = 1000
    n = (1 << 32) + 2 * w + 3
    for streams in (1, 2):
        got = pkernel.threefry_normal(keys[:streams], n)
        for s in range(streams):
            for j0 in (0, (1 << 32) - w // 2, n - w):
                j = torch.arange(j0, j0 + w, dtype=torch.int64,
                                 device=cuda_device)
                y1, y2 = prng.threefry2x32(keys[s, 0], keys[s, 1], j >> 32,
                                           j & prng.M32)
                assert torch.equal(got[s, j0:j0 + w],
                                   prng._normal_from_bits(y1 ^ y2))
        del got
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_normal_of_bits_matches_plain_on_every_pattern(cuda_device):
    """The draw's float chain on the card (`normal_of_bits`, the same
    device code) equals the plain one on all 2^23 patterns m << 9 a
    normal can come from, bit for bit: what licenses the kernel's cuts
    of code no pattern reaches."""
    bits = torch.arange(1 << 23, dtype=torch.int64, device=cuda_device) << 9
    got = pkernel.normal_of_bits(bits)
    want = prng._normal_from_bits(bits)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_threefry_normal_is_one_launch_and_takes_unaligned_keys(
        cuda_device):
    """A call on contiguous int64 keys runs the draw kernel and nothing
    else (no masking or copy of the keys), one launch counted; keys at an
    address that is not 16-byte aligned draw the same normals."""
    keys = prng.split(prng.key(2), 1569).to(cuda_device)
    pkernel.threefry_normal(keys, 2048)
    torch.cuda.synchronize()
    before = pkernel.threefry_normal.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = pkernel.threefry_normal(keys, 2048)
        torch.cuda.synchronize()
    assert pkernel.threefry_normal.launches == before + 1
    ran = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ran) == 1 and "threefry_normal_kernel" in ran[0], ran
    buf = torch.empty(2 * 1569 + 1, dtype=torch.int64, device=cuda_device)
    buf[1:] = keys.reshape(-1)
    odd = buf[1:].view(1569, 2)
    assert odd.data_ptr() % 16
    assert torch.equal(pkernel.threefry_normal(odd, 2048), got)
    assert torch.equal(got, threefry_normal_ref(keys, 2048))


@pytest.mark.gpu
@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4)])
def test_noisy_lenet_on_card_matches_host(cuda_device, r_in, r_w):
    """Noisy LeNet serving: the card's logits equal its reference and the
    host run bit for bit, cim_mbiw runs every planned tile in raw-dp mode
    and the draw kernel launches once per layer."""
    cim = CIMConfig(r_in=r_in, r_w=r_w, noise=NoiseConfig())
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(3), cim=cim))
    x = torch.from_numpy(make_dataset(1, 6, seed=1)[2][..., None])
    gpu = cnn.lenet_program(8, cim=cim).bind(params)
    cpu = cnn.lenet_program(8, cim=cim, device="cpu").bind(params)
    key = prng.key(1)
    kern, draw = tkernel.cim_mbiw_matmul_planes, pkernel.threefry_normal
    before = (kern.launches, draw.launches)
    y = gpu.serve(x, key)
    torch.cuda.synchronize()
    assert (kern.launches - before[0], draw.launches - before[1]) == \
        (gpu.plan.total_macro_evals, len(gpu.plan.layers))
    assert torch.equal(y, gpu.reference(x, key))
    assert torch.equal(y.cpu(), cpu.serve(x, key))
    assert not torch.equal(y, gpu.serve(x, prng.key(2)))


def _ring_inputs(r, l, h, hd, seed, device, last_chunk=False):
    """q, k/v as block 1 of a (R, 2, L, H, hd) state slab (strided views,
    as the scheduler passes them), and a bias with 1..L valid slots: the
    first ones, or with `last_chunk` only slots of the kernel's last
    chunk of RING_CHUNK slots (the chunks before it all masked)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((r, h, hd), generator=g)
    slab_k = torch.randn((r, 2, l, h, hd), generator=g)
    slab_v = torch.randn((r, 2, l, h, hd), generator=g)
    slot = torch.arange(l)[None, :]
    if last_chunk:
        c = rkernel.RING_CHUNK
        valid = torch.randint(1, l - c * ((l - 1) // c) + 1, (r,),
                              generator=g)
        keep = slot >= l - valid[:, None]
    else:
        valid = torch.randint(1, l + 1, (r,), generator=g)
        keep = slot < valid[:, None]
    bias = torch.where(keep, 0.0, -1e9)
    q, slab_k, slab_v, bias = (t.to(device) for t in (q, slab_k, slab_v,
                                                      bias))
    return q, slab_k[:, 1], slab_v[:, 1], bias


@pytest.mark.gpu
@pytest.mark.parametrize("last_chunk", (False, True),
                         ids=("first_slots", "last_chunk"))
@pytest.mark.parametrize("l", (1, 37, 129, 300, 2048))
@pytest.mark.parametrize("hd", (12, 128, 130, 256))
@pytest.mark.parametrize("h", (1, 16))
@pytest.mark.parametrize("r", (1, 3, 4, 8))
def test_ring_decode_kernel_matches_plain(cuda_device, r, h, hd, l,
                                          last_chunk):
    """Within rtol = atol = 1e-5 of the plain version (the sums run in
    another order), and each row bit for bit equal to a one-row call; L
    below, across and on the edges of the kernel's chunks, the valid
    slots first or only in the last chunk; hd 130 takes the kernel's
    4-byte copies, hd above 128 its 8 values a lane."""
    q, k, v, bias = _ring_inputs(r, l, h, hd, r * 1000 + l + hd,
                                 cuda_device, last_chunk)
    before = rkernel.ring_decode.launches
    got = rkernel.ring_decode(q, k, v, bias)
    torch.cuda.synchronize()
    assert rkernel.ring_decode.launches == before + rkernel.RING_KERNELS
    want = rref.ring_decode_attention_ref(q, k, v, bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for i in range(r):
        one = rkernel.ring_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                  bias[i:i + 1])
        assert torch.equal(got[i:i + 1], one)


@pytest.mark.gpu
def test_ring_decode_kernel_refuses_what_it_cannot_hold(cuda_device):
    q, k, v, bias = _ring_inputs(1, 8, 1, 12, 0, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        rkernel.ring_decode(q.double(), k, v, bias)
    big = torch.zeros((1, rkernel.MAX_WINDOW + 1, 1, 12),
                      device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        rkernel.ring_decode(q, big, big,
                            torch.zeros((1, big.shape[1]),
                                        device=cuda_device))


@pytest.mark.gpu
def test_segmented_serve_on_card_matches_host(cuda_device):
    specs = [tmap.LayerSpec(m=4, k=300, n=70, r_in=4, r_w=2),
             tmap.LayerSpec(m=4, k=70, n=9, r_in=4, r_w=2)]
    g = torch.Generator().manual_seed(2)
    host = tprog.compile_program(specs, device="cpu")
    params = host.init_params(g)
    card = tprog.compile_program(specs).bind(params)
    x = torch.randn((3, 300), generator=g) * torch.tensor([[1.0], [30.0],
                                                           [0.1]])
    seg = [0, 1, 2]
    y = card.serve(x, segments=seg)
    assert torch.equal(y, card.reference(x, segments=seg))
    assert torch.equal(y.cpu(), host.bind(params).serve(x, segments=seg))
    for out, req in zip(card.serve_batch([x[:1], x[1:]], isolate=True),
                        (x[:1], x[1:])):
        assert torch.equal(out, card.serve(req))


@pytest.mark.gpu
def test_decode_full_width_depth2_fused_equals_sequential(cuda_device):
    """OLMo-1B widths (d 2048, 16 heads, d_ff 8192, vocab 50304, window
    2048) at depth 2, two operating points: every fused stream equals its
    solo decode, and both kernels ran as planned."""
    model = CIMDecodeLM.toy(torch.Generator().manual_seed(1), d=2048,
                            depth=2, vocab=50304, n_heads=16, d_ff=8192,
                            window=2048, points={"quality": (8, 4)})
    reqs = [(0, Request(0, (11, 5000, 7), 3)),
            (0, Request(1, (3,), 4, "quality")),
            (1, Request(2, (42, 9), 2)),
            (2, Request(3, (50000,), 3))]
    kern = tkernel.cim_mbiw_matmul_planes
    kern.launches = kern.launches_splitk = 0
    rkernel.ring_decode.launches = 0
    sched = InflightScheduler(model, capacity=4)
    out = sched.run(reqs)
    torch.cuda.synchronize()
    calls = {p: sum(len(r.prompt) for _, r in reqs if r.point == p)
             + sched.points_served.get(p, 0) for p in model.points}
    tiles = {p: sum(b.qkv.program.plan.total_macro_evals
                    + b.o.plan.total_macro_evals
                    + b.gate_up.program.plan.total_macro_evals
                    + b.down.plan.total_macro_evals
                    for b in model.blocks_for(p)) for p in model.points}
    assert kern.launches == sum(tiles[p] * calls[p] for p in calls)
    assert kern.launches_splitk == kern.launches     # every tile: M <= 4
    # two kernels a call, depth 2
    assert rkernel.ring_decode.launches == \
        rkernel.RING_KERNELS * 2 * sum(calls.values())
    for _, r in reqs:
        assert out[r.uid] == decode_sequential(model, r)
        assert len(out[r.uid]) == r.max_new_tokens


# b, sq, sk, h, g, d, causal, window, q_off
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 77, 77, 16, 1, 128, True, 0, 0),
    (1, 100, 513, 2, 2, 128, False, 256, 100),
    (2, 512, 512, 16, 16, 128, True, 256, 0),
    (1, 1, 77, 2, 1, 64, True, 0, 100),
    (1, 400, 77, 4, 2, 64, True, 256, 0),    # rows that keep no key
    (1, 1024, 1024, 4, 2, 128, True, 256, 0),
    # above D 128: the CUDA-core kernels' second head-dimension bound
    # (float32; bf16 at D 192 and 200), the tensor-core kernels' D 256
    # designs (bf16 at D 256)
    (1, 77, 77, 10, 1, 256, True, 0, 0),
    (1, 1024, 1024, 10, 1, 256, True, 256, 0),     # MQA at rep 10
    (1, 100, 513, 2, 2, 200, False, 256, 100),
    (2, 300, 300, 4, 2, 256, False, 0, 0),
    (1, 400, 77, 4, 2, 192, True, 256, 0),    # rows that keep no key
    (1, 400, 77, 4, 2, 256, True, 256, 0),
    # whisper-medium's train step at D 64: the encoder's self-attention,
    # the decoder's and the cross-attention of 187 queries over 1500
    # frames (chip_smoke's FLASH_AUDIO)
    (1, 1500, 1500, 16, 16, 64, False, 0, 0),
    (1, 187, 187, 16, 16, 64, True, 0, 0),
    (1, 187, 1500, 16, 16, 64, False, 0, 0),
]


def _flash_inputs(case, dtype, device):
    b, sq, sk, h, g, d, causal, window, off = case
    rng = np.random.default_rng(sq * 31 + sk + h)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, sq, d),
                                                  dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, g, sk, d),
                                                 dtype=np.float32))
            for _ in range(2))
    q_off = torch.full((1, 1), off, dtype=torch.int32)
    return [t.to(device=device, dtype=dtype) for t in (q, k, v, do)] + [
        q_off.to(device)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernels_match_plain(cuda_device, case, dtype):
    """Forward within 2e-5 of the plain version, dq/dk/dv within 5e-5 (the
    JAX tests' tolerances, float32 outputs whatever the input dtype), a
    bf16 O within one bf16 ulp (rtol 2^-7, atol 2e-5: two float32 sums
    that differ in their last bits may round apart); each kernel launched
    once per call, bf16 at a D of its row of FLASH_TC_HEAD_DIMS on its
    tensor-core kernel (the forward, dq and dk/dv at D 64, 128 and 256),
    and the backward repeats bit for bit."""
    causal, window = case[6], case[7]
    q, k, v, do, q_off = _flash_inputs(case, dtype, cuda_device)
    kw = dict(causal=causal, window=window)
    f_tol, b_tol = 2e-5, 5e-5
    o_rtol = f_tol if dtype == torch.float32 else 2.0**-7
    tc = [dtype == torch.bfloat16
          and case[5] in rkernel.FLASH_TC_HEAD_DIMS[name]
          for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    counts = [f.launches for f in (rkernel.flash_fwd, rkernel.flash_bwd_dq,
                                   rkernel.flash_bwd_dkv)]
    counts_tc = [rkernel.flash_fwd.launches_tc,
                 rkernel.flash_bwd_dq.launches_tc,
                 rkernel.flash_bwd_dkv.launches_tc]
    o, lse = rkernel.flash_fwd(q, k, v, q_off, **kw)
    o_ref, lse_ref = rref.flash_fwd_ref(q, k, v, q_off, **kw)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=o_rtol,
                               atol=f_tol)
    torch.testing.assert_close(lse, lse_ref, rtol=f_tol, atol=f_tol)
    delta = torch.sum(do.float() * o_ref.float(), dim=-1)
    args = (q, k, v, do, lse_ref, delta, q_off)
    dq = rkernel.flash_bwd_dq(*args, **kw)
    dk, dv = rkernel.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(dq, rref.flash_bwd_dq_ref(*args, **kw),
                               rtol=b_tol, atol=b_tol)
    for got, want in zip((dk, dv), rref.flash_bwd_dkv_ref(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=b_tol, atol=b_tol)
    assert torch.equal(dq, rkernel.flash_bwd_dq(*args, **kw))
    dk2, dv2 = rkernel.flash_bwd_dkv(*args, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert [f.launches for f in (rkernel.flash_fwd, rkernel.flash_bwd_dq,
                                 rkernel.flash_bwd_dkv)] == \
        [counts[0] + 1, counts[1] + 2, counts[2] + 2]
    assert [rkernel.flash_fwd.launches_tc, rkernel.flash_bwd_dq.launches_tc,
            rkernel.flash_bwd_dkv.launches_tc] == \
        [n + calls * on for n, calls, on in zip(counts_tc, (1, 2, 2), tc)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", (128, 256))
def test_flash_misaligned_bf16_raises(cuda_device, d):
    """A bf16 operand that breaks the TMA loads' alignment (a base 2 bytes
    off 16) on a tensor-core route raises ValueError and launches nothing:
    no quiet route to the CUDA cores or the plain version.  The forward,
    dq and dk/dv are on the tensor cores at D 128 and 256 alike, so all
    three raise at both."""
    q, k, v, do, q_off = _flash_inputs((1, 64, 64, 2, 1, d, True, 0, 0),
                                       torch.bfloat16, cuda_device)
    bad = torch.empty(q.numel() + 1, dtype=q.dtype,
                      device=cuda_device)[1:].view(q.shape).copy_(q)
    assert bad.data_ptr() % 16
    kw = dict(causal=True)
    o_ref, lse = rref.flash_fwd_ref(q, k, v, q_off, **kw)
    delta = torch.sum(do.float() * o_ref.float(), dim=-1)
    kerns = (rkernel.flash_fwd, rkernel.flash_bwd_dq, rkernel.flash_bwd_dkv)
    counts = [f.launches for f in kerns]
    with pytest.raises(ValueError, match="not aligned"):
        rkernel.flash_fwd(bad, k, v, q_off, **kw)
    with pytest.raises(ValueError, match="not aligned"):
        rkernel.flash_bwd_dkv(bad, k, v, do, lse, delta, q_off, **kw)
    with pytest.raises(ValueError, match="not aligned"):
        rkernel.flash_bwd_dq(bad, k, v, do, lse, delta, q_off, **kw)
    assert [f.launches for f in kerns] == counts


@pytest.mark.gpu
def test_flash_above_head_dim_256_raises(cuda_device):
    """D 256 is the CUDA-core kernels' largest bound; above it every
    kernel refuses the call (no quiet route to the plain version)."""
    q, k, v, do, q_off = _flash_inputs((1, 8, 8, 2, 1, 288, True, 0, 0),
                                       torch.float32, cuda_device)
    lse = torch.zeros(q.shape[:3], device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        rkernel.flash_fwd(q, k, v, q_off, causal=True)
    for fn in (rkernel.flash_bwd_dq, rkernel.flash_bwd_dkv):
        with pytest.raises(ValueError, match="head dim"):
            fn(q, k, v, do, lse, lse, q_off, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("mamba2_1_3b", "recurrentgemma_2b"))
def test_recurrent_train_step_on_card_matches_host(cuda_device, arch):
    """One float32 step of the smoke config with the flash kernels
    (recurrentgemma's local attention at D 32 on the CUDA-core kernels)
    on the card against the host's plain versions: in bypass the loss
    and grad norm within 1e-5 relative; in fakequant within
    tests/test_torch_train.py's float32 fakequant tolerances (5e-3,
    2e-2: an ulp of the float glue moves activation codes)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cim_layers import CIMConfig as C
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, size=(2, 64))).long()
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    for mode, (t_loss, t_gnorm) in (("bypass", (1e-5, 1e-5)),
                                    ("fakequant", (5e-3, 2e-2))):
        cfg = get_smoke_config(arch).replace(
            dtype="float32", attn_impl="pallas",
            cim=C(mode=mode, max_gamma=2.0**16))
        out = {}
        card = tf.init_params(
            cfg, torch.Generator(device=cuda_device).manual_seed(0))
        host = _to_host(card)
        for dev, params in ((cuda_device, card),
                            (torch.device("cpu"), host)):
            state = steps.train_state(params)
            fl = rkernel.flash_fwd.launches
            _, m = steps.make_train_step(cfg, AdamWConfig(lr=1e-3))(
                state, {k: v.to(dev) for k, v in batch.items()})
            out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                             rkernel.flash_fwd.launches - fl)
        (lc, gc, nc), (lh, gh, nh) = out["cuda"], out["cpu"]
        assert abs(lc - lh) <= t_loss * abs(lh), (mode, lc, lh)
        assert abs(gc - gh) <= t_gnorm * gh, (mode, gc, gh)
        assert nh == 0 and nc == (1 if arch == "recurrentgemma_2b" else 0)


@pytest.mark.gpu
def test_audio_on_card_matches_host(cuda_device):
    """whisper-medium's smoke config in float32 with the flash kernels
    (the encoder's, the decoder's and the cross-attention, Sq 8 over Sk
    24, on the CUDA-core kernels): the bypass forward over frames on the
    card within 1e-5 of the host's largest logit, a cached prefill and a
    decode step reading the cross K/V likewise, and one train step in
    bypass (loss and grad norm within 1e-5) and fakequant (5e-3, 2e-2,
    tests/test_torch_train.py's float32 fakequant tolerances) against
    the host's plain versions; the card's step launches a flash forward
    an encoder layer and two a decoder layer (no recompute: the smoke
    config does not remat)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cim_layers import CIMConfig as C
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 512, size=(2, 8))).long()
    frames = torch.from_numpy(rng.standard_normal((2, 24, 64),
                                                  dtype=np.float32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
             "encoder_frames": frames}
    for mode, (t_loss, t_gnorm) in (("bypass", (1e-5, 1e-5)),
                                    ("fakequant", (5e-3, 2e-2))):
        cfg = get_smoke_config("whisper_medium").replace(
            dtype="float32", attn_impl="pallas",
            cim=C(mode=mode, max_gamma=2.0**16))
        card = tf.init_params(
            cfg, torch.Generator(device=cuda_device).manual_seed(0))
        host = _to_host(card)
        if mode == "bypass":
            with torch.no_grad():
                logits = {}
                for dev, params in ((cuda_device, card),
                                    (torch.device("cpu"), host)):
                    free = tf.forward(cfg, params, toks.to(dev),
                                      encoder_frames=frames.to(dev))[0]
                    cache = tf.init_cache(cfg, 2, max_len=24,
                                          dtype=torch.float32, device=dev)
                    pre, cache, _ = tf.forward(
                        cfg, params, toks[:, :1].to(dev), cache=cache,
                        encoder_frames=frames.to(dev))
                    dec, _, _ = tf.forward(cfg, params, toks[:, 1:2].to(dev),
                                           cache=cache)
                    logits[dev.type] = [t.cpu() for t in (free, pre, dec)]
            for got, want in zip(logits["cuda"], logits["cpu"]):
                assert float((got - want).abs().max()) <= \
                    1e-5 * float(want.abs().max())
        out = {}
        for dev, params in ((cuda_device, card),
                            (torch.device("cpu"), host)):
            state = steps.train_state(params)
            fl = rkernel.flash_fwd.launches
            _, m = steps.make_train_step(cfg, AdamWConfig(lr=1e-3))(
                state, {k: v.to(dev) for k, v in batch.items()})
            out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                             rkernel.flash_fwd.launches - fl)
        (lc, gc, nc), (lh, gh, nh) = out["cuda"], out["cpu"]
        assert abs(lc - lh) <= t_loss * abs(lh), (mode, lc, lh)
        assert abs(gc - gh) <= t_gnorm * gh, (mode, gc, gh)
        assert nh == 0 and nc == cfg.encoder_layers + 2 * cfg.n_layers


@pytest.mark.gpu
def test_flash_attention_grads_on_card(cuda_device):
    """The autograd Function on the card against autograd through the
    plain softmax oracle, (B, S, H, D) layout, GQA, causal window."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 200, 4, 64),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 200, 2, 64),
                                                 dtype=np.float32))
            for _ in range(2))
    grads = []
    for fn in (lambda a, b_, c: flash_attention(a, b_, c, True, 64),
               lambda a, b_, c: rref.attention_ref(
                   a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
                   causal=True, window=64).transpose(1, 2)):
        ts = [t.to(cuda_device).requires_grad_() for t in (q, k, v)]
        torch.sin(fn(*ts)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=5e-5, atol=5e-5)


@pytest.mark.gpu
def test_train_step_full_width_depth2(cuda_device):
    """OLMo-1B widths (d 2048, 16 heads of 128, d_ff 8192, vocab 50304) at
    depth 2, fakequant projections, flash attention, remat, sequence 1024:
    one AdamW step with a finite loss and grad norm, the flash kernels
    launched 2 (forward) + 2 (recompute) times and the backward kernels
    twice each, and TF32 off (the fakequant products are exact integers
    in float32)."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("olmo_1b").replace(
        n_layers=2, cim=CIMConfig(mode="fakequant", max_gamma=2.0**16),
        attn_impl="pallas")
    state = steps.init_train_state(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                    global_batch=1))
    toks, labels = data.batch_at(0)
    batch = {"tokens": torch.from_numpy(toks).long().to(cuda_device),
             "labels": torch.from_numpy(labels).long().to(cuda_device)}
    step = steps.make_train_step(cfg, AdamWConfig(), total_steps=3,
                                 warmup=1)
    kerns = (rkernel.flash_fwd, rkernel.flash_bwd_dq, rkernel.flash_bwd_dkv)
    before = [f.launches for f in kerns]
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(kerns, before)] == [4, 2, 2]
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert int(state["opt"]["step"]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("api", ("flag", "precision"))
def test_fakequant_forward_exact_with_tf32_on(cuda_device, api):
    """With TF32 turned on by the caller, the fakequant forward on the card
    equals its forward with TF32 off bit for bit, and the caller's setting
    reads as it was.  A control with 12-bit integer operands (more than
    TF32's 11-bit significand holds; every sum below 2^24, so exact in
    float32) shows that TF32 was on and that the pin inside the forward
    (`exact_float32_matmul`) undoes it."""
    from repro_torch.core.cim_layers import (cim_linear_apply,
                                             exact_float32_matmul)
    g = torch.Generator().manual_seed(4)
    k, n = 1152, 256
    x = torch.randn((8, k), generator=g).to(cuda_device)
    p = {"w": (torch.randn((k, n), generator=g) / k ** 0.5).to(cuda_device),
         "abn_log_gamma": torch.rand(n, generator=g).to(cuda_device) * 9,
         "abn_beta": (torch.rand(n, generator=g).to(cuda_device) - 0.5) * 6}
    cfg = CIMConfig(mode="fakequant", max_gamma=2.0**16)
    mm = torch.backends.cuda.matmul
    assert not mm.allow_tf32
    want = cim_linear_apply(p, x, cfg)
    a = torch.randint(0, 2**12, (64, 256), generator=g).double()
    b = torch.randint(-8, 8, (256, n), generator=g).double()
    exact = (a @ b).to(cuda_device)          # float64 on the host: exact
    a, b = a.float().to(cuda_device), b.float().to(cuda_device)
    try:
        if api == "flag":
            mm.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        got = cim_linear_apply(p, x, cfg)
        assert mm.allow_tf32
        assert not torch.equal((a @ b).double(), exact)
        with exact_float32_matmul():
            pinned = a @ b
        assert mm.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(got, want)
    assert torch.equal(pinned.double(), exact)


# ---- captured executables: one CUDA graph per clean dispatch key -----------

def _eager(bound, x, segments=None):
    """engine._forward at the bucket extent, called directly (the eager
    yardstick of a captured dispatch)."""
    prog = bound.program
    xc = torch.as_tensor(x).to(prog.device, torch.float32)
    m = xc.shape[0]
    b = prog.buckets.bucket_for(m)
    xp = torch.cat([xc, xc[:1].expand((b - m,) + tuple(xc.shape[1:]))])
    seg = None
    if segments is not None:
        s = torch.as_tensor(segments).to(prog.device, torch.int64)
        seg = torch.cat([s, s[:1].expand(b - m)])
    return trt._forward(prog.plan, bound._binds, xp, reference=False,
                        m_valid=m, seg=seg)[:m]


def _graph_case(kind, device):
    """(bound program, inputs of 20 rows) - a dense two-layer program
    with a K > 1152 row tile, or LeNet at (4, 2)."""
    if kind == "dense":
        specs = [tmap.LayerSpec(m=8, k=1300, n=140, r_in=4, r_w=2),
                 tmap.LayerSpec(m=8, k=140, n=10, r_in=4, r_w=2)]
        prog = tprog.compile_program(specs, device=device)
        params = prog.init_params(torch.Generator().manual_seed(4))
        x = torch.randn((20, 1300), generator=torch.Generator().manual_seed(5))
        return prog.bind(params), x
    cim = CIMConfig(r_in=4, r_w=2)
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(3), cim=cim))
    x = torch.from_numpy(make_dataset(1, 20, seed=3)[2][..., None])
    return cnn.lenet_program(20, cim=cim, device=device).bind(params), x


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("dense", "lenet"))
def test_graph_replay_equals_eager_every_rung(cuda_device, kind):
    """Every rung of the ladder over 1..20 rows: the capture call and the
    replays are torch.equal to engine._forward run eagerly, and to the
    card's reference."""
    bound, x = _graph_case(kind, cuda_device)
    st0 = bound.stats()
    rungs = bound.program.buckets.ladder(20)
    for b in rungs:
        m = min(b, 20)
        for rows in (x[:m], x.flip(0)[:m]):
            first = bound.serve(rows)
            again = bound.serve(rows)
            want = _eager(bound, rows)
            assert torch.equal(first, want) and torch.equal(again, want)
            assert torch.equal(again, bound.reference(rows))
    st = bound.stats()
    assert st["graphs_captured"] - st0["graphs_captured"] == len(rungs)
    assert len(bound.executables) == len(rungs)
    assert st["graph_replays"] - st0["graph_replays"] == 3 * len(rungs)


@pytest.mark.gpu
def test_zero_captures_after_warmup(cuda_device):
    """Batch sizes that share a rung reuse one graph: CAPTURE_COUNT stays
    flat and every call is a replay (tests/test_program.py's zero
    re-tracing, on the card)."""
    bound, x = _graph_case("dense", cuda_device)
    bound.serve(x[:8])
    captures, st0 = trt.CAPTURE_COUNT["n"], bound.stats()
    for m in (5, 6, 7, 8):
        assert torch.equal(bound.serve(x[:m]), _eager(bound, x[:m]))
    st = bound.stats()
    assert trt.CAPTURE_COUNT["n"] == captures
    assert st["graph_replays"] - st0["graph_replays"] == 4
    assert st["eager_calls"] == st0["eager_calls"]


@pytest.mark.gpu
def test_graphs_replayed_out_of_capture_order(cuda_device):
    """Graphs share one memory pool: replayed in the reverse of their
    capture order, and interleaved across two programs, each gives the
    eager bits."""
    dense, xd = _graph_case("dense", cuda_device)
    lenet, xl = _graph_case("lenet", cuda_device)
    calls = [(dense, xd[:3]), (lenet, xl[:9]), (dense, xd[:16]),
             (lenet, xl[:2])]
    want = [_eager(b, x) for b, x in calls]
    for (b, x), w in zip(calls, want):
        assert torch.equal(b.serve(x), w)                 # capture order
    for (b, x), w in reversed(list(zip(calls, want))):
        assert torch.equal(b.serve(x), w)                 # reversed
    for i in (1, 3, 0, 2, 3, 1):
        assert torch.equal(calls[i][0].serve(calls[i][1]), want[i])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("dense", "lenet"))
def test_replay_launch_counts_equal_eager(cuda_device, kind):
    """N replays add to each route's counter what N eager forwards
    launch, and the capture call counts one forward (its warm-up)."""
    bound, x = _graph_case(kind, cuda_device)
    x = x[:3] if kind == "dense" else x[:20]
    before = tkernel.launch_counts()
    bound.serve(x)                                      # capture
    first = {c: n - before[c] for c, n in tkernel.launch_counts().items()}
    counts = []
    for fn in (lambda: bound.serve(x), lambda: _eager(bound, x)):
        before = tkernel.launch_counts()
        for _ in range(5):
            fn()
        counts.append({c: n - before[c]
                       for c, n in tkernel.launch_counts().items()})
    torch.cuda.synchronize()
    assert counts[0] == counts[1]
    assert counts[0] == {c: 5 * n for c, n in first.items()}
    want = tkernel.route_counts(bound.plan.tile_calls(
        bound.program.buckets.bucket_for(x.shape[0])))
    # an untuned plan runs no tuned tile
    assert first == {"launches": sum(want.values()),
                     "launches_tc": want["tc"],
                     "launches_splitk": want["splitk"],
                     "launches_tuned": 0}


@pytest.mark.gpu
def test_splitk_workspace_holds_after_a_larger_capture(cuda_device):
    """Capture a small route-B dispatch, then one whose workspace must
    grow: the first graph keeps its (retired) workspace and still
    replays the eager bits."""
    dev = torch.device("cuda", torch.cuda.current_device())
    ws = tkernel._WORKSPACE.pop(dev, None)
    if ws is not None:
        tkernel._RETIRED_WORKSPACES.append(ws)
    small = tprog.compile_program(
        [tmap.LayerSpec(m=1, k=256, n=64, r_in=4, r_w=2)],
        activations=("none",), device=cuda_device)
    large = tprog.compile_program(
        [tmap.LayerSpec(m=32, k=2048, n=4096, r_in=8, r_w=4)],
        activations=("none",), device=cuda_device)
    g = torch.Generator().manual_seed(6)
    bs, bl = (p.bind(p.init_params(g)) for p in (small, large))
    xs, xl = torch.randn((1, 256), generator=g), torch.randn((32, 2048),
                                                             generator=g)
    before = tkernel.launch_counts()["launches_splitk"]
    ys = bs.serve(xs)
    ws_small = tkernel._WORKSPACE[dev]
    yl = bl.serve(xl)
    assert tkernel._WORKSPACE[dev] is not ws_small
    assert any(w is ws_small for w in tkernel._RETIRED_WORKSPACES)
    assert tkernel.launch_counts()["launches_splitk"] > before
    for _ in range(3):
        assert torch.equal(bs.serve(xs), ys)
        assert torch.equal(bl.serve(xl), yl)
    assert torch.equal(ys, _eager(bs, xs)) and torch.equal(yl, _eager(bl, xl))
    assert int(ws_small.abs().sum()) == 0


@pytest.mark.gpu
def test_result_held_across_a_later_replay(cuda_device):
    """A caller's result is a clone: a later replay of the same graph on
    other rows does not overwrite it."""
    bound, x = _graph_case("dense", cuda_device)
    bound.serve(x[:4])
    y1 = bound.serve(x[:4])
    keep = y1.clone()
    y2 = bound.serve(x[4:8])
    torch.cuda.synchronize()
    assert torch.equal(y1, keep) and not torch.equal(y1, y2)
    assert torch.equal(y2, _eager(bound, x[4:8]))


@pytest.mark.gpu
def test_graph_routes_on_the_card(cuda_device):
    """serve_batch, shared and isolated, and a segmented serve replay
    graphs with the eager bits; keyed, reference and per-call-params
    dispatches on the card run eagerly and count in eager_calls."""
    bound, x = _graph_case("dense", cuda_device)
    prog = bound.program
    reqs = [x[:1], x[1:4], x[4:9]]
    for _ in range(2):
        shared = bound.serve_batch(reqs)
        isolated = bound.serve_batch(reqs, isolate=True)
    assert torch.equal(torch.cat(shared), _eager(bound, x[:9]))
    seg = torch.repeat_interleave(torch.arange(3), torch.tensor([1, 3, 5]))
    assert torch.equal(torch.cat(isolated), _eager(bound, x[:9], seg))
    for out, r in zip(isolated, reqs):
        assert torch.equal(out, bound.serve(r))
    st0, captures = prog.stats(), trt.CAPTURE_COUNT["n"]
    params = prog.init_params(torch.Generator().manual_seed(4))
    bound.serve(x[:3], prng.key(0))
    bound.reference(x[:3])
    prog.run(params, x[:3])
    prog.serve(params, x[:3])
    st = prog.stats()
    assert st["eager_calls"] - st0["eager_calls"] == 4
    assert st["graphs_captured"] == st0["graphs_captured"]
    assert trt.CAPTURE_COUNT["n"] == captures


@pytest.mark.gpu
def test_decode_captures_once_and_fused_equals_solo(cuda_device):
    """In-flight decode at small widths replays graphs for every
    projection: a second run of the same schedule captures nothing, and
    every fused stream still equals its solo decode."""
    model = CIMDecodeLM.toy(torch.Generator().manual_seed(2), d=96,
                            depth=2, vocab=61, points={"quality": (8, 4)})
    reqs = [(0, Request(0, (1, 2), 4)), (0, Request(1, (5,), 3, "quality")),
            (1, Request(2, (7, 8, 9), 3)), (2, Request(3, (4,), 2))]
    out = InflightScheduler(model, capacity=4).run(reqs)
    bounds = [p for pt in model.points for blk in model.blocks_for(pt)
              for p in (blk.qkv.bound, blk.o, blk.gate_up.bound, blk.down)]
    held = sum(len(b.executables) for b in bounds)
    captures = trt.CAPTURE_COUNT["n"]
    assert InflightScheduler(model, capacity=4).run(reqs) == out
    for _, r in reqs:
        assert out[r.uid] == decode_sequential(model, r)
    assert trt.CAPTURE_COUNT["n"] == captures
    assert sum(len(b.executables) for b in bounds) == held > 0


# ---------------------------------------------------------------------------
# the LM serving path (launch/serve.py) at OLMo-1B's smoke config
# ---------------------------------------------------------------------------

def _serve_cfg(mode, dtype="bfloat16", **cim):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("olmo_1b")
    return cfg.replace(cim=CIMConfig(mode=mode, max_gamma=2.0**16, **cim),
                       dtype=dtype)


def _serve_params(cfg, device):
    from repro_torch.models import transformer as ttf
    return ttf.init_params(cfg, torch.Generator(device=device).manual_seed(0))


def _serve_prompt(device):
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, 512, (4, 32), generator=g).to(device)


def _eager_serve(bound, x, key=None, noise=None, *, segments=None,
                 noise_ids=None, reference=False, point=""):
    """BoundProgram.serve with the clean dispatch run by engine._forward
    eagerly, padded to its bucket as serve pads it (no graph)."""
    assert key is None and noise is None and not reference
    prog = bound.program
    xc, lead = prog._canon(x)
    m = xc.shape[0]
    b = prog.buckets.bucket_for(m)
    xp = torch.cat([xc, xc[:1].expand((b - m,) + tuple(xc.shape[1:]))])
    seg = None
    if segments is not None:
        sg = torch.as_tensor(segments).to(prog.device, torch.int64)
        seg = torch.cat([sg, sg[:1].expand(b - m)])
    y = trt._forward(prog.plan, bound._binds, xp, reference=False,
                     m_valid=m, seg=seg)
    return y[:m].reshape(lead + tuple(y.shape[1:]))


@pytest.mark.gpu
def test_serve_engine_decode_replay_equals_eager(cuda_device, monkeypatch):
    """A cached engine-mode decode step replays one graph per projection
    and equals the same step with every projection run eagerly."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as ttf
    cfg = _serve_cfg("engine")
    params = _serve_params(cfg, cuda_device)
    out = serve.static_serve(cfg, params, _serve_prompt(cuda_device), 3,
                             max_len=48)
    cache = out["cache"]
    tok = out["tokens"][:, -1:].to(cuda_device)
    snap = {k: v.clone() for k, v in cache["layers"]["kv"].items()}
    pos = cache["pos"].clone()
    with torch.no_grad():
        graph_logits = ttf.forward(cfg, params, tok, cache=cache)[0]
        cache["layers"]["kv"].update({k: v.clone() for k, v in snap.items()})
        cache["pos"] = pos
        captures = trt.CAPTURE_COUNT["n"]
        monkeypatch.setattr(tprog.BoundProgram, "serve", _eager_serve)
        eager_logits = ttf.forward(cfg, params, tok, cache=cache)[0]
    torch.cuda.synchronize()
    assert trt.CAPTURE_COUNT["n"] == captures
    assert torch.equal(graph_logits, eager_logits)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_engine_equals_fakequant_on_card(cuda_device, dtype):
    from repro_torch.launch import serve
    out = {}
    for mode in ("fakequant", "engine"):
        cfg = _serve_cfg(mode, dtype)
        out[mode] = serve.static_serve(
            cfg, _serve_params(cfg, cuda_device),
            _serve_prompt(cuda_device), 4, max_len=48, keep_logits=True)
    assert torch.equal(out["engine"]["tokens"], out["fakequant"]["tokens"])
    for a, b in zip(out["engine"]["logits"], out["fakequant"]["logits"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_serve_no_capture_after_warmup(cuda_device):
    """After the first decode step, no plan, no capture and no eager
    dispatch: every projection replays its graph."""
    from repro_torch.launch import serve
    cfg = _serve_cfg("engine")
    out = serve.static_serve(cfg, _serve_params(cfg, cuda_device),
                             _serve_prompt(cuda_device), 6, max_len=48)
    assert out["steps"] == 5
    assert out["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0}


@pytest.mark.gpu
def test_serve_card_matches_host(cuda_device):
    """The card's engine-mode serve against the host's on the same
    weights and prompt: tokens equal, each step's logits within 0.1 of
    the host's (|card - host| / |host|; the float glue rounds
    differently on the two devices, as against JAX, see
    tests/test_torch_serve.py)."""
    from repro_torch.launch import serve
    cfg = _serve_cfg("engine")
    params = _serve_params(cfg, cuda_device)
    prompt = _serve_prompt(cuda_device)
    card = serve.static_serve(cfg, params, prompt, 4, max_len=48,
                              keep_logits=True)
    host = serve.static_serve(cfg, _to_host(params), prompt.cpu(), 4,
                              max_len=48, keep_logits=True)
    assert torch.equal(card["tokens"], host["tokens"])
    for a, b in zip(card["logits"], host["logits"]):
        a, b = a.float().cpu(), b.float()
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) < 0.1


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    return tree.cpu()


@pytest.mark.gpu
def test_serve_inflight_equals_solo_on_card(cuda_device):
    from repro_torch.launch import serve
    cfg = _serve_cfg("engine", isolate_rows=True)
    params = _serve_params(cfg, cuda_device)
    reqs = serve.make_requests(cfg.vocab_size, 6, 8, 5, seed=2)
    fused = serve.inflight_serve(cfg, params, reqs, 4, max_len=24,
                                 device=cuda_device)
    assert fused["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0}
    for r in reqs:
        solo = serve.inflight_serve(cfg, params, [dict(r, arrival=0)], 4,
                                    max_len=24, device=cuda_device)
        assert solo["tokens"][r["uid"]] == fused["tokens"][r["uid"]]


# ---------------------------------------------------------------------------
# workload-adaptive precision serving (precision/, perfmodel/)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_precision_ladder_rungs_on_card_equal_host(cuda_device):
    """LeNet calibrated on the card (clean, two swept points) gives the
    host's profile; each rung of the ladder planned from it serves
    through its CUDA graph bit for bit equal to the card reference and
    to the host's serve of the same params."""
    from repro_torch import precision as tpr
    specs, acts, pools = cnn.lenet_engine_specs(4)
    kw = dict(points=((1, 1), (2, 2)), n_trials=1, batch=4, seed=3,
              activations=acts, pools=pools, cache_path="")
    card = tpr.calibrate(specs, trt.EngineConfig(), device=cuda_device, **kw)
    host = tpr.calibrate(specs, trt.EngineConfig(), device="cpu", **kw)
    assert card.to_dict() == host.to_dict()
    ladder = tpr.plan_ladder(card, specs, activations=acts, pools=pools,
                             device=cuda_device)
    hladder = tpr.plan_ladder(card, specs, activations=acts, pools=pools,
                              device="cpu")
    assert ladder.report() == hladder.report()
    x = torch.from_numpy(make_dataset(n_train=1, n_test=16,
                                      seed=0)[2][..., None])
    for name in ladder.names():
        prog, hprog = ladder.program(name), hladder.program(name)
        params = prog.init_params(prng.key(5, device=cuda_device))
        hparams = hprog.init_params(prng.key(5))
        for p, hp in zip(params, hparams):
            assert all(torch.equal(p[k].cpu(), hp[k]) for k in p)
        bound = prog.bind(params)
        captures = trt.CAPTURE_COUNT["n"]
        y = bound.serve(x.to(cuda_device), point=name)
        assert trt.CAPTURE_COUNT["n"] == captures + 1
        assert torch.equal(y, bound.reference(x.to(cuda_device), point=name))
        assert torch.equal(y.cpu(), hprog.bind(hparams).serve(x, point=name))


@pytest.mark.gpu
def test_precision_policy_mixed_inflight_on_card(cuda_device, monkeypatch,
                                                 tmp_path):
    """`launch/serve.py --precision-policy mixed --assert-no-recompile`
    on the card: every request == its solo decode at its point, no plan,
    capture or eager dispatch after warm-up, the host's assignments."""
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_PRECISION_PROFILES",
                       str(tmp_path / "profiles.json"))
    argv = ["--arch", "olmo-1b", "--cim-mode", "engine", "--inflight",
            "--precision-policy", "mixed", "--assert-no-recompile"]
    out = serve.main(argv)
    assert out["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0}
    monkeypatch.setenv("REPRO_PRECISION_PROFILES",
                       str(tmp_path / "host.json"))
    host = serve.main(argv + ["--device", "cpu"])
    assert host["points"] == out["points"]
    assert host["streams"] == out["streams"]


@pytest.mark.gpu
def test_full_width_projection_calibration_equals_host(cuda_device):
    """One projection of OLMo-1B at full width (down, 8192 -> 2048: eight
    row tiles) calibrated on the card at (1, 1) and (2, 2): the params
    drawn on the card from the key equal the host's, and so does the
    profile."""
    from repro_torch import precision as tpr
    spec = tmap.LayerSpec(m=8, k=8192, n=2048, r_in=8, r_w=4)
    kw = dict(points=((1, 1), (2, 2)), n_trials=1, batch=4, seed=0,
              cache_path="")
    card = tpr.calibrate([spec], trt.EngineConfig(), device=cuda_device,
                         **kw)
    host = tpr.calibrate([spec], trt.EngineConfig(), device="cpu", **kw)
    assert card.to_dict() == host.to_dict()
    assert 0 < card.delta(0, (2, 2)) < card.delta(0, (1, 1))
    prog = tprog.compile_program([spec], activations=("none",),
                                 device=cuda_device)
    key = prng.fold_in(prng.key(0), 10)
    (p,) = prog.init_params(key.to(cuda_device))
    (hp,) = tprog.compile_program([spec], activations=("none",),
                                  device="cpu").init_params(key)
    assert all(p[k].is_cuda and torch.equal(p[k].cpu(), hp[k]) for k in p)


# ---- the schedule tuner ----------------------------------------------------

# (m, k, n, r_in, r_w): route A at one and two planes (BM 128 below M 128
# too), route B at one and two planes, route C
TILE_SHAPES = [(256, 784, 128, 4, 2), (256, 784, 64, 8, 4),
               (100, 1152, 64, 8, 4), (4, 1024, 128, 4, 2),
               (4, 1024, 64, 8, 4), (784, 9, 16, 8, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,r_in,r_w", TILE_SHAPES)
def test_every_legal_tile_matches_plain(cuda_device, m, k, n, r_in, r_w):
    """Every tile the tuner may pick runs in place of the shape's own
    (`.launches_tuned` rises once a call) and equals the plain version
    bit for bit, in both ADC modes."""
    shift, args = _case(m, k, n, r_in, r_w, m + k + n, False)
    dev_args = [a.to(cuda_device) for a in args]
    planes = args[0].shape[1] // k
    kern = tkernel.cim_mbiw_matmul_planes
    tiles = tkernel.legal_tiles(m, n, k, planes)
    assert tiles
    for fuse in (True, False):
        kw = dict(plane_shift=shift, g0=0.01, r_out=8, fuse_adc=fuse)
        want = tref.cim_mbiw_matmul_planes_ref(*dev_args, **kw)
        for tile in tiles:
            before = (kern.launches, kern.launches_tuned)
            got = kern(*dev_args, tile=tile, **kw)
            torch.cuda.synchronize()
            assert (kern.launches, kern.launches_tuned) == \
                (before[0] + 1, before[1] + 1)
            assert torch.equal(got, want), tile


def _spearman(a, b):
    def rank(v):
        r = [0] * len(v)
        for pos, i in enumerate(sorted(range(len(v)), key=lambda i: v[i])):
            r[i] = pos
        return r
    ra, rb = rank(a), rank(b)
    n = len(a)
    return 1.0 - 6.0 * sum((x - y) ** 2 for x, y in zip(ra, rb)) / (
        n * (n * n - 1))


@pytest.mark.gpu
def test_tuned_lenet_bitexact_in_both_modes(cuda_device, tmp_path):
    """compile_program(tune="analytic" | "measure") of LeNet at batch 256
    serves bit for bit like tune="off" (through the graphs), and a tuned
    tile that differs from route_for's ran (`.launches_tuned`)."""
    from repro_torch.core.cim_layers import _engine_config
    from repro_torch.tuner import search as tsearch
    cim = CIMConfig(r_in=4, r_w=2)
    specs, acts, pools = cnn.lenet_engine_specs(256, cim=cim)
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
    x = torch.from_numpy(make_dataset(n_train=1, n_test=256,
                                      seed=0)[2][..., None])
    kw = dict(activations=acts, pools=pools, device=cuda_device)
    y0 = tprog.compile_program(specs, _engine_config(cim), **kw).bind(
        params).serve(x)
    kern = tkernel.cim_mbiw_matmul_planes
    for mode in ("analytic", "measure"):
        # one file a mode: the cache keys winners by layer, not by mode
        path = str(tmp_path / f"{mode}.json")
        prog = tprog.compile_program(specs, _engine_config(cim), tune=mode,
                                     tune_cache=path, **kw)
        tuned = [lp.blocks for lp in prog.plan.layers
                 if lp.blocks is not None]
        before = kern.launches_tuned
        y = prog.bind(params).serve(x)
        torch.cuda.synchronize()
        assert torch.equal(y, y0), mode
        if mode == "analytic":
            assert tuned
        if tuned:
            assert kern.launches_tuned > before
        n0 = tsearch.SEARCH_COUNT["n"]
        tprog.clear_program_cache()
        tprog.compile_program(specs, _engine_config(cim), tune=mode,
                              tune_cache=path, **kw)
        assert tsearch.SEARCH_COUNT["n"] == n0      # every layer a hit


@pytest.mark.gpu
def test_cost_spearman_vs_event_time(cuda_device):
    """The analytic cost of JAX's five pinned shapes (tests/test_tuner.py)
    ranks them as the card's CUDA-event time of their dispatches does,
    at Spearman >= 0.7."""
    from repro_torch import tuner as ttuner
    from repro_torch.tuner import search as tsearch
    shapes = [(64, 1152, 128), (96, 1152, 256), (128, 1152, 512),
              (256, 1152, 512), (512, 1152, 1024)]
    predicted, measured = [], []
    for m, k, n in shapes:
        spec = tmap.LayerSpec(m=m, k=k, n=n, r_in=4, r_w=2)
        heur = ttuner.heuristic_choice(spec, trt.EngineConfig())
        predicted.append(ttuner.layer_cost(spec, heur).total_s)
        mp = tmap.map_layer(spec)
        measured.append(mp.macro_evals * tsearch._measure_choice_s(
            spec, heur, DEFAULT_MACRO, cuda_device))
    rho = _spearman(predicted, measured)
    assert rho >= 0.7, (rho, predicted, measured)


def _nll(logits, labels):
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(lp, 1, labels[:, None].long()))


@pytest.mark.gpu
@pytest.mark.parametrize("noisy", (False, True))
def test_lenet_train_step_on_card_matches_host(cuda_device, noisy):
    """CIM-aware LeNet training (fakequant at (4, 2)): the card's logits
    equal the host's bit for bit, clean and under one noise key (the
    draws through threefry_normal), and the gradients agree within
    tests/test_torch_fakequant.py's `_close_grad` (the conv ABN gains,
    sums over every output pixel, within 1e-4 of the largest)."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cim = CIMConfig(r_in=4, r_w=2, noise=NoiseConfig() if noisy
                    else NoiseConfig(enabled=False))
    host = tree_map(lambda t: t.requires_grad_(True),
                    cnn.init_lenet(prng.key(0), cim=cim))
    card = tree_map(lambda t: t.detach().to(cuda_device)
                    .requires_grad_(True), host)
    _, _, x, y = make_dataset(n_train=1, n_test=32, seed=4)
    xh, yh = torch.from_numpy(x)[..., None], torch.from_numpy(y).long()
    key = prng.key(3) if noisy else None
    draw = pkernel.threefry_normal
    before = draw.launches
    yc = cnn.lenet_forward(card, xh.to(cuda_device), cim, key=key)
    torch.cuda.synchronize()
    assert (draw.launches > before) == noisy
    yhost = cnn.lenet_forward(host, xh, cim, key=key)
    assert torch.equal(yc.detach().cpu(), yhost.detach())
    gc = torch.autograd.grad(_nll(yc, yh.to(cuda_device)), tree_leaves(card))
    gh = torch.autograd.grad(_nll(yhost, yh), tree_leaves(host))
    names = [f"{n}/{k}" for n in sorted(host) for k in sorted(host[n])]
    for name, a, b in zip(names, gc, gh):
        atol = 1e-4 if name.startswith("conv") and "gamma" in name else 1e-5
        np.testing.assert_allclose(
            a.cpu().numpy(), b.numpy(), rtol=1e-4,
            atol=atol * max(float(b.abs().max()), 1e-30), err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("stride,padding", ((1, 1), (2, "SAME"),
                                            (1, "VALID")))
def test_engine_conv_on_card_tracks_fakequant(cuda_device, stride, padding):
    """cim_conv2d_apply(mode="engine") on the card: the planned tiles on
    cim_mbiw, within JAX's rtol 1e-4 / atol 1e-5 of fakequant, and equal
    to the host's engine run bit for bit (LeNet's conv2 geometry)."""
    from repro_torch.core import cim_layers as tcl
    cim = CIMConfig(r_in=4, r_w=2)
    p = tcl.init_cim_linear(prng.key(1), 9 * 16, 32, cfg=cim)
    x = torch.relu(prng.normal(prng.key(2), (16, 14, 14, 16)))
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    xc = x.to(cuda_device)
    kern = tkernel.cim_mbiw_matmul_planes
    before = kern.launches
    y = tcl.cim_conv2d_apply(pc, xc, cim.replace(mode="engine"),
                             stride=stride, padding=padding)
    torch.cuda.synchronize()
    assert kern.launches > before
    fq = tcl.cim_conv2d_apply(pc, xc, cim, stride=stride, padding=padding)
    assert y.shape == fq.shape
    assert torch.allclose(y, fq, rtol=1e-4, atol=1e-5)
    yh = tcl.cim_conv2d_apply(p, x, cim.replace(mode="engine"),
                              stride=stride, padding=padding)
    assert torch.equal(y.cpu(), yh)


@pytest.mark.gpu
def test_sim_layer_on_card_matches_host(cuda_device):
    """The voltage-domain sim mode on the card: its codes are the host's
    (integer dots, the same float chain), the dequantized output within
    rtol 1e-5 of the host's (the zero-point column sums' order), and
    under noise the draws run through threefry_normal."""
    from repro_torch.core import cim_layers as tcl
    cim = CIMConfig(mode="sim", r_in=4, r_w=2)
    p = tcl.init_cim_linear(prng.key(5), 300, 24, cfg=cim)
    x = prng.normal(prng.key(6), (32, 300))
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    for noise, key in ((NoiseConfig(enabled=False), None),
                       (NoiseConfig(), prng.key(7))):
        c = cim.replace(noise=noise)
        draw = pkernel.threefry_normal
        before = draw.launches
        y = tcl.cim_linear_apply(pc, x.to(cuda_device), c, key=key)
        torch.cuda.synchronize()
        assert (draw.launches > before) == noise.enabled
        yh = tcl.cim_linear_apply(p, x, c, key=key)
        np.testing.assert_allclose(y.cpu().numpy(), yh.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(yh.abs().max()))


# ---- the sharded multi-macro engine ----------------------------------------

def _sharded(devices, *, fold=True, noise=False):
    cfg = trt.EngineConfig(noise=NoiseConfig()) if noise \
        else trt.EngineConfig()
    return cfg.replace(sharding=trt.ShardingConfig(
        devices=devices, fold_onto="cuda" if fold else None))


@pytest.mark.gpu
@pytest.mark.parametrize("noise", (False, True), ids=("clean", "noisy"))
@pytest.mark.parametrize("devices", (1, 2, 4, 8))
def test_folded_sharded_lenet_on_card(cuda_device, devices, noise):
    """LeNet at (4, 2) with D partitions folded onto the card, both kinds
    forced on every layer: equal to the unsharded program, the card's
    reference and the host's sharded run, bit for bit."""
    cim = CIMConfig(r_in=4, r_w=2)
    specs, acts, pools = cnn.lenet_engine_specs(32, cim=cim)
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(3), cim=cim))
    x = torch.from_numpy(make_dataset(1, 32, seed=3)[2][..., None])
    key = prng.key(1) if noise else None
    base = trt.EngineConfig(noise=NoiseConfig()) if noise \
        else trt.EngineConfig()
    want = tprog.compile_program(specs, base, activations=acts, pools=pools,
                                 device=cuda_device).bind(params).serve(
        x, key)
    for kind in ("col", "rows"):
        sched = [(None, kind)] * len(specs)
        plan = trt.plan_network(specs, _sharded(devices, noise=noise), acts,
                                pools, schedule=sched)
        bound = tprog.program_for_plan(plan, device=cuda_device).bind(params)
        got = bound.serve(x, key)
        assert torch.equal(got, want)
        assert torch.equal(got, bound.reference(x, key))
        host = trt.plan_network(specs, base.replace(
            sharding=trt.ShardingConfig(devices=devices, fold_onto="cpu")),
            acts, pools, schedule=sched)
        assert torch.equal(got.cpu(), tprog.program_for_plan(
            host, device="cpu").bind(params).serve(x, key))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("col", "rows"))
def test_sharded_dispatch_is_one_graph(cuda_device, kind):
    """A clean folded sharded dispatch is captured as one CUDA graph: its
    replays equal the eager forward at every rung, the capture's
    cim_mbiw launches are the plan's sharded tile calls, and the weights
    are not copied per partition."""
    specs = [tmap.LayerSpec(m=8, k=1300, n=300, r_in=4, r_w=2),
             tmap.LayerSpec(m=8, k=300, n=10, r_in=4, r_w=2)]
    plan = trt.plan_network(specs, _sharded(4), schedule=[(None, kind)] * 2)
    prog = tprog.program_for_plan(plan, device=cuda_device)
    bound = prog.bind(prog.init_params(torch.Generator().manual_seed(4)))
    for b in bound._binds:
        assert all(p["wqq"].untyped_storage().data_ptr()
                   == b["wqq"].untyped_storage().data_ptr()
                   for p in b["parts"])
    x = torch.randn((20, 1300), generator=torch.Generator().manual_seed(5))
    st0 = bound.stats()
    for b in prog.buckets.ladder(20):
        rows = x[:min(b, 20)]
        first = bound.serve(rows)
        before = tkernel.cim_mbiw_matmul_planes.launches
        again = bound.serve(rows)
        torch.cuda.synchronize()
        assert tkernel.cim_mbiw_matmul_planes.launches - before == \
            len(plan.tile_calls(b))
        want = _eager(bound, rows)
        assert torch.equal(first, want) and torch.equal(again, want)
    st = bound.stats()
    rungs = len(prog.buckets.ladder(20))
    assert st["graphs_captured"] - st0["graphs_captured"] == rungs
    assert st["eager_calls"] == st0["eager_calls"]


@pytest.mark.gpu
def test_sharded_across_cards(cuda_device):
    """The default placement: partition i on card i, the outputs gathered
    on the program's card; such a dispatch runs eagerly.  Needs D cards."""
    devices = 2
    if torch.cuda.device_count() < devices:
        pytest.skip(f"placement across cards needs {devices} cards, this "
                    f"host has {torch.cuda.device_count()}")
    specs = [tmap.LayerSpec(m=8, k=1300, n=300, r_in=4, r_w=2)]
    p1 = tprog.compile_program(specs, device="cuda:0")
    params = p1.init_params(torch.Generator().manual_seed(4))
    x = torch.randn((8, 1300), generator=torch.Generator().manual_seed(5))
    want = p1.bind(params).serve(x)
    for kind in ("col", "rows"):
        plan = trt.plan_network(specs, _sharded(devices, fold=False),
                                schedule=[(None, kind)])
        prog = tprog.program_for_plan(plan, device="cuda:0")
        bound = prog.bind(params)
        assert {p["wqq"].device.index for p in bound._binds[0]["parts"]} \
            == {0, 1}
        eager0 = bound.stats()["eager_calls"]
        assert torch.equal(bound.serve(x), want)
        assert bound.stats()["eager_calls"] == eager0 + 1


@pytest.mark.gpu
def test_flash_attention_sharded_on_card(cuda_device):
    """flash_attention_sharded over a folded (data 2, model 4) mesh in
    bf16 through the tensor-core kernels: the forward equal to the
    unsharded kernel call (each query row meets the same key blocks in
    the same order), the float32 gradients within flash's 5e-5."""
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import use_mesh
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, s, h, d = 2, 1024, 4, 128
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for _ in range(4))
    mesh = make_mesh((2, 4), ("data", "model"), fold_onto="cuda")
    pieces = fops.sharded_pieces(mesh, b, s)
    o, lse = fops.sharded_forward(q, k, v, True, 0, pieces)
    zero = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o1, lse1 = rkernel.flash_fwd(qt, kt, vt, zero, causal=True)
    assert torch.equal(o, o1.transpose(1, 2)) and torch.equal(lse, lse1)
    dq, dk, dv = fops.sharded_backward(q, k, v, o, lse, do, True, 0, pieces)
    delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2) \
        .contiguous()
    args = (qt, kt, vt, dot, lse1, delta, zero)
    dq1 = rkernel.flash_bwd_dq(*args, causal=True)
    dk1, dv1 = rkernel.flash_bwd_dkv(*args, causal=True)
    for got, want in ((dq, dq1), (dk, dk1), (dv, dv1)):
        torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)
    qg = q.clone().requires_grad_()
    with use_mesh(mesh):
        out = fops.flash_attention_sharded(qg, k, v, True, 0)
    assert torch.equal(out, o)
    out.backward(do)
    assert torch.equal(qg.grad, dq.transpose(1, 2).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# cimcheck on the card: the SASS pass, verify=, the legacy entries
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", ("cim_mbiw", "cim_mbiw_tc",
                                  "cim_mbiw_splitk"))
def test_sass_pass_clean_on_cim_mbiw_routes(cuda_device, name):
    """Every route's ADC floor, as the card runs it, has no FFMA on its
    slice, and the pass found the floors it checked."""
    from repro_torch.analysis import sass
    rep = sass.lint_built([name])
    tot = rep.totals()
    assert tot["sinks"] > 0 and tot["ffma_on_slice"] == 0
    assert rep.findings == []


@pytest.mark.gpu
def test_sass_pass_reports_the_seeded_epilogue(cuda_device):
    """The contract's expression with plain operators, compiled with the
    kernels' flags, is fused by nvcc, and the pass reports it."""
    from repro_torch.analysis import sass
    path = sass.compile_source(sass.SEEDED_EPILOGUE, "cimcheck_seeded")
    rep = sass.lint_path(path)
    assert rep.totals()["ffma_on_slice"] >= 1
    assert {f.code for f in rep.findings} == {"NB102"}


@pytest.mark.gpu
def test_verify_strict_captures_and_binds_nothing(cuda_device):
    specs = [tmap.LayerSpec(m=8, k=144, n=40, r_in=4, r_w=2),
             tmap.LayerSpec(m=8, k=40, n=10, r_in=4, r_w=2)]
    tprog.clear_program_cache()
    before = (dict(trt.CAPTURE_COUNT), tprog.bound_cache_stats(),
              tkernel.launch_counts())
    prog = tprog.compile_program(specs, trt.EngineConfig(), verify="strict")
    assert prog.device.type == "cuda"
    assert (dict(trt.CAPTURE_COUNT), tprog.bound_cache_stats(),
            tkernel.launch_counts()) == before
    assert prog.stats()["graphs_captured"] == 0


@pytest.mark.gpu
def test_key_budget_graph_count_is_what_a_bound_program_captures(
        cuda_device):
    """RC001 counts the clean keys a bound program captures a graph for;
    serving every rung with and without segments captures exactly
    them."""
    from repro_torch.analysis import recompile
    buckets = tprog.BatchBuckets(max_bucket=8)
    prog = tprog.compile_program(
        [tmap.LayerSpec(m=8, k=64, n=16, r_in=4, r_w=2)], trt.EngineConfig(),
        buckets=buckets)
    keys = recompile.reachable_keys(buckets, 8, devices=1,
                                    noise_enabled=False)
    want = len(recompile.capturable_keys(keys))
    bound = prog.bind(prog.init_params(torch.Generator().manual_seed(0)))
    x = torch.randn((8, 64), device=cuda_device)
    n0 = trt.CAPTURE_COUNT["n"]
    for m in range(1, 9):
        bound.serve(x[:m])
        bound.serve(x[:m], segments=torch.zeros(m, dtype=torch.int64))
    assert trt.CAPTURE_COUNT["n"] - n0 == want == 2 * len(buckets.ladder(8))
    assert len(bound.executables) == want


@pytest.mark.gpu
@pytest.mark.parametrize("noisy", (False, True))
def test_legacy_entries_equal_program_run_on_card(cuda_device, noisy):
    """run_network, CIMInferenceEngine's call and reference, and
    program.run on a LeNet batch: bit-equal on the card, clean and noisy;
    monte_carlo's trials equal runs under the split keys."""
    import warnings
    from repro_torch.models.cnn import lenet_engine_specs
    cfg = trt.EngineConfig(noise=NoiseConfig(enabled=noisy))
    specs, acts, pools = lenet_engine_specs(16)
    eng = trt.CIMInferenceEngine(specs, cfg, acts, pools)
    params = eng.init_params(prng.key(0))
    x = torch.from_numpy(make_dataset(1, 16, seed=4)[2][..., None])
    key = prng.key(2) if noisy else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        y = eng(params, x, key)
        assert torch.equal(y, trt.run_network(eng.plan, params, x, key))
    assert y.is_cuda
    assert torch.equal(y, eng.program.run(params, x, key))
    assert torch.equal(y, eng.reference(params, x, key))
    assert torch.equal(y, trt.run_network_reference(eng.plan, params, x,
                                                     key))
    if noisy:
        mc = eng.monte_carlo(params, x, prng.key(5), 3)
        for t, k in enumerate(prng.split(prng.key(5), 3)):
            assert torch.equal(mc[t], eng.program.run(params, x, k))


# ---------------------------------------------------------------------------
# the moe and vlm decoder families (models/moe.py)
# ---------------------------------------------------------------------------

def _expert_bank(e, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((e, 8, k), generator=g),
            torch.randn((e, k, n), generator=g) * k ** -0.5,
            torch.rand((e, n), generator=g) * 6 - 1,
            torch.rand((e, n), generator=g) * 8 - 4)


@pytest.mark.gpu
@pytest.mark.parametrize("point", ((8, 4), (1, 2)))
@pytest.mark.parametrize("noisy", (False, True))
def test_expert_bank_on_card_equals_host(cuda_device, point, noisy):
    """An expert bank (E 4, capacity 8, fan-in 1300: two row tiles) in
    fakequant on the card == on the host bit for bit, and the engine on
    the card == that (clean), or its kernel path == reference=True and
    the same key repeats (noisy)."""
    from repro_torch.core.noise_model import NO_NOISE
    from repro_torch.models import moe
    x, w, lg, bt = _expert_bank(4, 1300, 48, point[0] * 3 + noisy)
    cim = CIMConfig(mode="fakequant", r_in=point[0], r_w=point[1],
                    noise=NoiseConfig() if noisy else NO_NOISE)
    key = prng.key(11) if noisy else None
    host = moe._expert_gemm(x, w, cim, (lg, bt), key=key)
    dx, dw, dlg, dbt = (t.to(cuda_device) for t in (x, w, lg, bt))
    card = moe._expert_gemm(dx, dw, cim, (dlg, dbt), key=key)
    assert torch.equal(card.cpu(), host)
    en = cim.replace(mode="engine")
    eng = moe._expert_gemm(dx, dw, en, (dlg, dbt), key=key)
    if noisy:
        assert torch.equal(eng, moe._expert_gemm(dx, dw, en, (dlg, dbt),
                                                 key=key, reference=True))
        assert torch.equal(eng, moe._expert_gemm(dx, dw, en, (dlg, dbt),
                                                 key=key))
    else:
        assert torch.equal(eng, card)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("phi35_moe", "internvl2_76b",
                                  "mamba2_1_3b", "recurrentgemma_2b"))
def test_family_smoke_serve_on_card_matches_host(cuda_device, arch):
    """The smoke config served on the card in engine mode (float32): no
    plan, capture or eager dispatch after warm-up, engine == fakequant
    bit for bit, and tokens equal to the host's serve of the same
    weights, each step's logits within 0.1 (as
    test_serve_card_matches_host).  recurrentgemma's quantized forward
    moves by about 5% card against host (an ulp of the float glue moves
    a tensor's activation swing, and the RG-LRU carries every code
    flip on), so its greedy tokens may part: there the host decodes the
    card's tokens, and each step's logits are held within 0.1."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cim_layers import CIMConfig as C
    from repro_torch.launch import serve
    base = get_smoke_config(arch).replace(dtype="float32")
    prompt = _serve_prompt(cuda_device) % base.vocab_size
    if base.family == "hybrid":
        # a prefill writes its tokens into the local-attention ring at
        # once, so it may not outgrow the window (JAX's neither)
        prompt = prompt[:, :base.local_window]
    plen = prompt.shape[1]
    out = {}
    for mode in ("engine", "fakequant"):
        cfg = base.replace(cim=C(mode=mode, max_gamma=2.0**16))
        params = _serve_params(cfg, cuda_device)
        prefix = (serve.make_prefix(cfg, 4, 0, cuda_device)
                  if cfg.family == "vlm" else None)
        max_len = serve.serve_max_len(cfg, plen, 4)
        out[mode] = serve.static_serve(cfg, params, prompt, 4,
                                       max_len=max_len, keep_logits=True,
                                       prefix=prefix)
    card = out["engine"]
    assert card["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0}
    assert torch.equal(card["tokens"], out["fakequant"]["tokens"])
    for a, b in zip(card["logits"], out["fakequant"]["logits"]):
        assert torch.equal(a, b)
    hcfg = cfg.replace(cim=cfg.cim.replace(mode="engine"))
    if base.family == "hybrid":
        from repro_torch.models import transformer as ttf
        hp, cache = _to_host(params), ttf.init_cache(hcfg, 4, max_len)
        host = {"logits": []}
        with torch.no_grad():
            for toks in [prompt.cpu()] + [card["tokens"][:, t:t + 1]
                                          for t in range(4)]:
                lg, cache, _ = ttf.forward(hcfg, hp, toks, cache=cache)
                host["logits"].append(lg[:, -1])
    else:
        host = serve.static_serve(
            hcfg, _to_host(params), prompt.cpu(), 4, max_len=max_len,
            keep_logits=True,
            prefix=None if prefix is None else prefix.cpu())
        assert torch.equal(card["tokens"], host["tokens"])
    for a, b in zip(card["logits"], host["logits"]):
        a, b = a.float().cpu(), b.float()
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) < 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("gamma_bits", (-1, 3))
def test_bind_on_card_equals_host_bind(cuda_device, gamma_bits):
    """Weights already on the card bind there; the products are the
    host's bind bit for bit (every weight code, scale and gamma)."""
    spec = tmap.LayerSpec(m=8, k=1300, n=200, r_in=8, r_w=4)
    cfg = trt.EngineConfig(gamma_bits=gamma_bits)
    plan = trt.plan_network([spec], cfg, ["none"])
    g = torch.Generator().manual_seed(gamma_bits + 5)
    host = {"w": torch.randn((1300, 200), generator=g),
            "abn_log_gamma": torch.rand((200,), generator=g) * 6 - 1,
            "abn_beta": torch.rand((200,), generator=g) * 8 - 4}
    card = {k: v.to(cuda_device) for k, v in host.items()}
    want = trt.bind_network(plan, [host], cuda_device)[0]
    got = trt.bind_network(plan, [card], cuda_device)[0]
    assert set(got) == set(want)
    for k in want:
        assert got[k].device == want[k].device and torch.equal(got[k],
                                                              want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("random", "ties", "zeros", "fault13"))
def test_compression_on_card_matches_host(cuda_device, kind):
    """compress_leaf on the card == on the host bit for bit (codes, scale,
    residual): no reciprocal for the divides, no FMA in the residual."""
    from repro_torch.optim import compression as gc
    rng = np.random.default_rng(7)
    for n in (1, 777, 1 << 20):
        if kind == "random":
            g = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6)
            e = rng.standard_normal(n) * np.abs(g).max() * 1e-2
        elif kind == "ties":
            g = (rng.integers(-126, 126, n) + 0.5) * 2.0 ** -7
            g[0] = 127 * 2.0 ** -7
            e = np.zeros(n)
        elif kind == "zeros":
            g = e = np.zeros(n)
        else:
            g, e = np.full(n, 0.13803421), np.zeros(n)
        g, e = (torch.from_numpy(a.astype(np.float32)) for a in (g, e))
        host = gc.compress_leaf(g, e)
        card = gc.compress_leaf(g.to(cuda_device), e.to(cuda_device))
        for a, b in zip(card, host):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(
                a.cpu(), b), (kind, n)


@pytest.mark.gpu
def test_checkpoint_of_card_tensors_restores_onto_the_card(cuda_device,
                                                           tmp_path):
    """An async save of card tensors copies them before it returns (the
    train step writes in place); a restore puts each leaf back on its
    template leaf's device and dtype."""
    from repro_torch.checkpoint import CheckpointManager
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tree = {"w": torch.randn((1024, 1024), generator=g, device=cuda_device,
                             requires_grad=True),
            "step": torch.full((), 7, dtype=torch.int32, device=cuda_device)}
    want = {k: v.detach().clone() for k, v in tree.items()}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(7, tree)
    with torch.no_grad():
        tree["w"].add_(1.0)
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 7
    for k in tree:
        assert restored[k].is_cuda and restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k].detach(), want[k]), k
    assert restored["w"].requires_grad and restored["w"].is_leaf
    host, _ = mgr.restore({k: v.cpu() for k, v in tree.items()})
    assert not host["w"].is_cuda and torch.equal(host["w"],
                                                 want["w"].cpu())


@pytest.mark.gpu
def test_launcher_fault_run_on_card_equals_clean_run(cuda_device,
                                                     tmp_path):
    """OLMo-1B's smoke config on the card, --compress-grads, noisy: the
    driver with faults before steps 3 and 5 ends bit-equal to the run
    without them."""
    from repro_torch import convert
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.fault_tolerance import make_fault_injector
    argv = ["--arch", "olmo-1b", "--smoke", "--steps", "6", "--seq-len",
            "64", "--batch", "2", "--cim-mode", "fakequant", "--attn-impl",
            "pallas", "--compress-grads", "--cim-noise", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    args = train.parser().parse_args(argv)
    _, state, step_fn, batch_fn = train.build(args)
    losses = []
    for s in range(args.steps):
        state, m = step_fn(state, batch_fn(s), train.step_key(args, s))
        losses.append(float(m["loss"]))
    _, init, step_fn, batch_fn = train.build(args)
    driver, run = train.make_driver(args, init, step_fn, batch_fn,
                                    make_fault_injector({3: 1, 5: 1}))
    final, hist = run()
    assert driver.restarts == 2
    assert [h.loss for h in hist] == [losses[h.step] for h in hist]
    a = tree_leaves(convert.train_state_to_numpy(final))
    b = tree_leaves(convert.train_state_to_numpy(state))
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert tree_leaves(final["params"])[0].is_cuda


@pytest.mark.gpu
def test_meta_routes_beside_the_card_routes(cuda_device):
    """Each kernel on CUDA tensors launches and counts; the same call on
    meta tensors launches nothing, counts nothing and records one op of
    its cost formula (kernels/costs.py)."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.flash_attn import kernel as fk
    q = torch.randn((1, 4, 64, 64), device=cuda_device).to(torch.bfloat16)
    off = fk.offset_tensor(0, cuda_device)
    n = fk.flash_fwd.launches
    o, _ = fk.flash_fwd(q, q, q, off, causal=True)
    assert fk.flash_fwd.launches == n + 1 and o.is_cuda
    seen = []
    costs.add_listener(lambda name, c: seen.append((name, c)))
    try:
        mq = q.to("meta")
        mo, _ = fk.flash_fwd(mq, mq, mq, fk.offset_tensor(0, "meta"),
                             causal=True)
        z = pkernel.threefry_normal(
            torch.empty((3, 2), dtype=torch.int64, device="meta"), 100)
        y = tkernel.cim_mbiw_matmul_planes(
            torch.empty((64, 144), dtype=torch.int8, device="meta"),
            torch.empty((144, 32), dtype=torch.int8, device="meta"),
            torch.empty((1, 32), device="meta"),
            torch.empty((1, 32), device="meta"), plane_shift=4, g0=1.0,
            r_out=8)
    finally:
        costs._LISTENERS.clear()
    assert fk.flash_fwd.launches == n + 1
    assert mo.device.type == z.device.type == y.device.type == "meta"
    assert [s[0] for s in seen] == ["flash_fwd", "threefry_normal",
                                    "cim_mbiw"]
    assert seen[0][1] == costs.flash("fwd", 1, 4, 4, 64, 64, 64, True, 0, 2)


@pytest.mark.gpu
def test_dryrun_argument_bytes_are_the_cards(cuda_device):
    """OLMo-1B's smoke config at a prefill of 2 x 64: the meta walk's
    argument_size_in_bytes == the summed nbytes of the params and inputs
    built on the card, and the step runs there."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch import dryrun, trace_analysis
    cfg = get_smoke_config("olmo_1b")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=2)
    walk = dryrun.analyze_cell(cfg, shape)
    fn, args = dryrun.build_cell(cfg, shape, cuda_device)
    held = trace_analysis.tree_tensors(args)
    assert all(t.is_cuda for t in held)
    assert walk["memory"]["argument_size_in_bytes"] == sum(
        t.numel() * t.element_size() for t in held)
    out = fn()
    assert out.is_cuda and tuple(out.shape) == (2, cfg.vocab_size)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2, 1)])
def test_folded_moe_split_on_card_matches_host(cuda_device, mesh_shape):
    """moe_block under a (data, model) mesh folded onto the card against
    the same split folded onto the host, fakequant float32: within 2e-5
    of the largest output, top_idx equal."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import moe as tm
    from repro_torch.models import sharding as tsh
    cim = CIMConfig(mode="fakequant", r_in=8, r_w=4)
    params = tm.init_moe(prng.key(5), 64, 96, 8)
    x = prng.normal(prng.key(6), (2, 16, 64))
    outs = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        with tsh.use_mesh(tmesh.make_mesh(mesh_shape, ("data", "model"),
                                          fold_onto=dev)):
            outs[str(dev)] = tm.moe_block(p, x.to(dev), n_experts=8,
                                          top_k=2, capacity_factor=1.25,
                                          cim=cim)[0].cpu()
    host, card = outs.values()
    assert torch.allclose(card, host, rtol=0,
                          atol=2e-5 * float(host.abs().max()))
    xf = x.reshape(-1, 64)
    assert torch.equal(tm.route(xf, params["router"], 8, 2)[2],
                       tm.route(xf.to(cuda_device),
                                params["router"].to(cuda_device), 8,
                                2)[2].cpu())
