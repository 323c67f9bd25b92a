"""The port on the card: the CUDA cim_mbiw and ring_decode kernels against
their plain versions, LeNet on the card against the host run, and fused
in-flight decode at full OLMo-1B width against solo decode.

These tests need an NVIDIA GPU (marker `gpu`) and skip without one.  They
import neither JAX nor the JAX package, so they run where only PyTorch
is installed:  python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import digital_ref
from repro_torch.core import mapping as tmap
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.hw import DEFAULT_MACRO
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.kernels.cim_mbiw import kernel as tkernel
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.kernels.cim_mbiw import ref as tref
from repro_torch.kernels.flash_attn import kernel as rkernel
from repro_torch.kernels.flash_attn import ref as rref
from repro_torch.models import cnn
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
    got = tops.cim_matmul(*(torch.from_numpy(c[k]).to(cuda_device)
                            for k in ("x", "w", "gamma", "beta")),
                          r_in=8, r_out=c["r_out"], g0=c["g0"])
    np.testing.assert_array_equal(got.cpu().numpy(), c["codes"])


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


def _ring_inputs(r, l, h, hd, seed, device):
    """q, k/v as block 1 of a (R, 2, L, H, hd) state slab (strided views,
    as the scheduler passes them), and a bias with 1..L valid slots."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((r, h, hd), generator=g)
    slab_k = torch.randn((r, 2, l, h, hd), generator=g)
    slab_v = torch.randn((r, 2, l, h, hd), generator=g)
    valid = torch.randint(1, l + 1, (r,), generator=g)
    bias = torch.where(torch.arange(l)[None, :] < valid[:, None], 0.0, -1e9)
    q, slab_k, slab_v, bias = (t.to(device) for t in (q, slab_k, slab_v,
                                                      bias))
    return q, slab_k[:, 1], slab_v[:, 1], bias


@pytest.mark.gpu
@pytest.mark.parametrize("l", (1, 37, 2048))
@pytest.mark.parametrize("hd", (12, 128))
@pytest.mark.parametrize("h", (1, 16))
@pytest.mark.parametrize("r", (1, 3, 4, 8))
def test_ring_decode_kernel_matches_plain(cuda_device, r, h, hd, l):
    """Within rtol = atol = 1e-5 of the plain version (the sums run in
    another order), and each row bit for bit equal to a one-row call."""
    q, k, v, bias = _ring_inputs(r, l, h, hd, r * 1000 + l + hd,
                                 cuda_device)
    before = rkernel.ring_decode.launches
    got = rkernel.ring_decode(q, k, v, bias)
    torch.cuda.synchronize()
    assert rkernel.ring_decode.launches == before + 1
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
    kern.launches = rkernel.ring_decode.launches = 0
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
    assert rkernel.ring_decode.launches == 2 * sum(calls.values())
    for _, r in reqs:
        assert out[r.uid] == decode_sequential(model, r)
        assert len(out[r.uid]) == r.max_new_tokens
