"""The port on the card: the CUDA cim_mbiw kernel against its plain
version, and LeNet on the card against the host run.

These tests need an NVIDIA GPU (marker `gpu`) and skip without one.  They
import neither JAX nor the JAX package, so they run where only PyTorch
is installed:  python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import digital_ref
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.hw import DEFAULT_MACRO
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.kernels.cim_mbiw import kernel as tkernel
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.kernels.cim_mbiw import ref as tref
from repro_torch.models import cnn

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
