"""The precision grid of the cim_mbiw kernel: the port's precision variants
(plain version on the CPU) against the JAX Pallas variants (interpret
mode) and the per-precision serial oracle, bit for bit, over r_in 1-8 x
r_w 1-4, with r_out, the beta shape and the fuse_adc mode cycling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_mbiw import ops as jops
from repro.kernels.cim_mbiw import ref as jref
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.kernels.cim_mbiw import ref as tref

from test_torch_cim_mbiw import layer_g0, make_case

GRID = [(r_in, r_w) for r_in in range(1, 9) for r_w in range(1, 5)]
M, K, N = 24, 200, 20


@pytest.mark.parametrize("r_in,r_w", GRID)
def test_precision_variant_matches_jax(r_in, r_w):
    i = GRID.index((r_in, r_w))
    r_out = (1, 4, 8)[i % 3]
    beta_rows = i % 2 == 1
    fuse_adc = i % 4 != 3
    x, w, gamma, beta = make_case(M, K, N, r_in, r_w, 1000 + i, beta_rows)
    g0 = layer_g0(K, r_in, r_w, r_out)
    jv = jops.kernel_variant(jops.KernelPrecision(r_in, r_w, r_out),
                             bm=32, bn=32, bk=128, interpret=True,
                             fuse_adc=fuse_adc)
    tv = tops.kernel_variant(tops.KernelPrecision(r_in, r_w, r_out),
                             bm=32, bn=32, bk=128, fuse_adc=fuse_adc)
    assert (tv.plane_shift, tv.n_planes) == (jv.plane_shift, jv.n_planes)
    jargs = [jnp.asarray(a) for a in (x, w, gamma, beta)]
    targs = [torch.from_numpy(a) for a in (x, w, gamma, beta)]
    got = tv(*targs, g0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jv(*jargs, g0)))
    if fuse_adc:
        kw = dict(r_in=r_in, r_w=r_w, r_out=r_out, g0=g0)
        want = np.asarray(jref.cim_matmul_ref_serial(*jargs, **kw))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tref.cim_matmul_ref_serial(*targs, **kw).numpy(), want)
    else:
        np.testing.assert_array_equal(got, x.astype(np.int64) @ w)
