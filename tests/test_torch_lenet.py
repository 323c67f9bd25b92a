"""The slice as a whole: LeNet served by the port equals LeNet served by
the JAX package, bit for bit.

JAX:  lenet_program(b).bind(lenet_params_list(p)).serve(x)   (interpret)
Port: the same calls, with params_from_numpy(p) and device="cpu".

Pseudo-MNIST is the sensitive input: its discrete pixels make the
intermediate activations tie-heavy, so a one-ulp difference anywhere in
the float chain moves codes at exact rounding boundaries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_layers as jcl
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.kernels.cim_mbiw import ops as tops
from repro_torch.models import cnn as tcnn

BATCH = 3


def _images(kind, seed):
    if kind == "mnist":
        return make_dataset(n_train=1, n_test=BATCH, seed=seed)[2][..., None]
    rng = np.random.default_rng(seed)
    return np.maximum(rng.normal(size=(BATCH, 28, 28, 1)), 0).astype(
        np.float32)


@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4), (2, 1), (1, 1)])
def test_lenet_logits_match_jax(r_in, r_w):
    seed = r_in * 10 + r_w
    jparams = jcnn.init_lenet(jax.random.PRNGKey(seed),
                              cim=jcl.CIMConfig(r_in=r_in, r_w=r_w))
    plist = jcnn.lenet_params_list(jparams)
    jbound = jcnn.lenet_program(
        BATCH, cim=jcl.CIMConfig(r_in=r_in, r_w=r_w)).bind(plist)
    np_params = {name: {k: np.asarray(v) for k, v in p.items()}
                 for name, p in jparams.items()}
    cim = CIMConfig(r_in=r_in, r_w=r_w)
    tparams = params_from_numpy(np_params)
    tbound = tcnn.lenet_program(BATCH, cim=cim, device="cpu").bind(
        tcnn.lenet_params_list(tparams))
    for kind in ("gauss", "mnist"):
        x = _images(kind, seed)
        want = np.asarray(jbound.serve(jnp.asarray(x)))
        got = tbound.serve(torch.from_numpy(x))
        assert tuple(got.shape) == (BATCH, 10)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        # the per-call entry point binds on every call and agrees too
        fwd = tcnn.lenet_forward(tparams, torch.from_numpy(x),
                                 cim.replace(mode="engine"), device="cpu")
        assert torch.equal(fwd, got)


def test_lenet_schedule_pinned(monkeypatch):
    """conv1 1 + conv2 1 + fc1 2x2 (K=1568 -> two row tiles, 128 channels
    -> two col tiles at r_w=4) + fc2 1 = 7 macro tiles per forward; at
    r_w=2 fc1's 128 channels fit one col tile (5).  The kernel runs once
    a row tile over every col tile: 5 calls at either r_w."""
    calls = []
    real = tops.cim_mbiw_matmul_planes

    def counting(*args, **kw):
        calls.append(tuple(args[0].shape) + (args[1].shape[1],))
        return real(*args, **kw)
    monkeypatch.setattr(tops, "cim_mbiw_matmul_planes", counting)
    x = torch.from_numpy(_images("mnist", 0))
    gen = torch.Generator().manual_seed(0)
    for r_w, evals in ((4, [1, 1, 4, 1]), (2, [1, 1, 2, 1])):
        cim = CIMConfig(r_in=8, r_w=r_w)
        prog = tcnn.lenet_program(BATCH, cim=cim, device="cpu")
        assert [lp.macro_evals for lp in prog.plan.layers] == evals
        bound = prog.bind(tcnn.lenet_params_list(tcnn.init_lenet(gen,
                                                                 cim=cim)))
        calls.clear()
        bound.serve(x)
        assert sum(evals) == prog.plan.total_macro_evals
        assert len(calls) == len(prog.plan.tile_calls(BATCH)) == 5
    # r_w=2, r_in=8, batch 3 padded to the bucket of 4:
    # (GEMM rows, planes*K, N) per tile
    assert calls == [(4 * 784, 18, 16), (4 * 196, 288, 32),
                     (4, 1568, 128), (4, 1568, 128), (4, 256, 10)]


def test_lenet_forward_other_modes_not_ported():
    """The other layer modes are ported (tests/test_torch_cnn_train.py
    holds them against JAX); an unknown one raises."""
    params = tcnn.init_lenet(torch.Generator().manual_seed(1))
    y = tcnn.lenet_forward(params, torch.zeros(1, 28, 28, 1), CIMConfig(),
                           device="cpu")
    assert y.shape == (1, 10)
    with pytest.raises(ValueError, match="unknown CIM mode"):
        tcnn.lenet_forward(params, torch.zeros(1, 28, 28, 1),
                           CIMConfig(mode="nope"))
