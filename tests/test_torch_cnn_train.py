"""The port's CIM-aware training of the paper's own CNN and MLP against the
JAX package: `cim_conv2d_apply` in every mode, the 2x2 max-pool with
JAX's gradient, `init_mlp` / `mlp_forward` and `init_lenet` /
`lenet_forward` in bypass, fakequant and sim, three steps of
`examples/train_lenet_cim.py`'s train step, and chip_smoke.py's LeNet
recipe trained clean in both packages.

Tolerances:

- fakequant forwards (layer, LeNet, MLP) equal jitted JAX bit for bit,
  on pseudo-MNIST, whose discrete pixels make the activations tie-heavy
  (codes on rounding boundaries, equal values in a pool window);
- gradients within `_close_grad` (rtol 1e-4 plus 1e-5 of the tensor's
  largest, `tests/test_torch_fakequant.py`): the backward sums the
  straight-through products in another order.  The ABN gains of
  LeNet's two convs are sums over every output pixel of the batch (6272
  and 1568 rows at batch 8, against at most 15 in that file's layer), so
  they are held within rtol 1e-4 plus 1e-4 of the largest (3.1e-5
  read);
- bypass within rtol 1e-5 plus 1e-5 of the largest output, 1e-4 for the
  conv (JAX's `test_conv_via_im2col`): one float matmul a layer, summed
  in each library's order;
- engine conv within JAX's rtol 1e-4 / atol 1e-5 of fakequant
  (`tests/test_engine_conv.py`) and bit for bit with JAX's engine;
- the pool's gradient bit for bit: a tie sends it to the first of the
  window in row-major order, where XLA's select-and-scatter does;
- noisy fakequant forwards bit for bit with JAX's jitted run under one
  key, on these inputs (XLA may rewrite a noise chain, ROADMAP Queue 3
  reference fault 3; here no code moves); the MLP's sim within rtol
  1e-5 plus 1e-6 of the largest logit (`tests/test_torch_cim_macro.py`);
- the example's train step, three steps in fakequant under
  `NoiseConfig()` with per-step keys, JAX's jitted as the example runs
  it: step 0's loss within 1e-6 relative (the same forward, the loss
  reduction summed in another order), and after step s every parameter
  within 2 lr x s of JAX's, the mean difference below 2e-4: a gradient
  that differs within `_close_grad` moves AdamW's normalized update by
  up to 2 lr where the gradient is tiny against its running scale, and
  codes that sit on a boundary then move at the next step;
- the clean recipe, 32 steps at batch 256 in each package: test
  accuracy above 0.8 in both (chance is 0.1) and within 0.05 of each
  other (0.9189 and 0.9492 read): over 32 steps the trajectories part
  as above, so only the accuracy is compared.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_layers as jcl
from repro.core.noise_model import NoiseConfig as JNoise
from repro.models import cnn as jcnn
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import cim_layers as tcl
from repro_torch.core import prng
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.models import cnn as tcnn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCH = 8


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _close_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@functools.lru_cache(maxsize=None)
def _mnist(n, seed):
    """n pseudo-MNIST images (NHWC) and labels."""
    _, _, x, y = make_dataset(n_train=1, n_test=n, seed=seed)
    return x[..., None], y


def _port_params(jparams, grad=False):
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams))
    if grad:
        tp = tree_map(lambda v: v.requires_grad_(True), tp)
    return tp


# ---- cim_conv2d_apply -------------------------------------------------------

def _conv_case(seed, c_in=4, c_out=8, shape=(2, 9, 6)):
    cfg = jcl.CIMConfig(mode="fakequant", r_in=4, r_w=2)
    p = jcl.init_cim_linear(jax.random.PRNGKey(seed), 9 * c_in, c_out,
                            cfg=cfg)
    x = jax.nn.relu(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                      shape + (c_in,)))
    return p, x


GEOMETRIES = ((1, 1), (2, "SAME"), (1, "VALID"))


@pytest.mark.parametrize("stride,padding", GEOMETRIES)
def test_conv_bypass_and_fakequant_match_jax(stride, padding):
    p, x = _conv_case(0)
    gy = None
    for mode in ("bypass", "fakequant"):
        jc = jcl.CIMConfig(mode=mode, r_in=4, r_w=2)
        tc = tcl.CIMConfig(mode=mode, r_in=4, r_w=2)

        def jfn(p_, x_):
            return jcl.cim_conv2d_apply(p_, x_, jc, stride=stride,
                                        padding=padding)
        want = np.asarray(jax.jit(jfn)(p, x))
        if gy is None:
            gy = np.random.default_rng(1).standard_normal(want.shape) \
                .astype(np.float32)
        jgp, jgx = jax.jit(jax.grad(lambda p_, x_: jnp.sum(jfn(p_, x_) * gy),
                                    argnums=(0, 1)))(p, x)
        tp = {k: _t(v, True) for k, v in p.items()}
        tx = _t(x, True)
        got = tcl.cim_conv2d_apply(tp, tx, tc, stride=stride, padding=padding)
        assert got.shape == want.shape
        if mode == "bypass":
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(_bits(got.detach().numpy()),
                                          _bits(want))
        (got * _t(gy)).sum().backward()
        _close_grad(tx.grad.numpy(), jgx)
        _close_grad(tp["w"].grad.numpy(), jgp["w"])
        if mode == "fakequant":
            for k in ("abn_log_gamma", "abn_beta"):
                _close_grad(tp[k].grad.numpy(), jgp[k])


@pytest.mark.parametrize("stride,padding", GEOMETRIES)
def test_conv_engine_matches_fakequant_and_jax(stride, padding):
    """Engine mode plans the conv natively (no im2col detour in Python):
    within JAX's tolerance of fakequant, and bit for bit with JAX's engine
    (Pallas in interpret mode); isolate_rows serves each image as if
    alone."""
    p, x = _conv_case(0)
    cfg = tcl.CIMConfig(mode="fakequant", r_in=4, r_w=2)
    tp, tx = {k: _t(v) for k, v in p.items()}, _t(x)
    y_fq = tcl.cim_conv2d_apply(tp, tx, cfg, stride=stride, padding=padding)
    y_eng = tcl.cim_conv2d_apply(tp, tx, cfg.replace(mode="engine"),
                                 stride=stride, padding=padding)
    assert y_eng.shape == y_fq.shape
    np.testing.assert_allclose(y_eng.numpy(), y_fq.numpy(), rtol=1e-4,
                               atol=1e-5)
    want = np.asarray(jcl.cim_conv2d_apply(
        p, x, jcl.CIMConfig(mode="engine", r_in=4, r_w=2), stride=stride,
        padding=padding))
    np.testing.assert_array_equal(_bits(y_eng.numpy()), _bits(want))
    iso = cfg.replace(mode="engine", isolate_rows=True)
    y_iso = tcl.cim_conv2d_apply(tp, tx, iso, stride=stride, padding=padding)
    for i in range(tx.shape[0]):
        solo = tcl.cim_conv2d_apply(tp, tx[i:i + 1], iso, stride=stride,
                                    padding=padding)
        assert torch.equal(y_iso[i:i + 1], solo)


def test_conv_engine_noise_needs_a_key():
    """As JAX's test_engine_conv_noise_mode: a key is required, a fixed
    key repeats, the clean run differs."""
    p, x = _conv_case(0, shape=(2, 6, 6))
    cfg = tcl.CIMConfig(mode="engine", noise=NoiseConfig())
    tp, tx = {k: _t(v) for k, v in p.items()}, _t(x)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        tcl.cim_conv2d_apply(tp, tx, cfg)
    y = tcl.cim_conv2d_apply(tp, tx, cfg, key=prng.key(2))
    assert torch.equal(y, tcl.cim_conv2d_apply(tp, tx, cfg, key=prng.key(2)))
    clean = tcl.cim_conv2d_apply(tp, tx, cfg.replace(
        noise=NoiseConfig(enabled=False)))
    assert y.shape == clean.shape == (2, 6, 6, 8)
    assert not torch.equal(y, clean)


# ---- the pool ---------------------------------------------------------------

def _jax_pool(h):
    return jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "VALID")


@pytest.mark.parametrize("kind", ("codes", "constant", "random", "odd"))
def test_max_pool_forward_and_tie_gradient_match_jax(kind):
    rng = np.random.default_rng(5)
    shape = (3, 7, 9, 4) if kind == "odd" else (3, 8, 8, 4)
    if kind == "codes":        # few levels: most windows tie
        h = rng.integers(0, 3, size=shape).astype(np.float32)
    elif kind == "constant":   # every window a four-way tie
        h = np.ones(shape, np.float32)
    else:
        h = rng.standard_normal(shape).astype(np.float32)
        h[0, :2, :2, 0] = 2.0  # one tie among random values
    gy = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2,
                              shape[3])).astype(np.float32)
    for f in (_jax_pool, jax.jit(_jax_pool)):
        want = np.asarray(f(jnp.asarray(h)))
        jg = np.asarray(jax.jit(jax.grad(
            lambda a: jnp.sum(_jax_pool(a) * gy)))(jnp.asarray(h)))
        th = _t(h, True)
        got = tcnn.max_pool_2x2(th)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        (got * _t(gy)).sum().backward()
        np.testing.assert_array_equal(th.grad.numpy(), jg)


# ---- the models -------------------------------------------------------------

def test_inits_from_a_key_equal_jax_and_convert():
    """init_lenet / init_mlp from a `core/prng` key draw JAX's weights bit
    for bit; `params_from_numpy` carries both name-keyed trees across."""
    cim = jcl.CIMConfig(r_in=4, r_w=2)
    for jinit, tinit, kw in (
            (jcnn.init_lenet, tcnn.init_lenet, {}),
            (jcnn.init_mlp, tcnn.init_mlp, dict(dims=(784, 64, 10)))):
        want = jinit(jax.random.PRNGKey(3), cim=cim, **kw)
        got = tinit(prng.key(3), cim=tcl.CIMConfig(r_in=4, r_w=2), **kw)
        assert set(got) == set(want)
        conv = params_from_numpy(jax.tree.map(np.asarray, want))
        for name in want:
            for k in want[name]:
                np.testing.assert_array_equal(
                    _bits(got[name][k].numpy()), _bits(want[name][k]))
                assert torch.equal(conv[name][k], got[name][k])
    g = tcnn.init_mlp(torch.Generator().manual_seed(0), dims=(8, 4, 2))
    assert [tuple(g[k]["w"].shape) for k in ("fc0", "fc1")] == [(8, 4), (4, 2)]


def _model_case(model, r_in, r_w):
    x, y = _mnist(BATCH, 11)
    jc = jcl.CIMConfig(r_in=r_in, r_w=r_w)
    if model == "lenet":
        jp = jcnn.init_lenet(jax.random.PRNGKey(r_in), cim=jc)
        return jp, x, y, jcnn.lenet_forward, tcnn.lenet_forward
    jp = jcnn.init_mlp(jax.random.PRNGKey(r_in), dims=(784, 128, 64, 10),
                       cim=jc)
    return jp, x.reshape(BATCH, 784), y, jcnn.mlp_forward, tcnn.mlp_forward


@pytest.mark.parametrize("model,mode,r_in,r_w", [
    ("lenet", "fakequant", 4, 2), ("lenet", "fakequant", 8, 4),
    ("lenet", "bypass", 8, 4), ("mlp", "fakequant", 4, 2),
    ("mlp", "fakequant", 8, 4), ("mlp", "bypass", 8, 4)])
def test_model_forward_and_grads_match_jax(model, mode, r_in, r_w):
    jp, x, _, jfwd, tfwd = _model_case(model, r_in, r_w)
    jc = jcl.CIMConfig(mode=mode, r_in=r_in, r_w=r_w)
    tc = tcl.CIMConfig(mode=mode, r_in=r_in, r_w=r_w)
    want = np.asarray(jax.jit(lambda p_, x_: jfwd(p_, x_, jc))(jp, x))
    gy = np.random.default_rng(2).standard_normal(want.shape) \
        .astype(np.float32)
    jg = jax.jit(jax.grad(lambda p_, x_: jnp.sum(jfwd(p_, x_, jc) * gy)))(
        jp, x)
    tp = _port_params(jp, grad=True)
    got = tfwd(tp, _t(x), tc)
    assert got.shape == want.shape == (BATCH, 10)
    if mode == "bypass":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    else:
        np.testing.assert_array_equal(_bits(got.detach().numpy()),
                                      _bits(want))
    (got * _t(gy)).sum().backward()
    for name in jp:
        for k in jp[name]:
            g = tp[name][k].grad
            if g is None:                   # bypass: the ABN is unused
                assert mode == "bypass" and k != "w"
                assert float(np.abs(jg[name][k]).max()) == 0.0
                continue
            if name.startswith("conv") and k == "abn_log_gamma":
                want = np.asarray(jg[name][k])
                np.testing.assert_allclose(
                    g.numpy(), want, rtol=1e-4,
                    atol=1e-4 * float(np.abs(want).max()))
            else:
                _close_grad(g.numpy(), jg[name][k])


@pytest.mark.parametrize("model", ("lenet", "mlp"))
def test_noisy_and_sim_forwards_match_jax(model):
    """Fakequant under NoiseConfig() and one key: JAX's jitted forward bit
    for bit on these inputs (the key splits once a layer, as JAX's nk());
    the same key repeats, another and none differ.  Sim mode (clean):
    the MLP within tolerance of JAX's jitted sim (LeNet's sim layers are
    the same `cim_linear_apply` over its im2col patches; JAX's sim
    takes seconds a layer), LeNet's finite and mostly agreeing in top-1
    with its fakequant."""
    jp, x, _, jfwd, tfwd = _model_case(model, 4, 2)
    x = x[:4]
    tp = _port_params(jp)
    jc = jcl.CIMConfig(r_in=4, r_w=2, noise=JNoise())
    tc = tcl.CIMConfig(r_in=4, r_w=2, noise=NoiseConfig())
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda p_, x_, k_: jfwd(p_, x_, jc, key=k_))(
        jp, jnp.asarray(x), key))
    got = tfwd(tp, _t(x), tc, key=key_from_numpy(np.asarray(key)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(got, tfwd(tp, _t(x), tc, key=prng.key(9)))
    assert not torch.equal(got, tfwd(tp, _t(x), tc, key=prng.key(10)))
    assert not torch.equal(got, tfwd(tp, _t(x), tc))
    sim = tcl.CIMConfig(mode="sim", r_in=4, r_w=2)
    got = tfwd(tp, _t(x), sim)
    if model == "mlp":
        want = np.asarray(jax.jit(lambda p_, x_: jfwd(p_, x_, jcl.CIMConfig(
            mode="sim", r_in=4, r_w=2)))(jp, jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))
    else:
        fq = tfwd(tp, _t(x), sim.replace(mode="fakequant"))
        assert got.shape == fq.shape and bool(torch.isfinite(got).all())
        assert float((got.argmax(-1) == fq.argmax(-1)).float().mean()) \
            >= 0.5


def test_lenet_engine_mode_tracks_fakequant():
    """The trained-model hand-off: lenet_forward in engine mode (one
    program, the cim_mbiw kernels' plain versions here) against the
    port's fakequant: equal top-1 and within 5% mean relative at the
    paper's (4, 2) point, as JAX's test_lenet_engine_tracks_fakequant."""
    jp, x, _, _, _ = _model_case("lenet", 4, 2)
    tp = _port_params(jp)
    cim = tcl.CIMConfig(r_in=4, r_w=2)
    y_fq = tcnn.lenet_forward(tp, _t(x), cim)
    y_eng = tcnn.lenet_forward(tp, _t(x), cim.replace(mode="engine"),
                               device="cpu")
    rel = float((y_eng - y_fq).abs().mean() / (y_fq.abs().mean() + 1e-9))
    assert rel <= 0.05, rel
    assert torch.equal(y_eng.argmax(-1), y_fq.argmax(-1))


# ---- the example's train step -----------------------------------------------

def _jax_step(params, opt, xb, yb, key, cim, ocfg):
    def loss(p):
        logits = jcnn.lenet_forward(p, xb, cim, key=key)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, yb[:, None], 1))
    l, g = jax.value_and_grad(loss)(params)
    params, opt, _ = jax_adamw_update(params, g, opt, ocfg)
    return params, opt, l


def train_step(params, opt, xb, yb, key, cim, ocfg):
    """`examples/train_lenet_cim.py`'s step in the port: the mean NLL of
    the log-softmax, autograd, AdamW in place."""
    logits = tcnn.lenet_forward(params, xb, cim, key=key)
    lp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(lp, 1, yb[:, None].long()))
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    adamw_update(params, list(grads), opt, ocfg)
    return loss.detach()


def test_example_train_step_matches_jax():
    x, y = _mnist(BATCH, 12)
    jc = jcl.CIMConfig(mode="fakequant", noise=JNoise(), r_in=4, r_w=2)
    tc = tcl.CIMConfig(mode="fakequant", noise=NoiseConfig(), r_in=4, r_w=2)
    jp = jcnn.init_lenet(jax.random.PRNGKey(0), cim=jc)
    tp = _port_params(jp, grad=True)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    lr = 1e-3
    jocfg = JaxAdamW(lr=lr, weight_decay=0.0)
    tocfg = AdamWConfig(lr=lr, weight_decay=0.0)
    key = jax.random.PRNGKey(1)
    tkey = prng.key(1)
    # jitted, as the example runs it
    jstep = jax.jit(functools.partial(_jax_step, cim=jc, ocfg=jocfg))
    losses = []
    for s in range(3):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        assert np.array_equal(np.asarray(sub), tsub.numpy())
        jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y), sub)
        tl = train_step(tp, to, _t(x), _t(y), tsub, tc, tocfg)
        losses.append((float(jl), float(tl)))
        for name in jp:
            for k in jp[name]:
                d = np.abs(tp[name][k].detach().numpy()
                           - np.asarray(jp[name][k]))
                assert d.max() <= 2 * lr * (s + 1), (s, name, k, d.max())
                assert d.mean() <= 2e-4, (s, name, k, d.mean())
    j0, t0 = losses[0]
    assert abs(j0 - t0) <= 1e-6 * abs(j0), losses
    assert all(np.isfinite(t) for _, t in losses)
    assert int(to["step"]) == 3


def test_clean_recipe_learns_in_both_packages():
    """chip_smoke.py's LeNet recipe without the noise model, in both
    packages: (4, 2) fakequant, pseudo-MNIST 4096 / 1024, batch 256,
    AdamW lr 1e-3, 2 epochs (32 steps), JAX's weights from key 0.  Each
    learns (test accuracy above 0.8, chance 0.1) and the two land within
    0.05 of each other (the trajectories part where gradients differ
    within `_close_grad`).  Under `NoiseConfig()` the same recipe's
    step-0 logits sit in the hundreds (loss 779.8 on the card, the
    forward bit for bit with JAX's) and 32 steps leave it at chance."""
    xtr, ytr, xte, yte = make_dataset(n_train=4096, n_test=1024)
    jc = jcl.CIMConfig(mode="fakequant", r_in=4, r_w=2)
    tc = tcl.CIMConfig(mode="fakequant", r_in=4, r_w=2)
    jp = jcnn.init_lenet(jax.random.PRNGKey(0), cim=jc)
    tp = _port_params(jp, grad=True)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    jocfg = JaxAdamW(lr=1e-3, weight_decay=0.0)
    tocfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
    jstep = jax.jit(functools.partial(_jax_step, key=None, cim=jc,
                                      ocfg=jocfg))
    xj, yj = jnp.asarray(xtr)[..., None], jnp.asarray(ytr)
    xt, yt = _t(xtr)[..., None], _t(ytr)
    for _ in range(2):
        for i in range(0, 4096, 256):
            jp, jo, _ = jstep(jp, jo, xj[i:i + 256], yj[i:i + 256])
            train_step(tp, to, xt[i:i + 256], yt[i:i + 256], None, tc,
                       tocfg)
    jfwd = jax.jit(functools.partial(jcnn.lenet_forward, cim=jc))
    acc_j = float(jnp.mean(jnp.argmax(jfwd(
        jp, jnp.asarray(xte)[..., None]), -1) == jnp.asarray(yte)))
    with torch.no_grad():
        logits = tcnn.lenet_forward(tp, _t(xte)[..., None], tc)
    acc_t = float((logits.argmax(-1) == _t(yte)).float().mean())
    print(f"clean recipe, 32 steps: test accuracy JAX {acc_j:.4f}, port "
          f"{acc_t:.4f}")
    assert acc_j > 0.8 and acc_t > 0.8, (acc_j, acc_t)
    assert abs(acc_j - acc_t) <= 0.05, (acc_j, acc_t)
