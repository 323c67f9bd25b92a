"""The port's training path against the JAX package's: OLMo-1B's smoke
config (2 layers, d 64, 4 heads, vocab 512) with the flash attention
(attn_impl "pallas": Pallas in interpret mode on the JAX side, the
kernels' plain versions in the port), in float32 and bfloat16, bypass and
fakequant, the same weights carried across with
`convert.train_params_from_numpy` and the same SyntheticLM batches.

What is compared, and the tolerances (relative unless stated):

- the loss and grad norm of each of 3 `make_train_step` steps;
- every leaf's gradient at the initial weights, as the norm of the
  difference over the norm of JAX's gradient;
- every parameter after the 3 steps, as the largest and the mean
  absolute difference.

The two packages round the digital ops between projections differently
(XLA fuses the norm, RoPE and softmax reductions; PyTorch runs them op by
op), by an ulp here and there: in bfloat16 the norm, RoPE and SiLU agree
bit for bit, and the attention output and the bypass products on about 1
element in 2,500.  In bypass float32 that stays an ulp; in bfloat16 an
ulp is 2^-8.  In fakequant an ulp that crosses a rounding
boundary moves an activation code by one, so a few codes of every layer
differ, and the ABN gradients (which are the quantization residuals of
the codes) follow those codes closely.  After a step AdamW's normalized
update turns every gradient difference into a parameter difference of up
to 2 lr.  The tolerances below are those measured effects with margin;
`tests/test_torch_fakequant.py` holds one layer bit for bit.

The ABN gradients are held leaf by leaf in float32 (at most 0.12 read
against 0.3).  In bfloat16 a leaf whose residuals nearly cancel (w_down's
gains, a norm 30x below the others) reads as noise against JAX, so there
each kind (all gains, all offsets) is held as one vector, at 0.3 (0.15
read): a zero or sign-flipped ABN gradient reads 1 or 2 and fails.  The
bfloat16 ABN gradients of a layer whose codes agree with JAX are held
tightly by `tests/test_torch_fakequant.py`.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.cim_layers import CIMConfig as JaxCIM
from repro.data.lm_data import LMDataConfig as JaxDataConfig
from repro.data.lm_data import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jsteps
from repro.optim import AdamWConfig as JaxAdamW
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.kernels.flash_attn import kernel as fkernel
from repro_torch.launch import steps, train
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3
STEPS = 3
SEQ, BATCH = 32, 4

# (mode, dtype) -> tolerances: loss and grad norm (rel), per-leaf grad
# rel norm error for weights (w, embed) and for ABN leaves (None: held
# per kind instead, `abn_kind`), params max / mean abs
TOLS = {
    ("bypass", "float32"): dict(loss=1e-5, gnorm=1e-5, w=1e-4,
                                p_max=1e-4, p_mean=1e-6),
    ("bypass", "bfloat16"): dict(loss=1e-3, gnorm=2e-3, w=5e-2,
                                 p_max=2 * LR * STEPS, p_mean=5e-5),
    ("fakequant", "float32"): dict(loss=5e-3, gnorm=2e-2, w=5e-2, abn=0.3,
                                   p_max=2 * LR * STEPS, p_mean=1e-4),
    ("fakequant", "bfloat16"): dict(loss=5e-3, gnorm=3e-2, w=0.25, abn=None,
                                    abn_kind=0.3, p_max=2 * LR * STEPS,
                                    p_mean=2e-4),
}


def _leaf_names(tree, pre=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                              f"{pre}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{pre}/{i}")]
    return [pre]


def _batches():
    data = SyntheticLM(LMDataConfig(vocab_size=512, seq_len=SEQ,
                                    global_batch=BATCH))
    return [data.batch_at(s) for s in range(STEPS)]


def _configs(mode, dtype):
    jcfg = jax_smoke("olmo_1b").replace(
        cim=JaxCIM(mode=mode, max_gamma=2.0**16), attn_impl="pallas",
        dtype=dtype)
    tcfg = get_smoke_config("olmo_1b").replace(
        cim=CIMConfig(mode=mode, max_gamma=2.0**16), attn_impl="pallas",
        dtype=dtype)
    return jcfg, tcfg


def _torch_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}


@functools.lru_cache(maxsize=None)
def _runs(mode, dtype):
    """Both packages from the same initial weights: step-0 gradients and
    3 train steps."""
    jcfg, tcfg = _configs(mode, dtype)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    np_init = jax.tree.map(np.array, jstate["params"])
    tstate = steps.train_state(convert.train_params_from_numpy(np_init))
    batches = _batches()
    jbatch0 = {"tokens": jnp.asarray(batches[0][0]),
               "labels": jnp.asarray(batches[0][1])}
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jsteps.loss_fn, jcfg), has_aux=True))(
        jstate["params"], jbatch0)
    tloss, _ = steps.loss_fn(tcfg, tstate["params"],
                             _torch_batch(*batches[0]))
    tgrads = torch.autograd.grad(tloss, tree_leaves(tstate["params"]),
                                 allow_unused=True)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JaxAdamW(lr=LR),
                                           total_steps=10, warmup=2))
    tstep = steps.make_train_step(tcfg, AdamWConfig(lr=LR), total_steps=10,
                                  warmup=2)
    metrics = []
    for toks, labels in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
        tstate, tm = tstep(tstate, _torch_batch(toks, labels))
        metrics.append({k: (float(jm[k]), float(tm[k]))
                        for k in ("loss", "grad_norm", "lr")})
    jparams = convert.train_params_from_numpy(
        jax.tree.map(np.array, jstate["params"]))
    jg = tree_leaves(convert.train_params_from_numpy(
        jax.tree.map(np.array, jgrads)))
    return {"names": _leaf_names(tstate["params"]), "metrics": metrics,
            "jgrads": jg,
            "tgrads": [torch.zeros_like(a) if b is None else b.detach()
                       for a, b in zip(jg, tgrads)],
            "jparams": tree_leaves(jparams),
            "tparams": [p.detach() for p in tree_leaves(tstate["params"])]}


CASES = sorted(TOLS)


def test_synthetic_lm_batches_equal():
    """The port's copy of the data pipeline gives JAX's batches."""
    cfg = dict(vocab_size=50304, seq_len=64, global_batch=3)
    port, ref = SyntheticLM(LMDataConfig(**cfg)), JaxSyntheticLM(
        JaxDataConfig(**cfg))
    for step in (0, 1, 7):
        for shard in (0, 1):
            for a, b in zip(port.batch_at(step, shard, 3),
                            ref.batch_at(step, shard, 3)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,dtype", CASES)
def test_train_step_losses_match_jax(mode, dtype):
    tols = TOLS[(mode, dtype)]
    for m in _runs(mode, dtype)["metrics"]:
        for key, tol in (("loss", tols["loss"]),
                         ("grad_norm", tols["gnorm"])):
            j, t = m[key]
            assert abs(j - t) <= tol * abs(j), (key, j, t)
        assert m["lr"][0] == m["lr"][1]


@pytest.mark.parametrize("mode,dtype", CASES)
def test_train_step_grads_match_jax(mode, dtype):
    tols = TOLS[(mode, dtype)]
    run = _runs(mode, dtype)
    bad = []

    def hold(name, j, t, tol):
        norm = float(j.norm())
        err = float((j - t).norm()) / max(norm, 1e-30)
        if err > tol:
            bad.append((name, err, norm))

    for name, j, t in zip(run["names"], run["jgrads"], run["tgrads"]):
        abn = "abn_" in name
        if abn and mode == "bypass":        # the ABN params are unused
            assert float(j.abs().max()) == 0.0 == float(t.abs().max())
        elif not abn or tols["abn"] is not None:
            hold(name, j, t, tols["abn"] if abn else tols["w"])
    if "abn_kind" in tols:
        for kind in ("abn_log_gamma", "abn_beta"):
            js, ts = ([g.flatten() for n, g in zip(run["names"], run[key])
                       if n.endswith(kind)] for key in ("jgrads", "tgrads"))
            hold(f"every {kind}", torch.cat(js), torch.cat(ts),
                 tols["abn_kind"])
    assert not bad, bad


@pytest.mark.parametrize("mode,dtype", CASES)
def test_train_step_params_match_jax(mode, dtype):
    tols = TOLS[(mode, dtype)]
    run = _runs(mode, dtype)
    diffs = [(j - t).abs() for j, t in zip(run["jparams"], run["tparams"])]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs)
    assert worst <= tols["p_max"] and mean <= tols["p_mean"], (worst, mean)


@pytest.mark.parametrize("mode", ("bypass", "fakequant"))
def test_port_loss_drops(mode):
    """25 steps of the port alone, as tests/test_train_integration.py
    trains the JAX package: the loss must drop."""
    cfg = get_smoke_config("olmo_1b").replace(
        cim=CIMConfig(mode=mode, max_gamma=2.0**16), attn_impl="pallas")
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8))
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0))
    step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3), total_steps=25,
                                 warmup=2)
    losses = []
    for s in range(25):
        state, m = step(state, _torch_batch(*data.batch_at(s)))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.15, losses


def test_remat_equals_no_remat():
    """torch.utils.checkpoint recomputes each layer in the backward: the
    gradients equal those of the plain run bit for bit (fakequant's
    dynamic min/max give the same codes in the recompute)."""
    cfg = get_smoke_config("olmo_1b").replace(
        cim=CIMConfig(mode="fakequant", max_gamma=2.0**16),
        attn_impl="pallas")
    batch = _torch_batch(*_batches()[0])
    grads = []
    for remat in (False, True):
        params = steps.train_state(tf.init_params(
            cfg, torch.Generator().manual_seed(1)))["params"]
        loss, _ = steps.loss_fn(cfg.replace(remat=remat), params, batch)
        grads.append(torch.autograd.grad(loss, tree_leaves(params),
                                         allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


def test_flash_and_plain_attention_train_alike():
    """attn_impl "pallas" (the flash path) and "jnp" (plain attention) give
    the same loss and gradients within float32 rounding."""
    base = get_smoke_config("olmo_1b").replace(dtype="float32")
    batch = _torch_batch(*_batches()[0])
    out = []
    for impl in ("pallas", "jnp"):
        params = steps.train_state(tf.init_params(
            base, torch.Generator().manual_seed(2)))["params"]
        loss, _ = steps.loss_fn(base.replace(attn_impl=impl), params, batch)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params),
                                              allow_unused=True)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_decay_mask_follows_the_stacked_jax_leaves():
    """AdamW decays a leaf with ndim >= 2 as JAX stores it: every stacked
    per-layer leaf (ABN gains/offsets included) and the embedding."""
    from repro.models import transformer as jtf
    jcfg, tcfg = _configs("fakequant", "float32")
    jcfg = jcfg.replace(norm_type="rmsnorm")
    tcfg = tcfg.replace(norm_type="rmsnorm")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    want = [a.ndim >= 2 for a in jax.tree.leaves(jparams)]
    tmask = tf.stacked_decay_mask(tf.init_params(
        tcfg, torch.Generator().manual_seed(0)))
    got = tree_leaves(convert.train_params_from_numpy(
        jax.tree.map(np.array, jparams)))
    names = _leaf_names(convert.train_params_from_numpy(
        jax.tree.map(np.array, jparams)))
    # one JAX leaf per stacked leaf; the port repeats it per layer
    per_leaf = dict(zip(names, tree_leaves(tmask)))
    jnames = [n for n in names if "/layers/1/" not in n]
    assert len(jnames) == len(want) and len(got) == len(names)
    for n, w in zip(sorted(jnames, key=lambda s: s.replace("/layers/0",
                                                          "/layers")), want):
        assert per_leaf[n] == w, n
    assert per_leaf["/final_norm/scale"] is False
    assert per_leaf["/layers/1/ln1/scale"] is True


def test_launcher_builds_and_trains_on_the_cpu():
    args = train.parser().parse_args([
        "--arch", "olmo-1b", "--smoke", "--steps", "2", "--seq-len", "16",
        "--batch", "2", "--cim-mode", "fakequant", "--attn-impl", "pallas",
        "--device", "cpu"])
    cfg, state, step_fn, batch_fn = train.build(args)
    assert cfg.attn_impl == "pallas" and cfg.cim.mode == "fakequant"
    before = fkernel.flash_fwd.launches
    for s in range(2):
        state, m = step_fn(state, batch_fn(s))
        assert np.isfinite(float(m["loss"]))
    assert int(state["opt"]["step"]) == 2
    assert fkernel.flash_fwd.launches == before     # plain versions only


@pytest.mark.parametrize("flag", ("--ckpt-dir", "--compress-grads"))
def test_launcher_runs_checkpoints_and_compression(flag, tmp_path, capsys):
    """--ckpt-dir runs the fault-tolerant driver from main() (a
    checkpoint every --ckpt-every steps and at the end); --compress-grads
    gives the state a live error buffer."""
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq-len", "16", "--batch", "2", "--cim-mode",
            "fakequant", "--attn-impl", "pallas"]
    if flag == "--ckpt-dir":
        ck = tmp_path / "ck"
        train.main(argv + ["--ckpt-dir", str(ck), "--ckpt-every", "2"])
        assert "final loss=" in capsys.readouterr().out
        assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000003"]
        assert train.parser().parse_args(argv).ckpt_every == 25
        return
    args = train.parser().parse_args(argv + [flag])
    _, state, step_fn, batch_fn = train.build(args)
    assert "err" in state and not any(e.any() for e in tree_leaves(
        state["err"]))
    for s in range(3):
        state, m = step_fn(state, batch_fn(s))
        assert np.isfinite(float(m["loss"]))
    assert int(state["opt"]["step"]) == 3
    assert any(e.any() for e in tree_leaves(state["err"]))


def test_launcher_defaults_to_the_card():
    args = train.parser().parse_args(["--arch", "olmo-1b", "--smoke"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.build(args)


@pytest.mark.parametrize("op", ("norm", "rope", "silu"))
def test_bf16_digital_ops_match_jax_bit_for_bit(op):
    """The digital ops between projections agree with XLA's bfloat16
    rounding exactly (silu forward and backward included: the port runs
    XLA's expansion of the logistic), so a fakequant code never moves on
    their account."""
    from repro.models import common as jcm
    from repro_torch.models import common as tcm
    rng = np.random.default_rng(5)
    x = (2 * rng.standard_normal((4, 32, 4, 16))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jx, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    if op == "norm":
        jfn = lambda v: jcm.apply_norm({}, v, "nonparam_ln")   # noqa: E731
        tfn = lambda v: tcm.apply_norm({}, v, "nonparam_ln")   # noqa: E731
    elif op == "rope":
        jfn = lambda v: jcm.apply_rope(                          # noqa: E731
            v, jnp.arange(32), jcm.rope_frequencies(16, 1e4))
        tfn = lambda v: tcm.apply_rope(                          # noqa: E731
            v, torch.arange(32), tcm.rope_frequencies(16, 1e4))
    else:
        jfn, tfn = jax.nn.silu, tcm.activation_fn("silu")
    jy, vjp = jax.vjp(jax.jit(jfn), jx)
    ty = tfn(tx)
    np.testing.assert_array_equal(ty.detach().float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    if op == "silu":
        ty.backward(torch.from_numpy(g).to(torch.bfloat16))
        np.testing.assert_array_equal(
            tx.grad.float().numpy(),
            np.asarray(vjp(jg)[0].astype(jnp.float32)))


def test_configs_register_only_what_is_ported():
    from repro_torch.configs import ARCH_IDS, get_config
    # the dense, moe, vlm, hybrid, ssm and audio families, every JAX arch
    # (tests/test_torch_dense_configs.py, tests/test_torch_model_families.py,
    # tests/test_torch_recurrent.py and tests/test_torch_audio.py hold the
    # others against JAX)
    assert sorted(ARCH_IDS) == ["granite_8b", "internvl2_76b",
                                "mamba2_1_3b", "minitron_4b",
                                "mixtral_8x22b", "olmo_1b", "phi35_moe",
                                "qwen2_7b", "recurrentgemma_2b",
                                "whisper_medium"]
    cfg = get_config("olmo-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size) == (16, 2048, 16, 8192, 50304)
    assert get_config("whisper-medium").family == "audio"
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper-large")
