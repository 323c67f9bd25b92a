"""The noise model on the port's training and decode paths, against the
JAX package.

- `_fakequant_forward` with a key equals JAX's bit for bit (eager: the
  JAX source's rounded chain), one row tile and several, and the
  gradient flows as in JAX;
- `transformer.forward(key=)` and its gradients at OLMo-1B's smoke config
  within `tests/test_torch_train.py`'s fakequant float32 tolerances of
  JAX's jitted forward (the jit contracts and reassociates the noise
  chain, so a code may flip, exactly as in the clean comparison), with
  the noise visibly moving both losses;
- noisy in-flight decode of a toy LM: the token streams equal JAX's under
  one key, and every fused stream equals its solo decode;
- the launcher trains 2 steps with `--cim-noise --device cpu`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import cim_layers as jcl
from repro.core import mapping as jmap
from repro.core.noise_model import NoiseConfig as JNoise
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro.runtime import scheduler as jsch
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.convert import key_from_numpy
from repro_torch.core import cim_layers as tcl
from repro_torch.core import prng
from repro_torch.core.noise_model import NO_NOISE, NoiseConfig
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import engine as trt
from repro_torch.runtime import scheduler as tsch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(k, n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, k ** -0.5, (k, n)).astype(np.float32),
            "abn_log_gamma": rng.uniform(-1, 4, n).astype(np.float32),
            "abn_beta": rng.uniform(-3, 3, n).astype(np.float32)}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---- fakequant ---------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,r_in,r_w", [
    (4, 64, 48, 8, 4), (2, 300, 300, 8, 2), (3, 2500, 40, 4, 2),
    (1, 9, 1, 1, 1)], ids=("small", "n300", "three_row_tiles", "tiny"))
def test_noisy_fakequant_forward_matches_jax(m, k, n, r_in, r_w):
    p = _layer(k, n, k + n)
    x = np.random.default_rng(1).normal(size=(m, 5, k)).astype(np.float32)
    jc = jcl.CIMConfig(r_in=r_in, r_w=r_w, noise=JNoise())
    tc = tcl.CIMConfig(r_in=r_in, r_w=r_w, noise=NoiseConfig())
    want = jcl._fakequant_forward({a: jnp.asarray(v) for a, v in p.items()},
                                  jnp.asarray(x), jc, jax.random.PRNGKey(3))
    tp = {a: torch.from_numpy(v) for a, v in p.items()}
    got = tcl.cim_linear_apply(tp, torch.from_numpy(x), tc, key=prng.key(3))
    assert np.array_equal(_bits(want), _bits(got.numpy()))
    clean = tcl.cim_linear_apply(tp, torch.from_numpy(x), tc)
    assert torch.equal(clean, tcl.cim_linear_apply(
        tp, torch.from_numpy(x), tc.replace(noise=NO_NOISE), prng.key(3)))
    if n > 1:
        assert not torch.equal(got, clean)


def test_noisy_fakequant_gradients_match_jax():
    """The STE gradients through the noisy forward (the offsets inside the
    floor reach gamma), float32, against JAX's eager grad."""
    p = _layer(200, 24, 0)
    x = np.random.default_rng(2).normal(size=(6, 200)).astype(np.float32)
    jc = jcl.CIMConfig(r_in=8, r_w=4, noise=JNoise())
    tc = tcl.CIMConfig(r_in=8, r_w=4, noise=NoiseConfig())

    def jloss(params, xx):
        return jnp.sum(jcl._fakequant_forward(params, xx, jc,
                                              jax.random.PRNGKey(4)) ** 2)
    jg = jax.grad(jloss, argnums=(0, 1))(
        {a: jnp.asarray(v) for a, v in p.items()}, jnp.asarray(x))
    tp = {a: torch.from_numpy(v).requires_grad_(True) for a, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(tcl._fakequant_forward(tp, tx, tc, prng.key(4)) ** 2)
    loss.backward()
    for name in p:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jg[0][name]), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(jg[0][name])
                                                     .max()))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-6)


# ---- the LM forward ------------------------------------------------------------

SEQ, BATCH = 32, 4


def _lm_configs(noise: bool):
    jn, tn = (JNoise(), NoiseConfig()) if noise else (
        JNoise(enabled=False), NO_NOISE)
    jcfg = jax_smoke("olmo_1b").replace(
        cim=jcl.CIMConfig(mode="fakequant", max_gamma=2.0**16, noise=jn),
        attn_impl="pallas", dtype="float32")
    tcfg = get_smoke_config("olmo_1b").replace(
        cim=tcl.CIMConfig(mode="fakequant", max_gamma=2.0**16, noise=tn),
        attn_impl="pallas", dtype="float32")
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _lm_losses():
    jcfg, tcfg = _lm_configs(True)
    _, tclean = _lm_configs(False)
    jparams = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))["params"]
    tparams = steps.train_state(convert.train_params_from_numpy(
        jax.tree.map(np.array, jparams)))["params"]
    toks, labels = SyntheticLM(LMDataConfig(
        vocab_size=512, seq_len=SEQ, global_batch=BATCH)).batch_at(0)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 0)

    def jloss(params, key):
        logits, _, _ = jtf.forward(jcfg, params, jnp.asarray(toks), key=key)
        return jsteps.cross_entropy(logits, jnp.asarray(labels))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams, jkey)
    jclean = jax.jit(jloss)(jparams, None)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    tkey = key_from_numpy(np.asarray(jkey))
    tl, _ = steps.loss_fn(tcfg, tparams, batch, tkey)
    tg = torch.autograd.grad(tl, tree_leaves(tparams))
    tl2, _ = steps.loss_fn(tcfg, tparams, batch, tkey)
    tc, _ = steps.loss_fn(tclean, tparams, batch)
    jgl = tree_leaves(convert.train_params_from_numpy(
        jax.tree.map(np.array, jg)))
    return dict(jl=float(jl), jclean=float(jclean), tl=float(tl.detach()),
                tl2=float(tl2.detach()), tclean=float(tc.detach()),
                jgnorm=float(np.sqrt(sum(float(torch.sum(g * g))
                                         for g in jgl))),
                tgnorm=float(np.sqrt(sum(float(torch.sum(g * g))
                                         for g in tg))))


def test_noisy_lm_forward_within_train_tolerances_of_jax():
    r = _lm_losses()
    assert abs(r["tl"] - r["jl"]) <= 5e-3 * abs(r["jl"]), r
    assert abs(r["tgnorm"] - r["jgnorm"]) <= 2e-2 * r["jgnorm"], r
    assert r["tl"] == r["tl2"]                  # same key, same noise


def test_noise_moves_the_lm_loss_in_both_packages():
    r = _lm_losses()
    assert r["tl"] != r["tclean"] and r["jl"] != r["jclean"], r
    # and the clean losses agree within the same tolerance
    assert abs(r["tclean"] - r["jclean"]) <= 5e-3 * abs(r["jclean"]), r


def test_remat_recompute_redraws_the_same_noise():
    """A checkpointed layer's recompute draws under the same keys: the
    gradients with and without remat agree."""
    _, tcfg = _lm_configs(True)
    outs = []
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        params = steps.init_train_state(
            cfg, torch.Generator().manual_seed(0))["params"]
        toks, labels = SyntheticLM(LMDataConfig(
            vocab_size=512, seq_len=16, global_batch=2)).batch_at(0)
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(labels).long()}
        loss, _ = steps.loss_fn(cfg, params, batch, prng.key(9))
        outs.append((loss, torch.autograd.grad(loss,
                                               tree_leaves(params))))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---- noisy in-flight decode --------------------------------------------------

D, D_FF, DEPTH, VOCAB, HEADS, WINDOW = 48, 96, 2, 23, 4, 16


@functools.lru_cache(maxsize=None)
def _decode_models():
    """(JAX model, port model) over the same masters, noise enabled, as
    tests/test_torch_decode_lm.py builds the clean pair."""
    cfg = jrt.EngineConfig(noise=JNoise())
    qkv_p = jprog.SharedInputProgram.compile(
        D, (("q", D), ("k", D), ("v", D)), cfg, r_in=4, r_w=2)
    o_p = jprog.compile_program(
        (jmap.LayerSpec(m=8, k=D, n=D, r_in=4, r_w=2),), cfg,
        activations=("none",))
    gu_p = jprog.SharedInputProgram.compile(
        D, (("gate", D_FF), ("up", D_FF)), cfg, r_in=4, r_w=2)
    dn_p = jprog.compile_program(
        (jmap.LayerSpec(m=8, k=D_FF, n=D, r_in=4, r_w=2),), cfg,
        activations=("none",))
    key = jax.random.PRNGKey(7)
    masters = []
    for b in range(DEPTH):
        kb = jax.random.fold_in(key, 100 + b)
        masters.append({
            "qkv": qkv_p.init_params(jax.random.fold_in(kb, 0)),
            "o": list(o_p.init_params(jax.random.fold_in(kb, 1))),
            "gate_up": gu_p.init_params(jax.random.fold_in(kb, 2)),
            "down": list(dn_p.init_params(jax.random.fold_in(kb, 3)))})
    embed = 0.25 * jax.random.normal(jax.random.fold_in(key, 1), (VOCAB, D),
                                     jnp.float32)
    jmodel = jsch.CIMDecodeLM(
        embed, [jsch.DecodeBlock(qkv=qkv_p.bind(m["qkv"]), o=o_p.bind(m["o"]),
                                 gate_up=gu_p.bind(m["gate_up"]),
                                 down=dn_p.bind(m["down"]))
                for m in masters], n_heads=HEADS, window=WINDOW)

    def npl(p):
        return {a: np.asarray(v) for a, v in p.items()}

    tblocks = [{"q": npl(m["qkv"]["q"]), "k": npl(m["qkv"]["k"]),
                "v": npl(m["qkv"]["v"]), "o": npl(m["o"][0]),
                "gate": npl(m["gate_up"]["gate"]),
                "up": npl(m["gate_up"]["up"]), "down": npl(m["down"][0])}
               for m in masters]
    tmodel = convert.decode_lm_from_numpy(
        np.asarray(embed), tblocks, n_heads=HEADS, window=WINDOW,
        cfg=trt.EngineConfig(noise=NoiseConfig()), device="cpu")
    clean = convert.decode_lm_from_numpy(
        np.asarray(embed), tblocks, n_heads=HEADS, window=WINDOW,
        device="cpu")
    return jmodel, tmodel, clean


def _schedule(seed, n_req):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n_req):
        prompt = tuple(int(t) for t in
                       rng.integers(0, VOCAB, size=int(rng.integers(1, 5))))
        out.append((int(rng.integers(0, 7)), uid, prompt,
                    int(rng.integers(2, 6))))
    return out


def test_noisy_decode_equals_jax_and_solo():
    jmodel, tmodel, clean = _decode_models()
    sched = _schedule(3, 5)
    jkey = jax.random.PRNGKey(11)
    jout = jsch.InflightScheduler(jmodel, capacity=4, key=jkey).run(
        [(t, jsch.Request(u, p, n)) for t, u, p, n in sched])
    key = key_from_numpy(np.asarray(jkey))
    tout = tsch.InflightScheduler(tmodel, capacity=4, key=key).run(
        [(t, tsch.Request(u, p, n)) for t, u, p, n in sched])
    assert tout == jout
    for t, u, p, n in sched:
        assert tsch.decode_sequential(tmodel, tsch.Request(u, p, n), key) \
            == tout[u]
    cout = tsch.InflightScheduler(clean, capacity=4).run(
        [(t, tsch.Request(u, p, n)) for t, u, p, n in sched])
    assert cout != tout                          # the noise reaches tokens
    other = tsch.InflightScheduler(tmodel, capacity=4, key=prng.key(12)).run(
        [(t, tsch.Request(u, p, n)) for t, u, p, n in sched])
    assert other != tout


def test_noisy_decode_needs_a_key():
    _, tmodel, clean = _decode_models()
    with pytest.raises(ValueError, match="needs a PRNG key"):
        tsch.InflightScheduler(tmodel, capacity=2)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        tsch.decode_sequential(tmodel, tsch.Request(0, (1,), 1))
    # a clean model ignores a key
    assert tsch.decode_sequential(clean, tsch.Request(0, (1, 2), 3),
                                  prng.key(1)) == \
        tsch.decode_sequential(clean, tsch.Request(0, (1, 2), 3))


# ---- the launcher --------------------------------------------------------------

def test_launcher_trains_with_cim_noise_on_the_cpu(capsys):
    argv = ["--arch", "olmo-1b", "--smoke", "--steps", "2", "--seq-len",
            "16", "--batch", "2", "--cim-mode", "fakequant", "--attn-impl",
            "pallas", "--device", "cpu", "--cim-noise", "--seed", "3"]
    args = train.parser().parse_args(argv)
    cfg, state, step_fn, batch_fn = train.build(args)
    assert cfg.cim.noise == NoiseConfig()
    assert torch.equal(train.step_key(args, 1),
                       prng.fold_in(prng.key(3), 1))
    assert train.step_key(train.parser().parse_args(argv[:-3]), 1) is None
    losses = []
    for s in range(2):
        state, m = step_fn(state, batch_fn(s), train.step_key(args, s))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    train.main(argv)
    assert "noise=True" in capsys.readouterr().out
