"""The audio family (whisper-medium) in the port against the JAX package's.

At the smoke config (2 encoder + 2 decoder layers, d 64, 4 heads, vocab
512), float32, the same weights carried across with
`convert.train_params_from_numpy` and numpy inputs from a seed:

- `CONFIG` and `smoke_config()` equal JAX's field for field, the registry
  lists every JAX arch in JAX's order, and the full config's parameter
  count equals JAX's `eval_shape` count (built under `FakeTensorMode`);
- the cache-free forward over encoder frames: bypass within 1e-5 of the
  largest logit; fakequant with its greedy tokens equal, the CE of its
  logits within `tests/test_torch_train.py`'s float32 loss tolerance
  (5e-3) and the logits within 5e-2 of the largest (they read 1-2%:
  XLA's CPU tanh, in gelu, differs from PyTorch's by an ulp on most
  inputs, ROADMAP Queue 3 "Found, not faults", and in fakequant an ulp
  can move an activation code; recurrentgemma's gelu reads 4%);
- the cached prefill with frames, then 7 single-token decode steps that
  read the cross-attention K/V from the cache ("xkv"), against JAX's own
  loop (`tests/test_models_smoke.py::test_train_decode_consistency`)
  within 1e-5 of the largest logit;
- the cross-attention block alone, Sq != Sk, on the flash kernels (JAX's
  Pallas in interpret mode, the port's plain versions) and on the plain
  attention: output within 2e-5 of the largest, gradients within 5e-5;
- 3 `make_train_step` steps with `encoder_frames` (flash attention) in
  bypass and fakequant within `tests/test_torch_train.py`'s float32
  tolerances;
- in the port, engine == fakequant bit for bit through `static_serve`;
- the serve's and the train launcher's frames equal `jax.random.normal`
  bit for bit; `--inflight`, a slot cache and a noise key refused as JAX
  refuses them;
- the "dots" remat policy: loss and every gradient equal to "full" remat
  and to no remat bit for bit, on a dense and the audio smoke config
  (whose stacks run "full" whatever the policy, as JAX's do);
- reference fault 12: JAX's frameless forward lets position t see token
  t + 1, the port's launcher batches (with frames) do not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import cim_layers as jcl
from repro.data.lm_data import LMDataConfig as JaxDataConfig
from repro.data.lm_data import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jsteps
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JaxAdamW
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import cim_layers as tcl
from repro_torch.core import prng
from repro_torch.launch import serve, steps, train
from repro_torch.models import common as tcm
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


ARCH = "whisper_medium"
B, T, S = 2, 24, 8          # batch, encoder frames, decoder tokens
LR = 1e-3
STEPS = 3
# tests/test_torch_train.py's float32 tolerances: loss and grad norm
# relative, params max / mean abs after the steps
TOLS = {"bypass": dict(loss=1e-5, gnorm=1e-5, p_max=1e-4, p_mean=1e-6),
        "fakequant": dict(loss=5e-3, gnorm=2e-2, p_max=2 * LR * STEPS,
                          p_mean=1e-4)}


def _rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = ({g.name: getattr(v, g.name)
                        for g in dataclasses.fields(v)
                        if g.name not in ("noise", "macro", "sharding")}
                       if f.name == "cim" else v)
    return out


def _configs(mode, attn="pallas", dtype="float32"):
    kw = dict(mode=mode, max_gamma=2.0**16)
    return (jax_smoke(ARCH).replace(cim=jcl.CIMConfig(**kw), attn_impl=attn,
                                    dtype=dtype),
            get_smoke_config(ARCH).replace(cim=tcl.CIMConfig(**kw),
                                           attn_impl=attn, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _configs("bypass")
    return jax.tree.map(np.array, jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(1)))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (B, S)),
            rng.standard_normal((B, T, 64)).astype(np.float32))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_and_registry_equal_jax():
    for port, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH)),
                      (get_config("whisper-medium"),
                       jax_config("whisper-medium"))):
        assert _fields(port) == _fields(ref)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.max_target_len) == (24, 24, 1024, 16, 64, 4096, 51865, 448)
    assert ARCH_IDS == list(JAX_ARCH_IDS)


def test_full_config_parameter_count_equals_jax():
    shapes = jax.eval_shape(lambda: jtf.init_params(jax_config(ARCH),
                                                    jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with FakeTensorMode():
        params = tf.init_params(get_config(ARCH), torch.Generator())
        got = sum(p.numel() for p in tree_leaves(params))
    assert got == want > 7e8


# ---------------------------------------------------------------------------
# forward, cached decode, the cross-attention block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("bypass", "fakequant"))
def test_forward_over_frames_matches_jax(mode):
    jcfg, tcfg = _configs(mode)
    jp = _jax_params()
    toks, frames = _inputs()
    want = np.asarray(jax.jit(lambda p, t, f: jtf.forward(
        jcfg, p, t, encoder_frames=f)[0])(jp, toks, frames))
    with torch.no_grad():
        got = tf.forward(tcfg, convert.train_params_from_numpy(jp),
                         torch.from_numpy(toks),
                         encoder_frames=torch.from_numpy(frames))[0]
    assert got.shape == (B, S, 512)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    if mode == "bypass":
        assert _rel(got, want) <= 1e-5
        return
    assert _rel(got, want) <= 5e-2
    labels = torch.from_numpy(np.roll(toks, -1, 1))
    ce = [float(steps.cross_entropy(torch.from_numpy(np.array(lg)),
                                    labels)) for lg in (got, want)]
    assert abs(ce[0] - ce[1]) <= TOLS["fakequant"]["loss"] * ce[1], ce


def test_cached_prefill_and_decode_match_jax():
    """The prefill of the first token with the frames, then 7 single-token
    steps reading the cache's cross K/V, each step's logits against JAX's
    (float32 caches on both sides, bypass), and the port's steps against
    the port's cache-free forward."""
    jcfg, tcfg = _configs("bypass", attn="jnp")
    jp = _jax_params()
    params = convert.train_params_from_numpy(jp)
    toks, frames = _inputs(1)
    step = jax.jit(lambda p, c, t, f: jtf.forward(
        jcfg, p, t, cache=c, encoder_frames=f)[:2])
    dec = jax.jit(lambda p, c, t: jtf.forward(jcfg, p, t, cache=c)[:2])
    jcache = jtf.init_cache(jcfg, B, max_len=T, dtype=jnp.float32)
    tcache = tf.init_cache(tcfg, B, max_len=T, dtype=torch.float32)
    xkv = tcache["layers"]["xkv"]["k"]
    with torch.no_grad():
        free = tf.forward(tcfg, params, torch.from_numpy(toks),
                          encoder_frames=torch.from_numpy(frames))[0]
        for t in range(S):
            tok = toks[:, t:t + 1]
            if t == 0:
                want, jcache = step(jp, jcache, tok, frames)
                got, tcache, _ = tf.forward(
                    tcfg, params, torch.from_numpy(tok), cache=tcache,
                    encoder_frames=torch.from_numpy(frames))
            else:
                want, jcache = dec(jp, jcache, tok)
                got, tcache, _ = tf.forward(tcfg, params,
                                            torch.from_numpy(tok),
                                            cache=tcache)
            assert _rel(got, want) <= 1e-5, t
            assert _rel(got[:, 0], free[:, t]) <= 1e-5, t
    # the prefill wrote the cross K/V into the cache's own leaf
    assert tcache["layers"]["xkv"]["k"] is xkv and int(tcache["pos"]) == S
    np.testing.assert_allclose(
        xkv.numpy(), np.asarray(jcache["layers"]["xkv"]["k"]), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("impl", ("pallas", "jnp"))
def test_cross_attention_block_matches_jax(impl):
    """attention_block with x_kv (Sq 40 over Sk 72, non-causal): JAX's
    Pallas flash kernels in interpret mode (impl "pallas") or its plain
    attention against the port's; output and every gradient."""
    d, h, hd = 64, 4, 16
    jacfg = jcm.AttnConfig(d_model=d, n_heads=h, n_kv_heads=h, head_dim=hd,
                           causal=False, use_rope=False, impl=impl)
    tacfg = tcm.AttnConfig(d_model=d, n_heads=h, n_kv_heads=h, head_dim=hd,
                           causal=False, use_rope=False, impl=impl)
    jp = jax.tree.map(np.array, jcm.init_attention(jax.random.PRNGKey(3),
                                                    jacfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 40, d)).astype(np.float32)
    enc = rng.standard_normal((B, 72, d)).astype(np.float32)
    g = rng.standard_normal((B, 40, d)).astype(np.float32)
    jcim, tcim = jcl.CIMConfig(mode="bypass"), tcl.CIMConfig(mode="bypass")

    def jfn(p, x, enc):
        out, _ = jcm.attention_block(p, x, jacfg, jcim,
                                     positions=jnp.arange(40), x_kv=enc)
        return jnp.sum(out * g), out
    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(jp, x, enc)
    tp = convert.params_from_numpy(jp)
    tx, tenc = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    got, cache = tcm.attention_block(tp, tx, tacfg, tcim,
                                     positions=torch.arange(40), x_kv=tenc)
    assert cache is None
    assert _rel(got.detach(), want) <= 2e-5
    leaves = [tp[k]["w"] for k in ("wq", "wk", "wv", "wo")] + [tx, tenc]
    for p in leaves[:4]:
        p.requires_grad_()
    got, _ = tcm.attention_block(tp, tx, tacfg, tcim,
                                 positions=torch.arange(40), x_kv=tenc)
    tgrads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), leaves)
    jg = [jgrads[0][k]["w"] for k in ("wq", "wk", "wv", "wo")] + list(
        jgrads[1:])
    for a, b in zip(tgrads, jg):
        assert _rel(a, b) <= 5e-5


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _train_runs(mode):
    jcfg, tcfg = _configs(mode)
    jp = _jax_params()
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": jsteps.init_train_state(jcfg, jax.random.PRNGKey(1))[
                  "opt"]}
    tstate = steps.train_state(convert.train_params_from_numpy(jp))
    data = JaxSyntheticLM(JaxDataConfig(vocab_size=512, seq_len=S,
                                        global_batch=B))
    jstep = jax.jit(jsteps.make_train_step(jcfg, JaxAdamW(lr=LR),
                                           total_steps=10, warmup=2))
    tstep = steps.make_train_step(tcfg, AdamWConfig(lr=LR), total_steps=10,
                                  warmup=2)
    metrics = []
    for s in range(STEPS):
        toks, labels = data.batch_at(s)
        frames = np.random.default_rng(10 + s).standard_normal(
            (B, T, 64)).astype(np.float32)
        jstate, jm = jstep(jstate, {"tokens": toks, "labels": labels,
                                    "encoder_frames": frames})
        tstate, tm = tstep(tstate, {
            "tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long(),
            "encoder_frames": torch.from_numpy(frames)})
        metrics.append({k: (float(jm[k]), float(tm[k]))
                        for k in ("loss", "ce", "grad_norm")})
    return {"metrics": metrics,
            "params": (tree_leaves(convert.train_params_from_numpy(
                jax.tree.map(np.array, jstate["params"]))),
                [p.detach() for p in tree_leaves(tstate["params"])])}


@pytest.mark.parametrize("mode", ("bypass", "fakequant"))
def test_train_steps_with_frames_match_jax(mode):
    tols = TOLS[mode]
    run = _train_runs(mode)
    for m in run["metrics"]:
        for key, tol in (("loss", tols["loss"]), ("ce", tols["loss"]),
                         ("grad_norm", tols["gnorm"])):
            j, t = m[key]
            assert np.isfinite(t) and abs(j - t) <= tol * abs(j), (key, j, t)
    jp, tp = run["params"]
    diffs = [(a - b).abs() for a, b in zip(jp, tp)]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs)
    assert worst <= tols["p_max"] and mean <= tols["p_mean"], (worst, mean)


def test_decay_mask_follows_the_stacked_jax_leaves():
    """AdamW decays a leaf when JAX stores it with 2 or more dimensions:
    every per-layer leaf of "enc_layers" and "layers", the embedding and
    pos_dec, not the final or encoder norms."""
    jp = _jax_params()
    want = tree_leaves(convert.deploy_params_from_numpy(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim >= 2), jp)))
    got = tf.stacked_decay_mask(convert.train_params_from_numpy(jp))
    assert len(want) == len(tree_leaves(got))
    for w, g in zip(want, tree_leaves(got)):
        assert bool(w.all()) == bool(w.any()) == g
    assert got["final_norm"]["scale"] is got["enc_norm"]["bias"] is False
    assert got["pos_dec"] is True
    assert all(tree_leaves(got["enc_layers"]) + tree_leaves(got["layers"]))


# ---------------------------------------------------------------------------
# serving and the launchers
# ---------------------------------------------------------------------------

def test_engine_serve_equals_fakequant():
    args = serve.parser().parse_args([
        "--arch", "whisper-medium", "--smoke", "--device", "cpu",
        "--cim-mode", "engine", "--batch", "2", "--prompt-len", "4",
        "--gen-len", "3"])
    cfg, params, dev = serve.build(args)
    max_len = serve.serve_max_len(cfg, 4, 3)
    prompt = serve.make_prompt(cfg.vocab_size, 2, 4, 0, dev)[:, :1]
    frames = serve.make_frames(cfg, 2, max_len, 0, dev)
    runs = [serve.static_serve(c, params, prompt, 3, max_len=max_len,
                               keep_logits=True, frames=frames)
            for c in (cfg, cfg.replace(cim=cfg.cim.replace(
                mode="fakequant")))]
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    assert all(torch.equal(a, b) for a, b in zip(runs[0]["logits"],
                                                 runs[1]["logits"]))
    assert runs[0]["growth"] == {"plans": 0, "captures": 0, "binds": 0}


def test_frames_are_jax_draws():
    cfg = get_smoke_config(ARCH)
    got = serve.make_frames(cfg, 3, 20, 5, "cpu")
    want = jax.random.normal(jax.random.PRNGKey(5), (3, 20, cfg.d_model))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = train.audio_frames(cfg, 2, 16, 7, 3, "cpu")
    want = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(7), 3),
                             (2, 16, cfg.d_model))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_launcher_and_its_refusals(capsys):
    base = ["--arch", "whisper-medium", "--smoke", "--device", "cpu",
            "--cim-mode", "engine", "--prompt-len", "6", "--gen-len", "3",
            "--batch", "2"]
    serve.main(base + ["--assert-no-recompile"])
    out = capsys.readouterr().out
    assert "prefill(1 tokens)" in out and "plans=0 captures=0" in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--inflight"])
    _, cfg = _configs("fakequant")
    with pytest.raises(ValueError, match="attention-cache"):
        tf.init_slot_cache(cfg, 2, 16)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks, frames = _inputs()
    toks, frames = torch.from_numpy(toks), torch.from_numpy(frames)
    with pytest.raises(ValueError, match="noise-keyed"):
        tf.forward(cfg, params, toks, encoder_frames=frames,
                   key=prng.key(0))
    cache = tf.init_cache(cfg, B, max_len=T + 1)
    with pytest.raises(ValueError, match="do not fit"):
        tf.forward(cfg, params, toks, cache=cache, encoder_frames=frames)


def test_train_launcher_feeds_audio_batches():
    args = train.parser().parse_args([
        "--arch", "whisper-medium", "--smoke", "--steps", "2", "--seq-len",
        "48", "--batch", "2", "--cim-mode", "fakequant", "--attn-impl",
        "pallas", "--device", "cpu"])
    cfg, state, step_fn, batch_fn = train.build(args)
    batch = batch_fn(0)
    assert batch["tokens"].shape == batch["labels"].shape == (2, 6)
    assert batch["encoder_frames"].shape == (2, 48, cfg.d_model)
    losses = []
    for s in range(2):
        state, m = step_fn(state, batch_fn(s))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and int(state["opt"]["step"]) == 2


# ---------------------------------------------------------------------------
# the "dots" remat policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("olmo_1b", ARCH))
def test_dots_remat_equals_full_and_none(arch):
    """Loss and every gradient bit for bit equal under no remat, "full"
    and "dots" (fakequant, flash attention).  On the decoder stack "dots"
    keeps the products' outputs: its backward dispatches as many matrix
    products as the backward without remat, "full"'s more (the
    recompute's).  The audio stacks run "full" whatever the policy, as
    JAX's do: "dots" dispatches what "full" does."""
    base = get_smoke_config(arch).replace(
        cim=tcl.CIMConfig(mode="fakequant", max_gamma=2.0**16),
        attn_impl="pallas")
    params = tf.init_params(base, torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks, frames = _inputs(2)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)).long()}
    if arch == ARCH:
        batch["encoder_frames"] = torch.from_numpy(frames)
    runs, mms = [], []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = base.replace(remat=remat, remat_policy=policy)
        loss, _ = steps.loss_fn(cfg, params, batch)
        with _MatmulCount() as count:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        runs.append((loss.detach(), grads))
        mms.append(count.n)
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][1]):
            assert (a is None and b is None) or torch.equal(a, b)
    if arch == ARCH:
        assert mms[0] < mms[1] == mms[2]
    else:
        assert mms[0] == mms[2] < mms[1]


class _MatmulCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the non-batched matrix products (aten.mm) dispatched."""

    def __enter__(self):
        self.n = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# reference fault 12
# ---------------------------------------------------------------------------

def test_frameless_jax_forward_sees_the_next_token():
    """ROADMAP Queue 3, reference fault 12: JAX's launcher trains every
    arch on token-only batches, and without frames `_audio_forward`'s
    cross-attention block attends, bidirectionally, over the decoder's
    own tokens, so the logits at position t change with token t + 1 (the
    label they are trained to predict).  With the frames the port's
    launcher feeds, position t does not depend on token t + 1, and the
    port's frameless cache-free forward raises."""
    jcfg, tcfg = _configs("bypass", attn="jnp")
    jp = _jax_params()
    toks, frames = _inputs(3)
    t = 3
    moved = toks.copy()
    moved[:, t + 1] = (moved[:, t + 1] + 1) % 512
    fwd = jax.jit(lambda p, x: jtf.forward(jcfg, p, x)[0])
    a, b = np.asarray(fwd(jp, toks)), np.asarray(fwd(jp, moved))
    assert np.abs(a[:, t] - b[:, t]).max() > 1e-3
    params = convert.train_params_from_numpy(jp)
    with torch.no_grad():
        a, b = (tf.forward(tcfg, params, torch.from_numpy(x),
                           encoder_frames=torch.from_numpy(frames))[0]
                for x in (toks, moved))
    assert torch.equal(a[:, :t + 1], b[:, :t + 1])
    assert not torch.equal(a[:, t + 1], b[:, t + 1])
    with pytest.raises(ValueError, match="reference fault 12"):
        tf.forward(tcfg, params, torch.from_numpy(toks))
