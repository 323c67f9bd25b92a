"""The serve loops of the moe and vlm families against the JAX package's,
on the CPU: phi3.5-moe, mixtral and internvl2 at their smoke configs in
float32, the same weights carried across with
`convert.train_params_from_numpy`, prompts from numpy at a fixed seed.
The JAX side runs jitted, its engine's Pallas kernel in interpret mode;
the port runs its kernels' plain versions.

- static batch (`serve.static_serve`, JAX's launcher loop: a prefill of
  2 x 8 tokens, internvl2's behind its 8 patch embeddings as the JAX
  launcher draws them, then 4 greedy steps): the greedy tokens equal
  JAX's in fakequant and engine, and each step's logits within 1e-5
  relative, but one step within 2e-2 in fakequant and engine
  (`tests/test_torch_serve.py`'s bounds: an activation code moved by an
  ulp of the float glue);
- in flight (`serve.inflight_serve` against JAX's `_run_inflight` loop,
  transcribed with jnp, its prefill jitted: solo prefill, one copy into the slot cache,
  fused steps at per-slot positions), phi3.5 and mixtral, 6 requests
  over 3 slots: every request's tokens equal JAX's in fakequant and
  engine.  In-flight MoE is not equal to solo decoding in either
  package (the expert groups mix the requests), so nothing holds that;
- the launcher: `--arch phi3.5-moe-42b-a6.6b --smoke --device cpu
  --cim-mode engine --assert-no-recompile` exits 0, static and
  `--inflight`; internvl2 serves static and refuses `--inflight`, as the
  JAX launcher does; the prefix is JAX's draw bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import cim_layers as jcl
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import cim_layers as tcl
from repro_torch.launch import serve


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, P, GEN = 2, 8, 4
REL_TOL, CODE_MOVE_TOL = 1e-5, 2e-2
SLOTS, REQUESTS = 3, 6


def _cfgs(arch, mode, inflight=False):
    kw = dict(mode=mode, max_gamma=2.0**16, isolate_rows=inflight)
    return (jax_smoke(arch).replace(cim=jcl.CIMConfig(**kw),
                                    dtype="float32"),
            get_smoke_config(arch).replace(cim=tcl.CIMConfig(**kw),
                                           dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg, _ = _cfgs(arch, "fakequant")
    return jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))


def _max_len(cfg):
    return serve.serve_max_len(cfg, P, GEN)


def _prompt(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))


def _jax_static(arch, mode):
    jcfg, tcfg = _cfgs(arch, mode)
    params = jax.tree.map(jnp.asarray, _jax_params(arch))
    kw = {}
    if jcfg.family == "vlm":
        kw["prefix_embeds"] = jax.random.normal(
            jax.random.PRNGKey(0), (B, jcfg.vision_tokens, jcfg.d_model))
    pre = jax.jit(lambda p, t, c: jtf.forward(jcfg, p, t, cache=c,
                                              **kw)[:2])
    step = jax.jit(lambda p, t, c: jtf.forward(jcfg, p, t, cache=c)[:2])
    logits, cache = pre(params, jnp.asarray(_prompt(tcfg), jnp.int32),
                        jtf.init_cache(jcfg, B, _max_len(tcfg)))
    out, toks = [], []
    for _ in range(GEN + 1):
        out.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if len(toks) <= GEN:
            logits, cache = step(params, tok, cache)
    return out, np.concatenate(toks, axis=1)


@pytest.mark.parametrize("arch,mode", [
    ("phi35_moe", "fakequant"), ("phi35_moe", "engine"),
    ("mixtral_8x22b", "engine"), ("internvl2_76b", "fakequant"),
    ("internvl2_76b", "engine")])
def test_static_serve_matches_jax(arch, mode):
    _, tcfg = _cfgs(arch, mode)
    want, want_toks = _jax_static(arch, mode)
    prefix = (serve.make_prefix(tcfg, B, 0, "cpu")
              if tcfg.family == "vlm" else None)
    out = serve.static_serve(
        tcfg, convert.train_params_from_numpy(_jax_params(arch)),
        torch.from_numpy(_prompt(tcfg)), GEN, max_len=_max_len(tcfg),
        keep_logits=True, prefix=prefix)
    np.testing.assert_array_equal(out["tokens"].numpy(), want_toks)
    rel = [float(np.linalg.norm(g.numpy() - w) / np.linalg.norm(w))
           for g, w in zip(out["logits"], want)]
    assert sum(r > REL_TOL for r in rel) <= 1, rel
    assert max(rel) <= CODE_MOVE_TOL, rel


def _jax_inflight(jcfg, params, reqs, slots, max_len):
    """JAX's `repro/launch/serve.py:_run_inflight` loop, its prints
    dropped and its prefill jitted (one trace at the fixed prompt
    length): {uid: tokens}."""
    cache = jtf.init_slot_cache(jcfg, slots, max_len)

    @jax.jit
    def prefill(params, prompt):
        c1 = jtf.init_cache(jcfg, 1, max_len=max_len)
        logits, c1, _ = jtf.forward(jcfg, params, prompt[None], cache=c1)
        return c1, jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)

    @jax.jit
    def step(params, cache, tok):
        pos = cache["pos"][:, None]
        logits, cache, _ = jtf.forward(jcfg, params, tok[:, None],
                                       positions=pos, cache=cache)
        return jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32), cache

    free, live, queue, tokens = list(range(slots)), {}, list(reqs), {}
    cur = jnp.zeros((slots,), jnp.int32)
    clock = 0
    while queue or live:
        while queue and free and queue[0]["arrival"] <= clock:
            r = queue.pop(0)
            s = free.pop(0)
            c1, tok = prefill(params, jnp.asarray(r["prompt"], jnp.int32))
            cache = jtf.write_slot_cache(cache, s, c1)
            cur = cur.at[s].set(tok[0])
            tokens[r["uid"]] = [int(tok[0])]
            if len(tokens[r["uid"]]) >= r["gen"]:
                free = sorted(free + [s])
                cache = jtf.free_slot_cache(cache, s)
            else:
                live[s] = r
        if live:
            nxt, cache = step(params, cache, cur)
            nxt = np.asarray(nxt)
            for s in sorted(live):
                r = live[s]
                tokens[r["uid"]].append(int(nxt[s]))
                cur = cur.at[s].set(int(nxt[s]))
                if len(tokens[r["uid"]]) >= r["gen"]:
                    free = sorted(free + [s])
                    cache = jtf.free_slot_cache(cache, s)
                    del live[s]
        clock += 1
    return tokens


@pytest.mark.parametrize("arch,mode", [
    ("phi35_moe", "fakequant"), ("phi35_moe", "engine"),
    ("mixtral_8x22b", "fakequant")])
def test_inflight_serve_matches_jax(arch, mode):
    jcfg, tcfg = _cfgs(arch, mode, inflight=True)
    reqs = serve.make_requests(tcfg.vocab_size, REQUESTS, P, GEN, 0)
    max_len = _max_len(tcfg)
    want = _jax_inflight(jcfg, jax.tree.map(jnp.asarray, _jax_params(arch)),
                         reqs, SLOTS, max_len)
    got = serve.inflight_serve(
        tcfg, convert.train_params_from_numpy(_jax_params(arch)), reqs,
        SLOTS, max_len=max_len, device="cpu")
    assert got["tokens"] == want
    assert len(set(got["slot"].values())) > 1


def test_prefix_is_jax_draw():
    _, cfg = _cfgs("internvl2_76b", "bypass")
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                        (2, cfg.vision_tokens, cfg.d_model)))
    got = serve.make_prefix(cfg, 2, 3, "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("extra", [[], ["--inflight"]])
def test_launcher_serves_moe_without_recompiles(extra, capsys):
    serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device",
                "cpu", "--cim-mode", "engine", "--prompt-len", "8",
                "--gen-len", "4", "--batch", "2", "--assert-no-recompile"]
               + extra)
    assert "plans=0 captures=0" in capsys.readouterr().out


def test_launcher_serves_vlm_static_only(capsys):
    base = ["--arch", "internvl2-76b", "--smoke", "--device", "cpu",
            "--cim-mode", "engine", "--prompt-len", "8", "--gen-len", "3",
            "--batch", "2", "--assert-no-recompile"]
    serve.main(base)
    assert "plans=0 captures=0" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(base + ["--inflight"])
