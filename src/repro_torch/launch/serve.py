"""Serving launcher: batched prefill + decode over KV caches.

Counterpart of `repro/launch/serve.py`:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --cim-mode engine --prompt-len 32 --gen-len 16 --batch 4

serves the model family's own `transformer.forward` (embedding, norms,
RoPE, attention over a KV cache, SwiGLU, the tied head).  It runs on CUDA
by default and raises without a card; `--device cpu` runs it on the host,
with the kernels' plain versions (add `--smoke` for the reduced config).

`--cim-mode engine` routes every projection through the compiled-program
runtime (`runtime/program.py`): each projection's program comes from the
program cache (planned once per layer shape and batch bucket) and its
weights are bound once (`program.bound_for`), so on the card every
dispatch after a key's first replays a captured CUDA graph.  The
launcher counts plans (`engine.PLAN_COUNT`), captures
(`engine.CAPTURE_COUNT`, the port's counterpart of the JAX package's
TRACE_COUNT), weight binds (`program.bound_cache_stats`) and, on the
card, eager dispatches across the decode loop after its first step;
`--assert-no-recompile` turns any growth into a failure.

`--inflight` switches the decode loop to continuous (in-flight) batching
over a slot-mapped KV cache (`transformer.init_slot_cache`): requests
admit (solo prefill, one copy into a free slot) and retire (cursor
reset) between fused decode steps, `--batch` is the slot capacity, and
in engine mode every slot is its own activation-quantization segment
(`CIMConfig.isolate_rows`), so a request's tokens do not depend on its
batchmates.

`--precision-policy {mixed,quality,balanced,throughput}` (with
`--cim-mode engine --inflight`) runs the workload-adaptive precision
demo instead of `--arch`'s model, at the JAX launcher's sizes: calibrate
the four projections of a toy decode LM (`precision.calibrate`), assign
per-layer (r_in, r_w) under the named quality budgets
(`precision.assign`), bind one block stack per operating point over the
same weights (`CIMDecodeLM.toy(points=)`) and serve requests tagged with
their points in flight.  Every (point, bucket extent) is warmed up first;
`--assert-no-recompile` then fails on any plan, capture or (on the card)
eager dispatch, and every request's tokens must equal its solo decode.
The projected TOPS/W it prints are the IMAGINE macro model's
(`perfmodel`), not measurements of the device it runs on.

`--engine-devices D` (with `--cim-mode engine`) shards every engine-mode
projection's macro schedule across D devices (`runtime.engine.
ShardingConfig`): the first D cards, and a raise when fewer are visible,
as the JAX launcher's D real devices.  `build(args, sharding=)` takes a
ShardingConfig instead, so a caller can fold the D partitions onto one
device (`ShardingConfig(devices=D, fold_onto="cuda")`); the token stream
equals the unsharded serve's bit for bit either way.

The decoder-stack families serve: dense, moe (every expert bank through
one program per GEMM shape, bound once per expert, `models/moe.py`) and
vlm, whose static batch carries a seeded (batch, vision_tokens, d_model)
prefix of patch embeddings drawn as the JAX launcher draws it
(`make_prefix`; the KV cache holds the prefix too).  `--inflight`
serves dense and moe, as the JAX launcher does.  In-flight MoE is not
bit-equal to solo decoding in either package: the expert groups mix the
requests' tokens, and the expert programs take no segments.  The ssm
(mamba2) and hybrid (recurrentgemma) families serve static batches: the
cache holds their recurrent states (and the hybrid's local-attention
rings), the prefill runs the recurrences from the zero state, and each
decode step is the O(1) update.  The audio family (whisper-medium)
serves static batches as the JAX launcher does: the encoder runs once,
at the prefill, over seeded (batch, max_len, d_model) frame embeddings
drawn as JAX draws them (`make_frames`), the prompt is cut to its first
token, and each decode step reads the cross-attention K/V the prefill
wrote into the cache.  `--inflight` refuses the ssm, hybrid and audio
families, as the JAX launcher does.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import mapping
from repro_torch.core import noise_model as nm
from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.runtime import engine as rt_engine
from repro_torch.runtime import program as rt_program
from repro_torch.runtime import tracing


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--cim-mode", default="bypass",
                    choices=["bypass", "fakequant", "engine"])
    ap.add_argument("--engine-devices", type=int, default=0,
                    help="shard the engine-mode macro schedule across this "
                         "many devices (0 = no sharding; engine mode only)")
    ap.add_argument("--engine-axis", default="macro",
                    help="mesh axis name for the sharded engine dispatch")
    ap.add_argument("--assert-no-recompile", action="store_true",
                    help="fail if any decode step after the first re-plans "
                         "or captures (or, on the card, dispatches "
                         "eagerly)")
    ap.add_argument("--inflight", action="store_true",
                    help="continuous in-flight batching over a slot-mapped "
                         "KV cache: --batch slots, requests admit/retire "
                         "between fused decode steps")
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests for --inflight (default 2x slots)")
    ap.add_argument("--precision-policy", default="off",
                    choices=["off", "mixed", "quality", "balanced",
                             "throughput"],
                    help="workload-adaptive precision serving: calibrate, "
                         "assign per-layer precisions under the named "
                         "budget(s) and serve mixed operating points in "
                         "flight (needs --cim-mode engine --inflight)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def build(args, sharding: Optional[rt_engine.ShardingConfig] = None,
          n_layers: Optional[int] = None):
    """(cfg, params, device) for the parsed arguments: the config of
    --arch with the launcher's CIMConfig (max_gamma 2^16, rows isolated
    under --inflight, and the engine's sharding) and seeded random
    weights on the device.  `n_layers` cuts the config's depth before the
    weights are drawn (a published config too deep for one card; an
    audio model's encoder is cut to as many layers).

    `sharding` defaults to --engine-devices D on the first D devices
    (ValueError, naming the devices, when fewer are visible); a given
    ShardingConfig (a folded one, say) is taken as it is.  Either needs
    --cim-mode engine."""
    if sharding is None and args.engine_devices:
        sharding = rt_engine.ShardingConfig(devices=args.engine_devices,
                                            axis=args.engine_axis)
    if sharding is not None and args.cim_mode != "engine":
        raise ValueError("--engine-devices requires --cim-mode engine")
    dev = resolve_device(args.device)
    if sharding is not None:
        # the placement of every projection's partitions, checked before
        # the weights are drawn
        from repro_torch.launch.mesh import make_engine_mesh
        make_engine_mesh(sharding.resolve_devices(), sharding.axis,
                         device=dev, fold_onto=sharding.fold_onto)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers,
                          encoder_layers=min(cfg.encoder_layers, n_layers))
    cfg = cfg.replace(cim=CIMConfig(mode=args.cim_mode, max_gamma=2.0**16,
                                    sharding=sharding,
                                    isolate_rows=args.inflight))
    params = tf.init_params(cfg,
                            torch.Generator(device=dev).manual_seed(args.seed))
    return cfg, params, dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def counters() -> Dict[str, int]:
    """The counters the no-recompile contract reads: plans, captures,
    weight binds (`program.bound_for`; an MoE bank binds once an expert)
    and the programs' eager dispatches."""
    return {"plans": rt_engine.PLAN_COUNT["n"],
            "captures": rt_engine.CAPTURE_COUNT["n"],
            "binds": rt_program.bound_cache_stats()["binds"],
            "eager_calls": rt_program.dispatch_stats()["eager_calls"]}


def _growth(before: Dict[str, int], dev: torch.device) -> Dict[str, int]:
    """Counter growth since `before`; eager dispatches count on the card
    only (on the host every dispatch is eager)."""
    now = counters()
    out = {k: now[k] - before[k] for k in ("plans", "captures", "binds")}
    if dev.type == "cuda":
        out["eager_calls"] = now["eager_calls"] - before["eager_calls"]
    return out


INFLIGHT_FAMILIES = ("dense", "moe")


@torch.no_grad()
def static_serve(cfg, params, prompt: torch.Tensor, gen_len: int, *,
                 max_len: int, keep_logits: bool = False,
                 prefix: Optional[torch.Tensor] = None,
                 frames: Optional[torch.Tensor] = None) -> Dict:
    """Static-batch greedy serving: prefill `prompt` (B, P) into a fresh
    KV cache for the first token, then `gen_len` decode steps.  A vlm
    model's `prefix` (B, V, D) patch embeddings go before the prompt
    (`max_len` must hold both); an audio model's `frames` (B, max_len,
    D) run through its encoder at the prefill.

    Returns {"tokens" (B, 1 + gen_len) on the host, "cache", "prefill_s", "warm_s"
    (the first decode step), "decode_s" and "steps" (the rest), "growth"
    (counter growth over the steps after the first), "logits" (with
    keep_logits: the prefill's last-position logits and each decode
    step's, on the device)}.  Host seconds end in a sync."""
    dev = prompt.device
    cache = tf.init_cache(cfg, prompt.shape[0], max_len=max_len, device=dev)
    t0 = time.perf_counter()
    logits, cache, _ = tf.forward(cfg, params, prompt, cache=cache,
                                  prefix_embeds=prefix,
                                  encoder_frames=frames)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    out = {"prefill_s": time.perf_counter() - t0, "warm_s": 0.0,
           "decode_s": 0.0, "steps": 0, "growth": {}}
    kept = [logits[:, -1]] if keep_logits else None
    serve_step = make_serve_step(cfg)
    toks = [tok]

    def step(tok, cache):
        if keep_logits:
            lg, cache, _ = tf.forward(cfg, params, tok, cache=cache)
            kept.append(lg[:, -1])
            return torch.argmax(lg[:, -1:], dim=-1), cache
        return serve_step(params, cache, tok)

    # warm-up decode step: plans and, on the card, captures the decode
    # programs' graphs, which the remaining steps replay
    if gen_len > 0:
        t0 = time.perf_counter()
        tok, cache = step(tok, cache)
        toks.append(tok)
        _sync(dev)
        out["warm_s"] = time.perf_counter() - t0
    before = counters()
    steps = max(gen_len - 1, 0)
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, cache = step(tok, cache)
        toks.append(tok)
    gen = torch.cat(toks, dim=1).cpu()
    out.update(decode_s=time.perf_counter() - t0, steps=steps,
               growth=_growth(before, dev), tokens=gen, cache=cache)
    if keep_logits:
        out["logits"] = kept
    return out


def make_prompt(vocab: int, batch: int, prompt_len: int, seed: int,
                device) -> torch.Tensor:
    """The static batch's prompt: (batch, prompt_len) token ids, uniform
    over the vocabulary, from a generator on `device` at `seed`."""
    return torch.randint(
        0, vocab, (batch, prompt_len),
        generator=torch.Generator(device=device).manual_seed(seed),
        device=device)


def make_prefix(cfg, batch: int, seed: int, device) -> torch.Tensor:
    """A vlm model's stub vision input, as the JAX launcher draws it:
    jax.random.normal(PRNGKey(seed), (batch, vision_tokens, d_model)),
    bit for bit, drawn on `device` (the draw kernel on the card)."""
    return nm.draw_normal(prng.key(seed),
                          (batch, cfg.vision_tokens, cfg.d_model),
                          torch.device(device))


def make_frames(cfg, batch: int, max_len: int, seed: int,
                device) -> torch.Tensor:
    """An audio model's stub encoder input, as the JAX launcher draws it:
    jax.random.normal(PRNGKey(seed), (batch, max_len, d_model)), bit for
    bit, drawn on `device` (the draw kernel on the card)."""
    return nm.draw_normal(prng.key(seed), (batch, max_len, cfg.d_model),
                          torch.device(device))


def serve_max_len(cfg, prompt_len: int, gen_len: int) -> int:
    """The KV cache length of a serve: prompt, generation, 8 spare and a
    vlm model's prefix.  (The JAX launcher leaves the prefix out; at
    internvl2's 256 prefix tokens its prefill then exceeds the ring, which
    a multi-token write into the cache must not.)"""
    return prompt_len + gen_len + 8 + (
        cfg.vision_tokens if cfg.family == "vlm" else 0)


def make_requests(vocab: int, n_req: int, prompt_len: int, gen_len: int,
                  seed: int) -> List[Dict]:
    """The JAX launcher's in-flight workload: fixed-length prompts, ragged
    generation budgets in [1, gen_len] and arrivals in [0, gen_len), from
    numpy's generator at `seed`, sorted by arrival."""
    rng = np.random.default_rng(seed)
    reqs = [{"uid": u,
             "prompt": rng.integers(0, vocab, size=prompt_len),
             "gen": int(rng.integers(1, gen_len + 1)),
             "arrival": int(rng.integers(0, gen_len))}
            for u in range(n_req)]
    reqs.sort(key=lambda r: r["arrival"])
    return reqs


@torch.no_grad()
def inflight_serve(cfg, params, reqs: List[Dict], slots: int, *,
                   max_len: int, device) -> Dict:
    """Continuous-batching greedy decode: each admitted request is
    prefilled alone into a batch-1 cache and copied into the lowest free
    slot of a slot-mapped cache; every clock tick with live requests runs
    one fused single-token step over all slots at their own positions;
    a request retires when its budget is spent.

    Returns {"tokens": {uid: [token, ...]}, "slot": {uid: slot},
    "latency": {uid: finish - arrival, in clock ticks}, "decode_steps",
    "decode_s" (host seconds of the fused steps, each ending in the
    tokens' copy to the host), "wall_s", "growth" (counter growth after
    the first fused step)}.  The dense and moe families only (ValueError
    otherwise).

    Under a profiler each phase is a span (`runtime/tracing.py`): the
    call "serve.inflight"; per request "serve.admit" (its children
    "serve.prefill", ending in the first token on the host, and
    "serve.slot_write") and "serve.retire", all with the request's
    `uid`, so its host times are those spans'; per fused step
    "serve.decode_step" (`live` and `slots`) over "serve.enqueue" (the
    forward's launches), "serve.readback" (the wait for the tokens) and
    "serve.tokens_out" (tokens back to the slots, retirements)."""
    if cfg.family not in INFLIGHT_FAMILIES:
        raise ValueError(f"in-flight serving takes the {INFLIGHT_FAMILIES} "
                         f"families, not {cfg.family!r}")
    with tracing.span("serve.inflight", slots=slots):
        return _inflight(cfg, params, reqs, slots, max_len,
                         torch.device(device))


def _inflight(cfg, params, reqs, slots, max_len, dev) -> Dict:
    """The loop of `inflight_serve`, inside its root span."""
    from repro_torch.runtime.scheduler import SlotMap
    span = tracing.span
    cache = tf.init_slot_cache(cfg, slots, max_len, device=dev)

    def prefill(r):
        with span("serve.prefill", uid=r["uid"],
                  prompt_len=len(r["prompt"])):
            c1 = tf.init_cache(cfg, 1, max_len=max_len, device=dev)
            toks = torch.as_tensor(np.asarray(r["prompt"]),
                                   dtype=torch.long, device=dev)[None]
            logits, c1, _ = tf.forward(cfg, params, toks, cache=c1)
            return c1, int(torch.argmax(logits[0, -1]))

    smap = SlotMap(slots)
    live, done, queue = {}, [], list(reqs)
    tokens, slot_of, latency = {}, {}, {}
    cur = torch.zeros((slots,), dtype=torch.long, device=dev)
    clock, steps, before, t_decode = 0, 0, None, 0.0
    t_start = time.perf_counter()

    def retire(s, r):
        nonlocal cache
        with span("serve.retire", uid=r["uid"]):
            smap.free(s)
            cache = tf.free_slot_cache(cache, s)
            latency[r["uid"]] = clock - r["arrival"]
            done.append(r)

    while queue or live:
        while queue and smap.n_free and queue[0]["arrival"] <= clock:
            r = queue.pop(0)
            s = smap.alloc()
            with span("serve.admit", uid=r["uid"], slot=s,
                      prompt_len=len(r["prompt"]), arrival=r["arrival"],
                      clock=clock):
                c1, tok = prefill(r)
                with span("serve.slot_write", uid=r["uid"], slot=s):
                    cache = tf.write_slot_cache(cache, s, c1)
                    cur[s] = tok
                tokens[r["uid"]], slot_of[r["uid"]] = [tok], s
                if len(tokens[r["uid"]]) >= r["gen"]:
                    retire(s, r)
                else:
                    live[s] = r
        if live:
            t0 = time.perf_counter()
            with span("serve.decode_step", live=len(live), slots=slots):
                with span("serve.enqueue"):
                    # explicit (B, 1) positions: every slot decodes at its
                    # own offset
                    pos = cache["pos"][:, None]
                    logits, cache, _ = tf.forward(cfg, params, cur[:, None],
                                                  positions=pos, cache=cache)
                with span("serve.readback"):
                    nxt = torch.argmax(logits[:, -1], dim=-1).cpu()
                t_decode += time.perf_counter() - t0
                steps += 1
                if before is None:          # post-warm-up baseline
                    before = counters()
                with span("serve.tokens_out"):
                    for s in sorted(live):
                        r = live[s]
                        tokens[r["uid"]].append(int(nxt[s]))
                        cur[s] = int(nxt[s])
                        if len(tokens[r["uid"]]) >= r["gen"]:
                            del live[s]
                            retire(s, r)
        clock += 1
    return {"tokens": tokens, "slot": slot_of, "latency": latency,
            "decode_steps": steps, "decode_s": t_decode,
            "wall_s": time.perf_counter() - t_start,
            "growth": {} if before is None else _growth(before, dev)}


def _check_growth(args, growth: Dict[str, int], what: str) -> None:
    print(f"decode recompiles after warmup: plans={growth.get('plans', 0)} "
          f"captures={growth.get('captures', 0)} "
          f"binds={growth.get('binds', 0)}"
          + (f" eager_calls={growth['eager_calls']}"
             if "eager_calls" in growth else ""))
    if args.assert_no_recompile and any(growth.values()):
        raise SystemExit(
            f"FAIL: {what} re-entered the planner, bound weights, captured "
            f"or ran eagerly after warmup ({growth}): the plan-once/"
            f"serve-many contract is broken")


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    ap = parser()
    args = ap.parse_args(argv)
    if args.precision_policy != "off":
        if args.cim_mode != "engine" or not args.inflight:
            ap.error("--precision-policy requires --cim-mode engine "
                     "--inflight")
        return _run_precision_inflight(args, resolve_device(args.device))
    if args.engine_devices and args.cim_mode != "engine":
        ap.error("--engine-devices requires --cim-mode engine")
    cfg, params, dev = build(args)
    max_len = serve_max_len(cfg, args.prompt_len, args.gen_len)
    if args.inflight:
        if cfg.family not in INFLIGHT_FAMILIES:
            ap.error(f"--inflight supports the {INFLIGHT_FAMILIES} "
                     f"families, not {cfg.family!r}")
        return _run_inflight(args, cfg, params, dev, max_len)
    prompt = make_prompt(cfg.vocab_size, args.batch, args.prompt_len,
                         args.seed, dev)
    prefix = (make_prefix(cfg, args.batch, args.seed, dev)
              if cfg.family == "vlm" else None)
    frames = None
    if cfg.family == "audio":
        frames = make_frames(cfg, args.batch, max_len, args.seed, dev)
        prompt = prompt[:, :1]
    out = static_serve(cfg, params, prompt, args.gen_len, max_len=max_len,
                       prefix=prefix, frames=frames)
    print(f"prefill({prompt.shape[1]} tokens): {out['prefill_s']:.2f}s")
    if out["steps"]:
        dt = out["decode_s"]
        print(f"decode {out['steps']} steps: {dt:.2f}s "
              f"({out['steps'] * args.batch / dt:.1f} tok/s, "
              f"{dt / out['steps'] * 1e3:.1f} ms/step; warmup "
              f"{out['warm_s']:.2f}s)")
    _check_growth(args, out["growth"], "the decode loop")
    if args.cim_mode == "engine":
        print(f"engine program cache: {rt_program.program_cache_stats()}; "
              f"binds: {rt_program.bound_cache_stats()}; dispatches: "
              f"{rt_program.dispatch_stats()}")
    print("sample:", out["tokens"][0].tolist())


def _run_inflight(args, cfg, params, dev, max_len: int) -> None:
    """The in-flight loop of `main`, with the JAX launcher's report:
    requests, tokens, fused steps, latency percentiles, tokens/s and the
    post-warm-up counters (`--assert-no-recompile` gates them)."""
    reqs = make_requests(cfg.vocab_size, args.requests or 2 * args.batch,
                         args.prompt_len, args.gen_len, args.seed)
    out = inflight_serve(cfg, params, reqs, args.batch, max_len=max_len,
                         device=dev)
    lat = np.asarray(list(out["latency"].values()), float)
    toks = sum(len(t) for t in out["tokens"].values())
    print(f"inflight: {len(out['tokens'])} requests, {toks} tokens, "
          f"{out['decode_steps']} fused steps over {args.batch} slots in "
          f"{out['wall_s']:.2f}s")
    print(f"latency steps p50/p99: {np.percentile(lat, 50):.1f}/"
          f"{np.percentile(lat, 99):.1f}"
          + (f"; decode {toks / out['decode_s']:.1f} tok/s"
             if out["decode_s"] else ""))
    if out["decode_steps"]:
        _check_growth(args, out["growth"], "the in-flight loop")
    print("sample:", out["tokens"][reqs[0]["uid"]])


# the precision demo's toy decode LM, the JAX launcher's sizes
PRECISION_DEMO = dict(d=48, depth=2, vocab=61, d_ff=96)


def precision_specs(d: int, d_ff: int, base=(8, 4), m: int = 8) -> tuple:
    """The four projections of one decode block, (qkv, o, gate_up, down),
    as independent LayerSpecs at the base point (the calibration's
    layers; `assign` returns one point for each, in this order)."""
    r = dict(r_in=base[0], r_w=base[1])
    return (mapping.LayerSpec(m=m, k=d, n=3 * d, **r),
            mapping.LayerSpec(m=m, k=d, n=d, **r),
            mapping.LayerSpec(m=m, k=d, n=2 * d_ff, **r),
            mapping.LayerSpec(m=m, k=d_ff, n=d, **r))


def warm_up_points(model, points, slots: int) -> None:
    """One decode step of `model` (a CIMDecodeLM) per operating point at
    every bucket extent an in-flight scheduler of `slots` slots can
    reach: the executables a served run then needs are all built (on the
    card, every projection's graph is captured)."""
    buckets = model.bound.program.buckets
    extents = sorted({min(buckets.bucket_for(x), slots)
                      for x in range(1, slots + 1)})
    state = model.init_state(slots)
    for name in points:
        for e in extents:
            rows = {k: a[:e] for k, a in state.items()}
            model.step_rows(rows, torch.zeros((e,), dtype=torch.long),
                            point=name)


def _run_precision_inflight(args, dev: torch.device) -> Dict:
    """Workload-adaptive precision serving demo: calibrate, plan the
    ladder, serve mixed per-request operating points in flight.

    (1) `precision.calibrate` profiles the toy decode LM's four
    projection GEMMs; (2) `precision.assign` turns quality budgets into
    per-layer (r_in, r_w) assignments; (3) `CIMDecodeLM.toy(points=...)`
    compiles and binds one block stack per operating point over the SAME
    weights; (4) the in-flight scheduler fuses same-point requests per
    decode step.  Then the serving contracts: every fused request equal
    to its solo decode at its point, no plan, capture or (on the card)
    eager dispatch after warm-up (under --assert-no-recompile), and the
    per-point projected TOPS/W next to the measured token counts.
    Returns the run's numbers (assignments, metrics, counter growth)."""
    from repro_torch.precision import DEFAULT_BUDGETS, assign, calibrate
    from repro_torch.runtime.scheduler import (CIMDecodeLM,
                                               InflightScheduler, Request,
                                               decode_sequential)
    d, depth, vocab, d_ff = (PRECISION_DEMO[k]
                             for k in ("d", "depth", "vocab", "d_ff"))
    base = (8, 4)
    specs = precision_specs(d, d_ff, base)
    t0 = time.perf_counter()
    prof = calibrate(specs, rt_engine.EngineConfig(), n_trials=2, batch=4,
                     seed=args.seed, label="serve-demo", device=dev)
    names = (["quality", "throughput"] if args.precision_policy == "mixed"
             else [args.precision_policy])
    points = {}
    for name in names:
        asg, delta = assign(prof, specs, DEFAULT_BUDGETS[name])
        points[name] = asg
        print(f"precision: point {name!r} -> "
              f"{[(ri, rw) for ri, rw in asg]} "
              f"(predicted quality delta {delta:.4f})")
    print(f"precision: profile + plan in {time.perf_counter() - t0:.1f}s")

    model = CIMDecodeLM.toy(torch.Generator().manual_seed(args.seed), d=d,
                            depth=depth, vocab=vocab, d_ff=d_ff,
                            r_in=base[0], r_w=base[1], points=points,
                            device=dev)
    rng = np.random.default_rng(args.seed)
    n_req = args.requests or 2 * args.batch
    gen_hi = max(args.gen_len, 2)
    reqs = [Request(uid=u,
                    prompt=tuple(int(t) for t in rng.integers(
                        0, vocab, size=max(args.prompt_len, 1))),
                    max_new_tokens=int(rng.integers(1, gen_hi + 1)),
                    point=names[u % len(names)])
            for u in range(n_req)]

    warm_up_points(model, names, args.batch)
    _sync(dev)
    before = counters()

    sched = InflightScheduler(model, capacity=args.batch)
    out = sched.run([(int(rng.integers(0, gen_hi)), r) for r in reqs])
    m = sched.metrics()
    growth = _growth(before, dev)

    bad = [r.uid for r in reqs if out[r.uid] != decode_sequential(model, r)]
    print(f"inflight: {int(m['requests'])} requests, "
          f"{int(m['tokens'])} tokens, {int(m['decode_steps'])} fused "
          f"steps over {args.batch} slots "
          f"({m['tokens_per_s']:.1f} tok/s decode)")
    tops_per_w = {}
    for name in names:
        op = sched.point_report(name)["operating_point"]
        tops_per_w[name] = op["tops_per_w"]
        toks = m["tokens_by_point"].get(name, 0.0)
        print(f"point {name!r}: {int(toks)} tokens served, projected "
              f"{op['tops_per_w']:.2f} TOPS/W (macro model)")
    print(f"engine program cache: {rt_program.program_cache_stats()}")
    print("per-request bit-exactness vs solo decode: "
          + ("PASS" if not bad else f"FAIL {bad}"))
    if bad:
        raise SystemExit("FAIL: fused decode diverged from solo decode "
                         f"for uids {bad}")
    _check_growth(args, growth, "precision serving")
    return {"points": points, "metrics": m, "growth": growth,
            "tops_per_w": tops_per_w, "streams": out}


if __name__ == "__main__":
    main()
