"""The port's dry run (`repro_torch/launch/dryrun.py`,
`launch/trace_analysis.py`, `kernels/costs.py`) against the JAX package's
(`repro/launch/dryrun.py`, `launch/hlo_analysis.py`).

What is held, and to what:

- `flops` of the meta-device walk == `hlo_analysis.analyze(jax.jit(step)
  .lower(...).compile().as_text())["hlo_flops"]` exactly, on one CPU
  device with no mesh: olmo_1b's smoke config, prefill and decode, in
  bypass; the moe, ssm, hybrid, vlm and audio families' smoke configs at
  prefill; train under remat ("full" and "dots") and in fakequant.  The
  difference is zero there.  One difference is named: with
  `attn_impl="pallas"` the port counts the flash kernels' function over
  the pairs the causal mask keeps (`costs.flash`), while JAX's
  interpret-mode Pallas grid runs a dot over every (q block, k block)
  pair, so the port's count is the smaller;
- `argument_size_in_bytes` on the single (16 x 16) and multi (2 x 16 x
  16) meshes == the same sum on JAX's `jax.eval_shape` tree under JAX's
  `param_specs` / `batch_specs` on `tests/test_specs.py`'s FakeMesh: each
  leaf's bytes over the product of the axes its spec names;
- a full-size mixtral-8x22b train_4k walk makes no tensor off `meta`;
- every arch x shape at smoke widths walks to ok (bypass and fakequant),
  and a full-size walk of the deploy prefill errors with JAX's KeyError
  (its params are deploy-quantized for decode only, as JAX's run_cell);
- each kernel's meta route returns its result's shapes on `meta`, counts
  no launch and records one op of its cost formula; the formulas equal
  hand counts at `PERF.md` §6's shapes (flash at D 128, bf16, B 2, H 16,
  S 4096, causal; the (4, 2) LeNet forward's `cim_mbiw` calls at batch
  256, 0.0087 ms of bytes);
- the CLI writes an ok JSON for one cell.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.core.cim_layers import CIMConfig as JCIM
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro.launch.steps import (init_train_state, make_prefill_step,
                                make_serve_step, make_train_step)
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdam
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.kernels import costs
from repro_torch.launch import dryrun, trace_analysis

SMOKE_S, SMOKE_B = 64, 2


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module (test_torch_moe.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, mode="bypass", attn="jnp", remat=None):
    kw = dict(attn_impl=attn)
    if remat is not None:
        kw.update(remat=True, remat_policy=remat)
    return (jget_smoke(arch).replace(cim=JCIM(mode=mode, max_gamma=2.0**16),
                                     **kw),
            get_smoke_config(arch).replace(
                cim=CIMConfig(mode=mode, max_gamma=2.0**16), **kw))


def _jax_flops(jc, kind):
    inputs = jspecs.input_specs(jc, JShape("s", SMOKE_S, SMOKE_B, kind))
    if kind == "train":
        state = jax.eval_shape(lambda: init_train_state(
            jc, jax.random.PRNGKey(0)))
        low = jax.jit(make_train_step(jc, JAdam())).lower(state, inputs)
    else:
        params = jax.eval_shape(lambda: jtf.init_params(
            jc, jax.random.PRNGKey(0)))
        if kind == "prefill":
            low = jax.jit(make_prefill_step(jc)).lower(params, inputs)
        else:
            low = jax.jit(make_serve_step(jc)).lower(
                params, inputs["cache"], inputs["tokens"])
    return hlo_analysis.analyze(low.compile().as_text())["hlo_flops"]


def _port_walk(tc, kind):
    fn, args = dryrun.build_cell(tc, ShapeConfig("s", SMOKE_S, SMOKE_B,
                                                 kind))
    return trace_analysis.analyze(fn, args)


@pytest.mark.parametrize("arch,kind,mode,remat", [
    ("olmo_1b", "prefill", "bypass", None),
    ("olmo_1b", "decode", "bypass", None),
    ("phi35_moe", "prefill", "bypass", None),
    ("mamba2_1_3b", "prefill", "bypass", None),
    ("recurrentgemma_2b", "prefill", "bypass", None),
    ("internvl2_76b", "prefill", "bypass", None),
    ("whisper_medium", "prefill", "bypass", None),
    ("olmo_1b", "train", "bypass", "full"),
    ("phi35_moe", "train", "bypass", "dots"),
    ("olmo_1b", "prefill", "fakequant", None),
])
def test_flops_equal_jax_hlo_flops(arch, kind, mode, remat):
    jc, tc = _configs(arch, mode, remat=remat)
    walk = _port_walk(tc, kind)
    assert walk["flops"] == _jax_flops(jc, kind)
    assert walk["off_meta"] == 0 and walk["kernels"] == {}


def test_flash_counts_the_kept_pairs_where_jax_counts_every_block():
    """The one named difference: under attn_impl "pallas" each flash call
    counts its function over the causal mask's kept pairs."""
    jc, tc = _configs("olmo_1b", attn="pallas")
    walk = _port_walk(tc, "prefill")
    plain = _port_walk(_configs("olmo_1b")[1], "prefill")["flops"]
    jax_flops = _jax_flops(jc, "prefill")
    assert jax_flops == plain            # JAX's grid: every block pair
    fwd = walk["kernels"]["flash_fwd"]
    assert fwd["calls"] == tc.n_layers
    h, d = tc.n_heads, tc.resolved_head_dim
    kept = SMOKE_S * (SMOKE_S + 1) // 2
    assert fwd["ops"] == tc.n_layers * 4.0 * d * SMOKE_B * h * kept
    # the plain attention's two products over every pair, less the
    # kernel's over the kept ones
    full = tc.n_layers * 4.0 * d * SMOKE_B * h * SMOKE_S * SMOKE_S
    assert walk["flops"] == plain - full + fwd["ops"] < jax_flops


class FakeMesh:
    """tests/test_specs.py's mesh stand-in: axis names and sizes."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _jax_bytes(tree, spec, sizes):
    leaves = jax.tree.leaves(tree)
    specs_ = jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(specs_)
    total = 0
    for leaf, sp in zip(leaves, specs_):
        parts = 1
        for e in sp:
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                parts *= sizes[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // parts
    return total


@pytest.mark.parametrize("arch", ["olmo_1b", "mixtral_8x22b",
                                  "whisper_medium", "mamba2_1_3b",
                                  "recurrentgemma_2b", "internvl2_76b"])
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_per_device_argument_bytes_equal_jax_specs(arch, mesh_kind):
    mesh = dryrun.PRODUCTION_MESHES[mesh_kind]
    fake = FakeMesh(mesh.axis_names, mesh.shape)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    jc = jget_config(arch).replace(cim=JCIM(mode="bypass",
                                            max_gamma=2.0**16))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        inputs = jspecs.input_specs(jc, JSHAPES[shape])
        want = _jax_bytes(inputs, jspecs.batch_specs(inputs, fake), sizes)
        if JSHAPES[shape].kind == "train":
            st = jax.eval_shape(lambda: init_train_state(
                jc, jax.random.PRNGKey(0)))
            ps = jspecs.param_specs(st["params"], fake)
            want += _jax_bytes(st, {"params": ps, "opt": {
                "m": ps, "v": ps, "step": JP()}}, sizes)
        else:
            pa = jax.eval_shape(lambda: jtf.init_params(
                jc, jax.random.PRNGKey(0)))
            want += _jax_bytes(pa, jspecs.param_specs(pa, fake), sizes)
        _, args = dryrun.build_cell(dryrun.cell_config(arch), SHAPES[shape])
        assert dryrun.argument_bytes_per_device(args, mesh) == want, shape


def test_full_size_mixtral_train_walk_stays_on_meta():
    r = dryrun.run_cell("mixtral_8x22b", "train_4k", "card", out_dir=None)
    assert r["status"] == "ok", r.get("error")
    assert r["off_meta"] == 0
    assert r["collectives"] is None and "SPMD" in r["note"]
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] > 1e12 and not r["fits_card"]
    assert mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]


@pytest.mark.parametrize("mode", ["bypass", "fakequant"])
def test_every_cell_walks_at_smoke_widths(mode):
    """Each arch x shape at its smoke config, the shapes cut to batch 2 x
    64 positions, walks to ok on meta tensors."""
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).replace(
            cim=CIMConfig(mode=mode, max_gamma=2.0**16))
        for name, shape in SHAPES.items():
            cut = dataclasses.replace(shape, seq_len=SMOKE_S,
                                      global_batch=SMOKE_B)
            r = dryrun.analyze_cell(cfg, cut)
            assert r["off_meta"] == 0, (arch, name)
            assert r["flops"] > 0 and r["memory"]["temp_size_in_bytes"] > 0


def test_skipped_and_deploy_cells_as_jax_records_them():
    r = dryrun.run_cell("olmo-1b", "long_500k", out_dir=None)
    assert r["status"] == "skipped" and "500k" in r["reason"]
    r = dryrun.run_cell("olmo-1b", "prefill_32k", cim_mode="deploy",
                        out_dir=None)
    assert r["status"] == "error" and "KeyError" in r["error"] \
        and "w_q" in r["error"]
    r = dryrun.run_cell("olmo-1b", "decode_32k", cim_mode="deploy",
                        out_dir=None)
    assert r["status"] == "ok"


# ---- the kernels on the meta device ---------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_meta_routes_record_one_op_each():
    from repro_torch.kernels.cim_mbiw.kernel import cim_mbiw_matmul_planes
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.prng.kernel import threefry_normal
    seen = []
    counts = (cim_mbiw_matmul_planes.launches, fk.flash_fwd.launches,
              fk.flash_bwd_dq.launches, fk.flash_bwd_dkv.launches,
              fk.ring_decode.launches, threefry_normal.launches)
    costs.add_listener(lambda n, c: seen.append((n, c)))
    try:
        y = cim_mbiw_matmul_planes(
            _meta(300, 2 * 144, dtype=torch.int8),
            _meta(144, 64, dtype=torch.int8), _meta(1, 64), _meta(1, 64),
            plane_shift=4, g0=1.0, r_out=8)
        assert (y.device.type, y.dtype, tuple(y.shape)) == (
            "meta", torch.int32, (300, 64))
        q = _meta(2, 4, 96, 64, dtype=torch.bfloat16)
        k = _meta(2, 2, 96, 64, dtype=torch.bfloat16)
        off = fk.offset_tensor(0, "meta")
        o, lse = fk.flash_fwd(q, k, k, off, causal=True)
        assert tuple(o.shape) == (2, 4, 96, 64) and o.dtype == torch.bfloat16
        assert tuple(lse.shape) == (2, 4, 96)
        dq = fk.flash_bwd_dq(q, k, k, q, _meta(2, 4, 96), _meta(2, 4, 96),
                             off, causal=True)
        dk, dv = fk.flash_bwd_dkv(q, k, k, q, _meta(2, 4, 96),
                                  _meta(2, 4, 96), off, causal=True)
        assert dq.dtype == dk.dtype == torch.float32
        assert tuple(dk.shape) == tuple(dv.shape) == (2, 4, 96, 64)
        r = fk.ring_decode(_meta(3, 4, 64), _meta(3, 200, 4, 64),
                           _meta(3, 200, 4, 64), _meta(3, 200))
        assert tuple(r.shape) == (3, 4, 64)
        z = threefry_normal(_meta(5, 2, dtype=torch.int64), 1000)
        assert tuple(z.shape) == (5, 1000)
        with pytest.raises(ValueError, match="offset"):
            fk.flash_fwd(q, k, k, torch.zeros((1, 1), dtype=torch.int32,
                                               device="meta"), causal=True)
    finally:
        costs._LISTENERS.clear()
    assert counts == (cim_mbiw_matmul_planes.launches, fk.flash_fwd.launches,
                      fk.flash_bwd_dq.launches, fk.flash_bwd_dkv.launches,
                      fk.ring_decode.launches, threefry_normal.launches)
    assert [n for n, _ in seen] == ["cim_mbiw", "flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv", "ring_decode",
                                    "threefry_normal"]
    want = [costs.cim_mbiw(300, 144, 64, 2, False),
            costs.flash("fwd", 2, 4, 2, 96, 96, 64, True, 0, 2),
            costs.flash("dq", 2, 4, 2, 96, 96, 64, True, 0, 2),
            costs.flash("dkv", 2, 4, 2, 96, 96, 64, True, 0, 2),
            costs.ring_decode(3, 200, 4, 64),
            costs.threefry_normal(5, 1000)]
    assert [c for _, c in seen] == want


def test_flash_cost_is_perf_md_hand_count():
    """PERF.md §6 rows 3-5: B 2, H 16, S 4096, D 128, causal, bf16."""
    b, h, s, d = 2, 16, 4096, 128
    pairs = b * h * s * (s + 1) // 2
    qkv = b * h * s * d
    fwd = costs.flash("fwd", b, h, h, s, s, d, True, 0, 2)
    assert fwd == costs.Cost(4.0 * d * pairs, 2 * 4 * qkv + 4 * b * h * s,
                             "bf16")
    dq = costs.flash("dq", b, h, h, s, s, d, True, 0, 2)
    assert dq.ops == 6.0 * d * pairs
    assert dq.bytes == 2 * 4 * qkv + 8 * b * h * s + 4 * qkv
    dkv = costs.flash("dkv", b, h, h, s, s, d, True, 0, 2)
    assert dkv.ops == 8.0 * d * pairs
    assert dkv.bytes == 2 * 4 * qkv + 8 * b * h * s + 8 * qkv
    # PERF.md's bounds: 0.1390 / 0.2085 / 0.2780 ms, operations
    for cost, ms in ((fwd, 0.1390), (dq, 0.2085), (dkv, 0.2780)):
        got, by = costs.bound_ms(cost)
        assert by == "operations" and round(got, 4) == ms
    # recurrentgemma's D 256, window 2048 (rows 3b-5b): 0.0652 ms forward
    w = costs.flash("fwd", 1, 10, 1, 4096, 4096, 256, True, 2048, 2)
    kept = sum(min(i, 2047) + 1 for i in range(4096))
    assert w.ops == 4.0 * 256 * 10 * kept
    assert round(costs.bound_ms(w)[0], 4) == 0.0652


def test_cim_mbiw_cost_is_the_lenet_hand_count():
    """PERF.md §6 row 1: a (4, 2) LeNet forward at batch 256 - conv1 (M
    256 x 784, K 9, N 16), conv2 (M 256 x 196, K 144, N 32), fc1 in two
    784-row tiles (N 128), fc2 (K 128, N 10), one nibble plane each:
    29.2 MB, 0.0087 ms of bytes."""
    calls = [(256 * 784, 9, 16), (256 * 196, 144, 32), (256, 784, 128),
             (256, 784, 128), (256, 128, 10)]
    total = costs.Cost(0.0, 0.0, "int8")
    for m, k, n in calls:
        c = costs.cim_mbiw(m, k, n, 1, False)
        assert c.ops == 2.0 * m * n * k
        assert c.bytes == m * k + k * n + 8 * n + 4 * m * n
        total = costs.Cost(total.ops + c.ops, total.bytes + c.bytes, "int8")
    assert total.bytes == 29215072
    ms, by = costs.bound_ms(total)
    assert by == "bytes" and round(ms, 4) == 0.0087
    assert math.isclose(costs.ring_decode(4, 2048, 16, 128).bytes,
                        4 * (2 * 4 * 2048 * 16 * 128 + 2 * 4 * 16 * 128
                             + 4 * 2048))


def test_cli_writes_an_ok_json(tmp_path):
    rs = dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                      "--out", str(tmp_path)])
    assert [r["status"] for r in rs] == ["ok"]
    r = json.load(open(tmp_path / "olmo_1b_decode_32k_card.json"))
    assert r["status"] == "ok" and r["arch"] == "olmo-1b"
    assert r["flops"] == rs[0]["flops"] and r["collectives"] is None
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes"):
        assert r["memory"][k] > 0
    assert set(dryrun.PRETTY) <= set(ARCH_IDS)
