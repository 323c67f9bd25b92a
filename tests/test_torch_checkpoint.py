"""The port's checkpoints and fault-tolerant driver
(`repro_torch/checkpoint`, `repro_torch/runtime/fault_tolerance.py`) and
the train launcher's `--ckpt-dir`, against the JAX package's.

Every case of the JAX package's `tests/test_substrate.py` for them, over
trees of tensors: the round trip, atomicity, retention with async saves,
a wrong template raising, recovery from injected faults to the clean
run's state (restarts == 3) and straggler detection, with the driver's
clock replaced (no sleep).  Beyond them: the on-disk format crosses
between the packages both ways (a port launcher's checkpoint restored by
JAX's `load_checkpoint` with JAX's template, leaf for leaf equal to the
port's state; a JAX state restored by the port, equal to `convert`'s
result); a launcher run on the CPU with injected faults (noisy and
compressed, so each step's key and error buffer cross the restart)
ends bit-equal to the run without them; an elastic restore onto a mesh
folded at D 4 steps bit-equal to the unsharded state.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.launch import specs, train
from repro_torch.models.sharding import use_mesh
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import elastic
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (FTConfig, TrainDriver,
                                                 make_fault_injector)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module (test_torch_train.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)},
            "e": [torch.randn(3, generator=g), None]}


def _equal(a, b) -> bool:
    a = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.asarray(a))
    b = b.detach() if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    restored, manifest = load_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert restored["e"][1] is None
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert (a is None and b is None) or (_equal(a, b) and a is not b)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names == ["a", "b/c", "b/d", "e/0"]


def test_checkpoint_atomicity(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1))
    # a stale .tmp dir (crashed save) must be ignored
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree(2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_elastic_restore_different_template_fails(tmp_path):
    tree = _tree(3)
    save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"a": tree["a"]})


def test_async_save_copies_before_returning(tmp_path):
    """The port's steps write their tensors in place: what a save writes
    is the tree as it was when save returned, on the CPU too."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree(4)
    want = tree["a"].clone()
    mgr.save(1, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["a"], want)


def test_writer_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker), keep=2, async_save=True)
    mgr.save(1, _tree(5))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()      # raised once


def test_restore_places_leaves_as_the_template(tmp_path):
    """A tensor template leaf brings its dtype, device and requires_grad;
    a numpy template leaf gets the stored array."""
    tree = {"w": torch.ones(3, dtype=torch.float32),
            "n": np.arange(4, dtype=np.int64)}
    save_checkpoint(str(tmp_path), 2, tree)
    template = {"w": torch.zeros(3, dtype=torch.float64).requires_grad_(),
                "n": np.zeros(1)}
    restored, _ = load_checkpoint(str(tmp_path), template)
    assert restored["w"].dtype == torch.float64
    assert restored["w"].requires_grad and restored["w"].is_leaf
    assert isinstance(restored["n"], np.ndarray)
    np.testing.assert_array_equal(restored["n"], np.arange(4))


def test_fault_tolerant_driver_recovers(tmp_path):
    """Training with injected crashes completes and matches no-crash run."""
    def step_fn(state, batch):
        new = {"w": state["w"] + batch}
        return new, {"loss": float(new["w"].sum())}

    def batch_fn(step):
        return torch.tensor(float(step))

    init = {"w": torch.tensor(0.0)}
    cfg = FTConfig(ckpt_dir=str(tmp_path / "ft"), ckpt_every=3,
                   max_restarts=5)
    driver = TrainDriver(cfg, step_fn, batch_fn, state_template=init)
    state, hist = driver.run(init, 10,
                             fault_injector=make_fault_injector({5: 1, 8: 2}))
    assert driver.restarts == 3
    # deterministic data + restart-from-ckpt => same final state as clean run
    assert float(state["w"]) == sum(range(10))
    # steps 3 and 4 ran again after the fault at 5, 6 and 7 twice more
    assert [h.step for h in hist] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 6, 7,
                                      6, 7, 8, 9]
    assert float(init["w"]) == 0.0


def test_driver_refuses_past_max_restarts(tmp_path):
    cfg = FTConfig(ckpt_dir=str(tmp_path / "ft"), ckpt_every=2,
                   max_restarts=1)
    driver = TrainDriver(cfg, lambda s, b: (s, {}), lambda s: s,
                         state_template={})
    with pytest.raises(ft._InjectedFault):
        driver.run({}, 4, fault_injector=make_fault_injector({3: 2}))
    assert driver.restarts == 2


class FakeClock:
    """The driver's clock: monotonic() reads `now`, which each step
    advances by its own duration."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now


def test_straggler_detection(tmp_path, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(ft, "time", clock)

    def step_fn(state, batch):
        clock.now += 0.3 if int(batch) == 8 else 0.01
        return state, {"loss": 0.0}

    cfg = FTConfig(ckpt_dir=str(tmp_path / "st"), ckpt_every=100)
    driver = TrainDriver(cfg, step_fn, lambda s: s, state_template={})
    _, hist = driver.run({}, 10)
    assert [h.straggler for h in hist] == [False] * 8 + [True, False]
    assert hist[8].duration_s == pytest.approx(0.3)
    assert driver.heartbeat == clock.now


# -- the launcher, on the CPU at OLMo-1B's smoke config ----------------------

LAUNCH = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps", "6",
          "--seq-len", "16", "--batch", "2", "--cim-mode", "fakequant",
          "--attn-impl", "pallas", "--compress-grads"]


def _plain_run(argv):
    args = train.parser().parse_args(argv)
    _, state, step_fn, batch_fn = train.build(args)
    losses = []
    for s in range(args.steps):
        state, m = step_fn(state, batch_fn(s), train.step_key(args, s))
        losses.append(float(m["loss"]))
    return state, losses


def _state_bits_equal(a, b):
    la = tree_leaves(convert.train_state_to_numpy(a))
    lb = tree_leaves(convert.train_state_to_numpy(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(la, lb))


def test_launcher_fault_run_equals_clean_run(tmp_path):
    """--ckpt-dir --ckpt-every 2 with faults before steps 3 and 5: two
    restarts, steps 2 and 4 run again, and the final state (params, m, v,
    the error buffer, opt/step) and every loss equal the run without
    faults bit for bit.  Under --cim-noise, so a step run again draws
    under its own step's key."""
    argv = LAUNCH + ["--cim-noise", "--ckpt-dir", str(tmp_path / "ck"),
                     "--ckpt-every", "2"]
    clean, losses = _plain_run(argv)
    args = train.parser().parse_args(argv)
    _, state, step_fn, batch_fn = train.build(args)
    driver, run = train.make_driver(args, state, step_fn, batch_fn,
                                    make_fault_injector({3: 1, 5: 1}))
    final, hist = run()
    assert driver.restarts == 2
    assert [h.step for h in hist] == [0, 1, 2, 2, 3, 4, 4, 5]
    assert [h.loss for h in hist] == [losses[s] for s in
                                      (0, 1, 2, 2, 3, 4, 4, 5)]
    assert _state_bits_equal(final, clean)
    assert "err" in final and int(final["opt"]["step"]) == 6
    # restarts built new leaf tensors; the initial state is untouched
    assert all(p.requires_grad and p.is_leaf
               for p in tree_leaves(final["params"]))
    assert not any(p is q for p, q in zip(tree_leaves(final["params"]),
                                          tree_leaves(state["params"])))
    assert int(state["opt"]["step"]) == 0
    # FTConfig's keep of 3, as JAX's launcher leaves it
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    """A driver that gives up (more faults at step 3 than max_restarts)
    leaves its checkpoint at step 2; a new launcher run over the same
    directory resumes there and ends bit-equal to one uninterrupted
    run."""
    argv = LAUNCH + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                     "2"]
    clean, losses = _plain_run(argv)
    args = train.parser().parse_args(argv)
    _, state, step_fn, batch_fn = train.build(args)
    driver, run = train.make_driver(args, state, step_fn, batch_fn,
                                    make_fault_injector({3: 9}))
    with pytest.raises(ft._InjectedFault):
        run()
    assert driver.restarts == 4 and latest_step(args.ckpt_dir) == 2
    _, state, step_fn, batch_fn = train.build(args)
    driver, run = train.make_driver(args, state, step_fn, batch_fn)
    final, hist = run()
    assert [h.step for h in hist] == [2, 3, 4, 5]
    assert [h.loss for h in hist] == losses[2:]
    assert _state_bits_equal(final, clean) and driver.restarts == 0


def _jax_state_template():
    jcfg = jax_smoke("olmo_1b")
    return jax.eval_shape(lambda: jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0), compress_grads=True))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A checkpoint the port's launcher writes restores with the JAX
    package's load_checkpoint and JAX's template, leaf for leaf equal to
    the port's state (stacked as JAX stacks it)."""
    ck = str(tmp_path / "ck")
    args = train.parser().parse_args(LAUNCH + ["--steps", "2", "--ckpt-dir",
                                               ck, "--ckpt-every", "2"])
    _, state, step_fn, batch_fn = train.build(args)
    _, run = train.make_driver(args, state, step_fn, batch_fn)
    final, _ = run()
    template = _jax_state_template()
    restored, manifest = jax_load(ck, template)
    assert manifest["step"] == 2
    want = jax.tree_util.tree_flatten_with_path(
        convert.train_state_to_numpy(final))[0]
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    tmpl = jax.tree_util.tree_flatten_with_path(template)[0]
    assert [p for p, _ in got] == [p for p, _ in want] == [p for p, _ in tmpl]
    for (_, g), (_, w), (_, t) in zip(got, want, tmpl):
        assert g.dtype == w.dtype == t.dtype and g.shape == t.shape
        assert g.tobytes() == w.tobytes()
    assert len(got) == 89


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX train state saved by the JAX package restores in the port
    (the driver's template and from_host), equal to convert's result."""
    jstate = jsteps.init_train_state(jax_smoke("olmo_1b"),
                                     jax.random.PRNGKey(3),
                                     compress_grads=True)
    jstate["opt"]["step"] = jnp.int32(5)
    host = jax.tree.map(np.array, jstate)
    jax_save(str(tmp_path), 5, jstate)
    args = train.parser().parse_args(LAUNCH + ["--ckpt-dir", str(tmp_path)])
    _, state, step_fn, batch_fn = train.build(args)
    driver, _ = train.make_driver(args, state, step_fn, batch_fn)
    restored, step = driver.restore_or_init(state)
    assert step == 5
    assert _state_bits_equal(restored,
                             convert.train_state_from_numpy(host))
    assert int(restored["opt"]["step"]) == 5
    assert all(p.requires_grad for p in tree_leaves(restored["params"]))


def test_elastic_restore_onto_a_folded_mesh_steps_alike(tmp_path):
    """The newest checkpoint, resharded (param_specs / tree_shardings)
    onto a ("data", "model") mesh of D 4 folded onto the host, steps
    under use_mesh bit-equal to the same state stepped unsharded."""
    ck = str(tmp_path / "ck")
    args = train.parser().parse_args(LAUNCH + ["--steps", "2", "--ckpt-dir",
                                               ck, "--ckpt-every", "2"])
    _, state, step_fn, batch_fn = train.build(args)
    _, run = train.make_driver(args, state, step_fn, batch_fn)
    final, _ = run()
    shape, axes = elastic.choose_mesh_shape(4, tp=1)
    assert (shape, axes) == ((4, 1), ("data", "model"))
    mesh = elastic.make_mesh(shape, axes, fold_onto="cpu")
    logical = convert.train_state_to_numpy(final)
    host, manifest = load_checkpoint(ck, logical)
    pspec = specs.tree_shardings(specs.param_specs(host["params"], mesh),
                                 mesh)
    placements = {"params": pspec, "err": pspec,
                  "opt": {"m": pspec, "v": pspec,
                          "step": elastic.replicated(mesh)}}
    placed = elastic.reshard_tree(host, placements)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(placed))
    sharded = convert.train_state_from_numpy(placed)
    batch = batch_fn(int(manifest["step"]))
    with use_mesh(mesh):
        sharded, ms = step_fn(sharded, batch)
    final, mu = step_fn(final, batch)
    assert float(ms["loss"]) == float(mu["loss"])
    assert _state_bits_equal(sharded, final)
