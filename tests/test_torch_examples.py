"""The port's examples (`examples/torch_*.py`) against the JAX package's
(`examples/*.py`): at a tiny size on the CPU each prints the JAX
example's numbers at the same arguments, timings excluded.  No JAX
example is edited; `quickstart.py` runs through runpy, the others through
runpy with their arguments (or, where the size has no argument, a module
constant or the dataset's size set before the run, as each test says).

Held beyond the printed timings (tokens a second, seconds an epoch):

- quickstart: every number;
- noise sweep (BATCH 16, TRIALS 2, TRAIN_STEPS 4, set in both modules:
  `noise_sweep.py:25` has no argument for them): every number, the
  logit RMS deviation of the noisy rows within 1e-5 relative - the jitted
  JAX engine rewrites its own noise chain (ROADMAP reference fault 3);
- serve (`--batch 2 --gen-len 4`, the default granite-8b, both smoke
  configs in float32: in bfloat16 XLA's and PyTorch's float glue round a
  near tie apart, and JAX's engine is not its fakequant there, reference
  fault 5): every sample token, the program cache's programs, evictions
  and capacity; its lookups and hits differ by design - JAX looks up at
  each trace of its jitted decode step, the port at each call;
- LeNet (`--epochs 1 --batch 128`, the dataset cut to 256 / 128 images
  in both: `train_lenet_cim.py` has no argument for it): every number;
- fault-tolerant pretraining (`--steps 42 --d-model 32 --layers 1
  --seq-len 16 --batch 2`): every number, restarts 2.
"""
import ast
import contextlib
import importlib.util
import io
import os
import re
import runpy
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")
TIMINGS = (re.compile(r"\s*-?[\d.]+ tok/s"), re.compile(r"\(\d+s\)"))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module (test_torch_moe.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jax(name, argv=(), source_edit=None):
    """stdout of examples/<name> run as __main__ with `argv`; with
    `source_edit` (old, new) the script's text is run with that one line
    replaced (a module constant set before the run)."""
    path = os.path.join(EXAMPLES, name)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            if source_edit is None:
                runpy.run_path(path, run_name="__main__")
            else:
                src = open(path).read()
                assert source_edit[0] in src
                exec(compile(src.replace(*source_edit), path, "exec"),
                     {"__name__": "__main__", "__file__": path})
    finally:
        sys.argv = saved
    return buf.getvalue()


def _torch_module(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(EXAMPLES, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_torch(mod, argv=()):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main([*argv, "--device", "cpu"])
    return buf.getvalue(), out


def _parse(text):
    """(template, numbers) per line, timings dropped."""
    rows = []
    for line in text.splitlines():
        for pat in TIMINGS:
            line = pat.sub("<t>", line)
        rows.append((NUM.sub("#", line),
                     [float(x) for x in NUM.findall(line)]))
    return rows


def _same(jax_text, torch_text, close=lambda template, i: False,
          skip=lambda template: False):
    """Every line's text and numbers equal; `close(template, i)` marks a
    number held within 1e-5 relative, `skip(template)` a line compared
    apart."""
    a, b = _parse(jax_text), _parse(torch_text)
    assert [t for t, _ in a] == [t for t, _ in b], (jax_text, torch_text)
    for (t, x), (_, y) in zip(a, b):
        if skip(t):
            continue
        for i, (u, v) in enumerate(zip(x, y)):
            if close(t, i):
                assert abs(u - v) <= 1e-5 * abs(u), (t, x, y)
            else:
                assert u == v, (t, x, y)


def test_quickstart_prints_jax_numbers():
    want = _run_jax("quickstart.py")
    got, out = _run_torch(_torch_module("torch_quickstart.py"))
    _same(want, got)
    assert out["rel_abn"] < out["rel_unity"]
    assert all(r["exact"] for r in out["engine"].values())


def test_noise_sweep_prints_jax_numbers():
    const = ("BATCH, TRIALS, TRAIN_STEPS = 64, 8, 120",
             "BATCH, TRIALS, TRAIN_STEPS = 16, 2, 4")
    want = _run_jax("noise_sweep.py", source_edit=const)
    mod = _torch_module("torch_noise_sweep.py")
    mod.BATCH, mod.TRIALS, mod.TRAIN_STEPS = 16, 2, 4
    got, out = _run_torch(mod)
    _same(want, got, close=lambda t, i: t.startswith("  x") and i == 3)
    assert len(out["rows"]) == len(mod.SCALES)


def test_serve_prints_jax_samples():
    import repro.configs as jconfigs
    from repro.runtime import clear_program_cache as jclear
    from repro_torch.runtime import clear_program_cache
    argv = ["--batch", "2", "--gen-len", "4"]
    jclear()            # each package's cache holds this run's programs
    clear_program_cache()
    orig = jconfigs.get_smoke_config
    jconfigs.get_smoke_config = lambda a: orig(a).replace(dtype="float32")
    try:
        want = _run_jax("serve_llm_cim.py", argv)
    finally:
        jconfigs.get_smoke_config = orig
    mod = _torch_module("torch_serve_llm_cim.py")
    torig = mod.get_smoke_config
    mod.get_smoke_config = lambda a: torig(a).replace(dtype="float32")
    got, out = _run_torch(mod, argv)
    cache = "engine program cache:"
    _same(want, got, skip=lambda t: t.startswith(cache))
    stats = [ast.literal_eval(line.split(cache)[1].strip())
             for line in (want.splitlines()[-1], got.splitlines()[-1])]
    for k in ("programs_built", "programs", "evictions", "capacity"):
        assert stats[0][k] == stats[1][k], (k, stats)
    assert torch.equal(out["engine"][0], out["fakequant"][0])


def test_train_lenet_prints_jax_numbers():
    import repro.data.pseudo_mnist as jdata
    argv = ["--epochs", "1", "--batch", "128"]
    orig = jdata.make_dataset
    jdata.make_dataset = lambda n_train, n_test: orig(n_train=256,
                                                      n_test=128)
    try:
        want = _run_jax("train_lenet_cim.py", argv)
    finally:
        jdata.make_dataset = orig
    mod = _torch_module("torch_train_lenet_cim.py")
    torig = mod.make_dataset
    mod.make_dataset = lambda n_train, n_test: torig(n_train=256,
                                                     n_test=128)
    got, out = _run_torch(mod, argv)
    _same(want, got)
    assert len(out["losses"]) == 2


def test_fault_tolerant_pretrain_prints_jax_numbers(tmp_path):
    argv = ["--steps", "42", "--d-model", "32", "--layers", "1",
            "--seq-len", "16", "--batch", "2"]
    want = _run_jax("fault_tolerant_pretrain.py",
                    argv + ["--ckpt-dir", str(tmp_path / "jax")])
    got, out = _run_torch(_torch_module("torch_fault_tolerant_pretrain.py"),
                          argv + ["--ckpt-dir", str(tmp_path / "torch")])
    _same(want, got)
    assert out["restarts"] == 2 and out["last"] < out["first"]


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_noise_sweep.py",
                                  "torch_serve_llm_cim.py",
                                  "torch_train_lenet_cim.py",
                                  "torch_fault_tolerant_pretrain.py"])
def test_example_runs_on_the_card_by_default(name):
    """Without --device an example asks for CUDA: on a host without a
    card it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    mod = _torch_module(name)
    if hasattr(mod, "BATCH"):
        mod.BATCH, mod.TRIALS, mod.TRAIN_STEPS = 16, 2, 1
    argv = (["--steps", "3", "--d-model", "16", "--layers", "1",
             "--seq-len", "8", "--batch", "2"]
            if name == "torch_fault_tolerant_pretrain.py" else [])
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(argv)
