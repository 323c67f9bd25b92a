"""The port stands alone: nothing in `repro_torch`, `chip_smoke.py` or the
port's examples (`examples/torch_*.py`) imports JAX or the JAX package
(`repro`), and importing the whole slice (and each example) leaves `jax`
out of `sys.modules`.  The modules of each slice are named
below, so that a module that moves cannot drop out of these checks."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# the port's examples: new files beside the JAX package's, never a file
# or folder named `torch` (on sys.path it would shadow the package)
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


# the training slice: configs, the CIM layer, the LM, optimizer, data,
# launcher and the flash kernels' wrappers
TRAIN_SLICE = [
    "configs/__init__.py", "configs/base.py", "configs/olmo_1b.py",
    "core/cim_layers.py", "core/noise_model.py", "core/quantization.py",
    "core/abn.py", "data/lm_data.py", "models/common.py",
    "models/transformer.py", "optim/__init__.py", "optim/adamw.py",
    "optim/schedules.py", "launch/__init__.py", "launch/steps.py",
    "launch/train.py", "kernels/flash_attn/kernel.py",
    "kernels/flash_attn/ops.py", "kernels/flash_attn/ref.py", "convert.py",
]


# the noise slice: the PRNG, XLA's float routines, the noise model and
# calibration, and the draw kernel's wrapper
NOISE_SLICE = [
    "core/prng.py", "core/xla_f32.py", "core/noise_model.py",
    "core/calibration.py", "kernels/prng/__init__.py",
    "kernels/prng/kernel.py", "kernels/prng/ref.py",
]


# the serving slice, beyond the training slice's modules (the CIM layer,
# the LM, the step builders and convert.py, named above): the programs
# the engine-mode layer binds, the engine, and the launcher
SERVE_SLICE = [
    "runtime/program.py", "runtime/engine.py", "launch/serve.py",
    "runtime/tracing.py",
]


# the precision slice: calibration, the planner and the macro perf model,
# and the scheduler that reports each point's projection
PRECISION_SLICE = [
    "precision/__init__.py", "precision/sensitivity.py",
    "precision/planner.py", "perfmodel/__init__.py",
    "perfmodel/macro_perf.py", "runtime/scheduler.py",
]


# the tuner slice: the cost model, search and cache, and the card's table
TUNER_SLICE = [
    "tuner/__init__.py", "tuner/cost.py", "tuner/search.py",
    "tuner/cache.py", "core/hw.py",
]


# the CNN training slice: the conv layer and sim mode, the behavioural
# macro, the ABN helpers, the models and data, and the dense configs
CNN_SLICE = [
    "core/cim_macro.py", "core/cim_layers.py", "core/digital_ref.py",
    "core/abn.py", "core/quantization.py", "core/xla_f32.py",
    "models/cnn.py", "data/pseudo_mnist.py", "optim/adamw.py",
    "configs/granite_8b.py", "configs/minitron_4b.py",
    "configs/qwen2_7b.py",
]


# the sharding slice: the shard partition, the meshes, the sharded engine,
# its programs, scheduler, layer, perf model, tuner and calibration key,
# the model-level helpers and the context-parallel flash entry
SHARDING_SLICE = [
    "core/mapping.py", "launch/mesh.py", "runtime/engine.py",
    "runtime/program.py", "runtime/scheduler.py", "core/cim_layers.py",
    "perfmodel/macro_perf.py", "tuner/cost.py", "tuner/search.py",
    "tuner/cache.py", "precision/sensitivity.py", "models/sharding.py",
    "kernels/flash_attn/ops.py", "models/common.py",
    "models/transformer.py", "launch/serve.py",
]


# the cimcheck slice: the analysis passes, the SASS pass, the CLI, and
# the engine's legacy entries and compile_program(verify=)
ANALYSIS_SLICE = [
    "analysis/__init__.py", "analysis/__main__.py", "analysis/findings.py",
    "analysis/plan_checks.py", "analysis/noise_keys.py",
    "analysis/recompile.py", "analysis/graph_walk.py",
    "analysis/barriers.py", "analysis/sass.py", "runtime/engine.py",
    "runtime/program.py", "core/quantization.py",
]


# the training-infrastructure slice: gradient compression, checkpoints,
# the fault-tolerant driver, elastic restore and the sharding specs
INFRA_SLICE = [
    "optim/compression.py", "checkpoint/__init__.py", "checkpoint/ckpt.py",
    "runtime/fault_tolerance.py", "runtime/elastic.py", "launch/specs.py",
    "runtime/__init__.py", "optim/__init__.py", "launch/train.py",
    "launch/steps.py", "launch/mesh.py", "convert.py",
]


# the last slice: the moe block's folded split, the dry run with its
# op-stream analysis and the kernels' cost table
DRYRUN_SLICE = [
    "models/moe.py", "launch/dryrun.py", "launch/trace_analysis.py",
    "kernels/costs.py", "configs/base.py",
]

EXAMPLE_NAMES = [
    "torch_quickstart.py", "torch_noise_sweep.py", "torch_serve_llm_cim.py",
    "torch_train_lenet_cim.py", "torch_fault_tolerant_pretrain.py",
]


@pytest.mark.parametrize("rel", TRAIN_SLICE + NOISE_SLICE + SERVE_SLICE
                         + PRECISION_SLICE + TUNER_SLICE + CNN_SLICE
                         + SHARDING_SLICE + ANALYSIS_SLICE + INFRA_SLICE
                         + DRYRUN_SLICE)
def test_train_slice_module_is_checked(rel):
    assert PORT / rel in FILES


@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_example_is_checked(name):
    assert ROOT / "examples" / name in FILES
    assert not (ROOT / "examples" / "torch").exists()
    assert not (ROOT / "examples" / "torch.py").exists()


def test_examples_import_without_jax():
    """Each example module loads (its main does not run) with JAX and the
    JAX package left out of sys.modules."""
    code = ("import importlib.util, sys\n"
            f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('ex', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(EXAMPLES) == len(EXAMPLE_NAMES)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_whole_slice_imports_without_jax():
    mods = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro was imported'\n"
            "print(len(%r))\n" % (mods,))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 40
