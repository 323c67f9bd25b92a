"""A CPU smoke of every cell in a fresh process, after which no module
whose top-level name (compared whole) is JAX's or the JAX package's is
loaded; and, on a card, one short run of a cell through the command."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

SMOKE = """
import sys, json
sys.path[:0] = ['.', 'src']
import torch
torch.set_num_threads(2)
from bench.tests.cpu import run_cpu, tiny_cell
from bench.tests.test_bench_control import TINY
from bench.harness import manifest, result
out = {}
for name, (conf, mix) in sorted(TINY.items()):
    cell = tiny_cell(name, conf, mix)
    ctx = run_cpu(cell, seed=2 ** 31 + 5)
    readers = {m['name']: manifest.metric_reader(m['name'])
               for m in cell.per_layer}
    res = result.assemble(ctx, readers, 'cpu', '')
    out[name] = [res['correct'], sorted(res['metrics'])]
import run
out['forbidden'] = run.forbidden_modules()
out['tops'] = sorted({m.split('.')[0] for m in sys.modules})
print(json.dumps(out))
"""


def test_cpu_smoke_of_every_cell_loads_no_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "bench")}
    out = subprocess.run([sys.executable, "-c", SMOKE], capture_output=True,
                         text=True, cwd=ROOT, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res.pop("forbidden") == []
    tops = res.pop("tops")
    assert "repro_torch" in tops
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in tops
    for name, (correct, _) in res.items():
        assert correct, name


def test_forbidden_names_compare_whole():
    sys.path.insert(0, str(ROOT / "bench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    names = ["repro_torch", "repro_torch.models", "jaxtyping", "reprox",
             "repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]
    assert run.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


@pytest.mark.gpu
def test_one_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "lenet5-4b2b-clean-b4096", "--seed", str(2 ** 31 + 9),
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) >= {"images_per_s", "setup_s"}
