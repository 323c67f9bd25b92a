"""The plain reference against the port on the CPU at tiny sizes, and its
independence: it imports nothing of the port, of JAX or of the JAX
package."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.harness import inputs
from bench.reference import cim, lenet, olmo

REF = Path(__file__).resolve().parents[1] / "reference"
LENET = {"r_in": 4, "r_w": 2, "max_gamma": 32.0,
         "layers": [["conv1", 9, 16], ["conv2", 144, 32],
                    ["fc1", 1568, 128], ["fc2", 128, 10]]}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", sorted(REF.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] in ("__future__", "math", "dataclasses",
                                       "typing", "numpy", "torch",
                                       "bench"), n
            if n.startswith("bench"):
                assert n.startswith("bench.reference"), n


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "import bench.reference.lenet, bench.reference.olmo;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REF.parents[1], timeout=120)
    tops = out.stdout
    for bad in ("'repro_torch'", "'repro'", "'jax'"):
        assert bad not in tops


@pytest.mark.parametrize("r_in,r_w", [(4, 2), (8, 4), (2, 1)])
def test_projection_equals_the_engine(r_in, r_w):
    """One projection, K over two row tiles, whole-tensor and segmented
    swing, bit for bit against the port's engine on its plain kernel."""
    from repro_torch.core.mapping import LayerSpec
    from repro_torch.runtime import engine as rt
    from repro_torch.runtime.program import compile_program
    cfg = {"r_in": r_in, "r_w": r_w, "max_gamma": 64.0}
    p = inputs.cim_linear(inputs.generator(3, "cpu"), 1300, 40, cfg, "cpu")
    x = torch.randn((6, 1300), generator=torch.Generator().manual_seed(1))
    seg = torch.tensor([0, 0, 1, 1, 1, 2])
    prog = compile_program([LayerSpec(m=8, k=1300, n=40, r_in=r_in,
                                      r_w=r_w)],
                           rt.EngineConfig(max_gamma=64.0), device="cpu")
    bound = prog.bind([p])
    for s in (None, seg):
        want = bound.serve(x, segments=s)
        got = cim.projection(x, p["w"], p["abn_log_gamma"], p["abn_beta"],
                             r_in=r_in, r_w=r_w, max_gamma=64.0, segments=s)
        assert torch.equal(got, want)


def test_lenet_equals_the_program():
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.models import cnn
    params = inputs.lenet_weights(LENET, 4, "cpu")
    x = inputs.images(8, 4, "cpu")
    cimc = CIMConfig(mode="engine", r_in=4, r_w=2, max_gamma=32.0)
    want = cnn.lenet_program(8, cim=cimc, device="cpu").bind(
        [params[n] for n, _, _ in LENET["layers"]]).serve(x)
    got = lenet.forward(params, x, r_in=4, r_w=2, max_gamma=32.0)
    assert lenet.logit_gap(want, got) == 0.0


TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
        "vocab_size": 512, "rope_theta": 10000.0, "r_in": 8, "r_w": 4,
        "max_gamma": 65536.0}


def test_olmo_prefill_logits_agree_with_the_port():
    """The reference's forward over a prompt against the port's engine
    forward (one prefill, one swing), in float32 glue and bf16 storage:
    within bf16 rounding of the largest logit."""
    import importlib
    from bench.harness import manifest
    kind = manifest.kind_module("inflight_rounds")
    cfg = {**TINY, "arch": "olmo-1b", "dtype": "bfloat16"}
    mcfg = kind.model_config(cfg)
    params = inputs.olmo_weights(cfg, 3, "cpu")
    toks = torch.randint(0, 512, (1, 12),
                         generator=torch.Generator().manual_seed(2))
    tf = importlib.import_module("repro_torch.models.transformer")
    want, _, _ = tf.forward(mcfg, params, toks)
    got = olmo.logits(cfg, params, toks[0], 12)
    err = torch.max(torch.abs(want[0].float() - got))
    assert err <= 2 ** -6 * torch.max(torch.abs(got))
