"""BENCHMARK.json against the benchmark's contract, and the files each
cell names, found by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench.harness import manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state_size|proj|"
                   r"head_dim|expan|_dim$|_rank$|per_tok)")


def test_manifest_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    cells = 2 + 14 * 24
    assert cells * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in METRICS:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = manifest.cell(name)
    assert cell.chips == 1
    assert hasattr(manifest.kind_module(cell.kind), "run")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert hasattr(manifest.metric_reader(m["name"]), "read")


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    used = {w["config"] for w in MAN["workloads"]}
    assert entry["name"] in used
    assert entry["file"].startswith("bench/")
    conf = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert conf["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert not WIDTH.search(key), key
        assert key in conf.get("published", {})


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """A cell, a traffic mix and a per-layer metric added as files (and
    entries in BENCHMARK.json) are found with no edit to any file."""
    shutil.copytree(manifest.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    first = man["workloads"][0]
    mix = json.loads((tmp_path / "bench" / "traffic"
                      / f"{first['traffic']}.json").read_text())
    mix["batch"] = 2048
    (tmp_path / "bench" / "traffic" / "new_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "batches.new.py").write_text(
        "def read(ctx):\n    return float(ctx.attempted)\n")
    man["workloads"].append({**first, "name": "new-cell",
                             "traffic": "new_mix"})
    man["per_layer"].append({"name": "batches.new", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "compiled program",
                             "moves": "setup_s",
                             "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell("new-cell", root=tmp_path)
    assert cell.traffic["batch"] == 2048
    assert "batches.new" in [m["name"] for m in cell.per_layer]
    reader = manifest.metric_reader("batches.new", root=tmp_path)

    class Ctx:
        attempted = 3
    assert reader.read(Ctx()) == 3.0
    assert "batches.new" not in [m["name"] for m in
                                 manifest.cell(first["name"],
                                               root=tmp_path).per_layer]


def test_missing_cell_raises():
    with pytest.raises(manifest.ManifestError):
        manifest.cell("no-such-cell")
