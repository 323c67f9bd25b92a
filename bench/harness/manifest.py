"""BENCHMARK.json and the files it names, found by name.

A cell is an entry of `workloads`: a configuration (its `file`) under a
traffic mix (`bench/traffic/<traffic>.json`, whose `kind` names the
driver `bench/kinds/<kind>.py`).  A per-layer metric is read by
`bench/metrics/<name>.py`.  Adding a cell, a mix, a kind or a metric is
adding files; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


class ManifestError(ValueError):
    """BENCHMARK.json, or a file it names, is missing or malformed."""


def load(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ManifestError(f"cannot read {path}: {e}") from None


def _json(path: Path) -> Dict:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ManifestError(f"cannot read {path}: {e}") from None


def load_module(path: Path) -> ModuleType:
    """The module in `path`, loaded under a name of its own (metric
    files carry dots in their names, so they are not importable by
    name)."""
    if not path.is_file():
        raise ManifestError(f"missing {path}")
    name = "bench_file_" + "".join(c if c.isalnum() else "_"
                                   for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload with everything it names."""
    name: str
    chips: int
    config: Dict          # the configuration's file
    config_entry: Dict    # its BENCHMARK.json entry
    traffic: Dict         # the traffic mix's file
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _in_cell(metric: Dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is not None:
        return metric["moves"] in e2e_names
    return True


def cell(name: str, manifest: Optional[Dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest, with its files read."""
    man = load(root) if manifest is None else manifest
    work = {w["name"]: w for w in man.get("workloads", [])}
    if name not in work:
        raise ManifestError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have {sorted(work)})")
    w = work[name]
    confs = {c["name"]: c for c in man.get("configs", [])}
    if w["config"] not in confs:
        raise ManifestError(f"workload {name!r} names no known config "
                            f"{w['config']!r}")
    centry = confs[w["config"]]
    config = _json(root / centry["file"])
    traffic = _json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if _in_cell(m, name)]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if _in_cell(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                config_entry=centry, traffic=traffic, end_to_end=e2e,
                per_layer=per)


def kind_module(kind: str, root: Path = ROOT) -> ModuleType:
    """The driver of a traffic kind: `run(ctx)` fills the context."""
    return load_module(root / "bench" / "kinds" / f"{kind}.py")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of a per-layer metric: `read(ctx)` gives its value,
    or None where the run holds nothing to read."""
    return load_module(root / "bench" / "metrics" / f"{name}.py")
