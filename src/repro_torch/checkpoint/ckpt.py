"""Atomic, asynchronous checkpoints of logical arrays.

Counterpart of `repro/checkpoint/ckpt.py`, with its on-disk format, so
either package restores the other's checkpoints:

  * every leaf of the tree is one `leaf_%05d.npy` in a step directory,
    beside `manifest.json` ({"step", "time", "extra", "leaves": [{"name",
    "file", "dtype", "shape"}]}); a leaf's name is its path, dict keys
    sorted and list indices as digits, joined by "/" (JAX's
    `tree_flatten_with_path` order); a None subtree holds no leaf;
  * a save writes `<dir>/step_%08d.tmp`, fsyncs the manifest and renames
    the directory into place, so a crash mid-save leaves the newest
    complete checkpoint as it was (`latest_step` skips `.tmp`);
  * the arrays are logical (the train launcher writes JAX's stacked
    layout, `convert.train_state_to_numpy`), so a restore onto another
    mesh is a reshard (`runtime/elastic.reshard_tree`);
  * `CheckpointManager` copies the tree to the host before `save`
    returns and hands the copy to a writer thread, whose error surfaces
    on the next `wait()`; it keeps the newest `keep` checkpoints.

The port's train step updates its tensors in place, so the copy is made
synchronously (no `non_blocking` copy) and is never a view of a tensor
the step will write: a CPU tensor is copied too.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """`fn(name, leaf)` on every leaf, in a tree of the same shape (dicts
    keep their keys, lists and tuples become lists, None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, tree[k], _join(prefix, k))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, t, _join(prefix, i))
                for i, t in enumerate(tree)]
    return fn(prefix, tree)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's order: dict keys sorted."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], _join(prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten_with_paths(t, _join(prefix, i))]
    return [(prefix, tree)]


def _to_host(leaf) -> np.ndarray:
    """A tensor's numpy copy (never sharing its memory, on the CPU too);
    any other leaf as a numpy array, as `np.asarray` gives it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def host_tree(tree) -> Any:
    """`tree` with every tensor leaf copied to a host numpy array (the
    device-to-host copies finish before this returns); numpy leaves pass
    through, as JAX's `device_get` passes them."""
    return _map_with_paths(lambda _, leaf: _to_host(leaf), tree)


def _like(arr: np.ndarray, template):
    """A stored array placed as the template leaf: a tensor template
    gives a new tensor on its device and of its dtype (a leaf that
    requires grad if the template does); any other leaf, the array."""
    if not isinstance(template, torch.Tensor):
        return arr
    t = torch.from_numpy(np.asarray(arr)).to(
        device=template.device, dtype=template.dtype, copy=True)
    return t.requires_grad_(template.requires_grad)


def place_like(tree, template) -> Any:
    """A host tree's arrays placed as `template`'s leaves (`_like`); the
    two trees have the same names."""
    stored = dict(_flatten_with_paths(tree))
    return _map_with_paths(lambda n, t: _like(stored[n], t), template)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Atomic synchronous save; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": []}
    for i, (name, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "dtype": str(arr.dtype),
             "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    """The newest step whose directory holds a manifest, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory) if os.path.exists(
        os.path.join(directory, f"step_{s:08d}", "manifest.json"))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template: Any,
                    step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of `template`: (tree, manifest).  A
    tensor leaf of the template comes back as a new tensor on its device
    and of its dtype, any other leaf as the stored numpy array (the
    logical layout: the caller reshards it).  Raises ValueError when the
    template's leaf names differ from the checkpoint's, FileNotFoundError
    without a checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    files = {e["name"]: e["file"] for e in manifest["leaves"]}
    names = [n for n, _ in _flatten_with_paths(template)]
    if set(names) != set(files):
        missing = set(names) - set(files)
        extra = set(files) - set(names)
        raise ValueError(f"checkpoint/template mismatch: missing={missing} "
                         f"unexpected={extra}")
    return _map_with_paths(lambda n, t: _like(
        np.load(os.path.join(path, files[n])), t), template), manifest


class CheckpointManager:
    """Async save + retention, mirroring a production manager's surface."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Copy `tree` to the host (done when this returns), then write it
        (on the writer thread when async)."""
        self.wait()
        host = host_tree(tree)
        if self.async_save:
            def work():
                try:
                    save_checkpoint(self.directory, step, host, extra)
                    self._gc()
                except BaseException as e:   # surfaced on next wait()
                    self._error = e
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, host, extra)
            self._gc()

    def wait(self):
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template: Any, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.directory, template, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
