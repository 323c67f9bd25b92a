"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one `.cu` source with a plain C interface.  At first use it
is compiled for Hopper (`sm_90a`) into `kernels/_build/` (which
`.gitignore` lists), under a name that carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.  A
failed build raises; nothing falls back.

    lib = build.load("cim_mbiw")      # builds on first use, then cached
    infos = build.build_all()         # every kernel, one nvcc each, in parallel
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

# kernel name -> its CUDA source
SOURCES: Dict[str, Path] = {
    "cim_mbiw": _HERE / "cim_mbiw" / "csrc" / "cim_mbiw.cu",
    "cim_mbiw_tc": _HERE / "cim_mbiw" / "csrc" / "cim_mbiw_tc.cu",
    "cim_mbiw_splitk": _HERE / "cim_mbiw" / "csrc" / "cim_mbiw_splitk.cu",
    "ring_decode": _HERE / "flash_attn" / "csrc" / "ring_decode.cu",
    "flash_fwd": _HERE / "flash_attn" / "csrc" / "flash_fwd.cu",
    "flash_bwd": _HERE / "flash_attn" / "csrc" / "flash_bwd.cu",
    "flash_fwd_tc": _HERE / "flash_attn" / "csrc" / "flash_fwd_tc.cu",
    "flash_bwd_dkv_tc":
        _HERE / "flash_attn" / "csrc" / "flash_bwd_dkv_tc.cu",
    "flash_bwd_dq_tc": _HERE / "flash_attn" / "csrc" / "flash_bwd_dq_tc.cu",
    "threefry_normal": _HERE / "prng" / "csrc" / "threefry_normal.cu",
}

# no --use_fast_math: the ADC epilogue and the softmaxes rely on IEEE
# rounding intrinsics and the accurate expf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """One kernel library: where it is, how long nvcc took (0.0 when an
    earlier build was reused) and what nvcc printed (ptxas register and
    shared-memory use)."""
    name: str
    path: Path
    seconds: float
    log: str


_LOCK = threading.Lock()
_BUILT: Dict[str, BuildInfo] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc as PyTorch resolves it."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    # the source and every kernel header (a source may include another
    # kernel's header, as cim_mbiw_tc.cu includes flash_tc.cuh; a header
    # edit rebuilds)
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(_HERE.glob("*/csrc/*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None, *,
              force: bool = False) -> Dict[str, BuildInfo]:
    """Compile the named kernels (all by default), one nvcc process per
    source, all started together.  Reuses an existing library for an
    unchanged source unless `force`.  Raises RuntimeError, with nvcc's
    output, when any build fails."""
    names = list(SOURCES if names is None else names)
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {}
        for name in names:
            path = _lib_path(name)
            if path.exists() and not force:
                _BUILT.setdefault(name, BuildInfo(name, path, 0.0, ""))
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            todo[name] = (proc, path, tmp, time.perf_counter())
        failed = []
        for name, (proc, path, tmp, t0) in todo.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, path)
            _BUILT[name] = BuildInfo(name, path, secs, log)
            _LIBS.pop(name, None)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {name: _BUILT[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        info = _BUILT.get(name) or build_all([name])[name]
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(info.path)))
    return lib
