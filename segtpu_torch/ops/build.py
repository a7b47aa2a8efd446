"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``segtpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout. The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "segtpu_torch's kernels")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str, target: Path):
    """Start nvcc on ``<name>.cu``; returns (process, temporary output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), tmp


def _finish(name: str, target: Path, proc, tmp: Path) -> str:
    """Wait for one nvcc; install its output, or return its error."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}"
    os.replace(tmp, target)
    return ""


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """The kernel libraries ``names``. Those not built yet are built by one
    nvcc each, all started together."""
    with _lock:
        pending = [(name, _target(name)) for name in names if name not in _loaded]
        builds = [(name, target, *_start(name, target))
                  for name, target in pending if not target.exists()]
        errors = [e for e in (_finish(*build) for build in builds) if e]
        if errors:
            raise RuntimeError("\n".join(errors))
        for name, target in pending:
            _loaded[name] = ctypes.CDLL(str(target))
        return {name: _loaded[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    return load_all([name])[name]
