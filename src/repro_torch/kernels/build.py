"""Builds the CUDA sources in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/repro_torch/`` at
the repository root (git-ignored).  A library is named by a hash of its
source, the shared headers and the flags, so an edited source is rebuilt
at its next use and an unchanged one is loaded as it is.  Nothing is
built when this module is imported: the first CUDA launch builds its own
library, and ``build_all`` builds every source at once, one nvcc process
each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the port's CUDA kernels are built at first use "
                           "and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library built from the current ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [sources()[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)         # atomic: a concurrent build loses nothing
    return log


def build_all() -> Dict[str, dict]:
    """Build every source that has no current library, one nvcc each, all
    in parallel.  Returns name -> {"seconds", "log"} (``log`` is nvcc's
    ptxas report: registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        t0 = time.perf_counter()
        procs = {}
        for name in sources():
            out = library_path(name)
            procs[name] = (out, None if out.exists() else _start(name, out))
        report = {}
        for name, (out, proc) in procs.items():
            log = "" if proc is None else _finish(name, out, proc)
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish(name, out, _start(name, out))
        lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
