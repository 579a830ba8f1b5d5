"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``_build/lib<name>.so`` (a directory .gitignore lists) with a direct nvcc
call, and is rebuilt when its source or any ``csrc/*.cuh`` header (which
several sources include) is newer than the library. The
sources expose plain ``extern "C"`` launchers taking device pointers,
shapes and the CUDA stream, so nothing links against PyTorch's headers
and a build takes seconds. This mirrors how ``slideio/native.py`` builds
the slide reader. ``build_all`` runs one nvcc per source side by side.

A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME, else the toolkit's default
    install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; the CUDA kernels of "
            "hipt_abmil_atec23_tpu_torch need the CUDA toolkit to build")
    return path


def sources(name: str, csrc: str = CSRC_DIR) -> List[str]:
    """What lib<name>.so is built from: csrc/<name>.cu and every header in
    csrc/ (a source may include any of them)."""
    return [os.path.join(csrc, f"{name}.cu"),
            *sorted(glob.glob(os.path.join(csrc, "*.cuh")))]


def stale(so: str, deps: List[str]) -> bool:
    """True when the library is missing or older than one of its sources."""
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(os.path.getmtime(p) > built for p in deps)


def build(name: str) -> str:
    """Compile csrc/<name>.cu into _build/lib<name>.so if it is missing or
    older than its source or a csrc/ header; returns the library path.
    nvcc's report (registers, shared memory, spills per kernel) lands
    beside it in lib<name>.log."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not stale(so, sources(name)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + report)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{report}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def build_all(names) -> None:
    """Build several sources at once, one nvcc process each (a build of one
    source waits only on its own nvcc)."""
    with ThreadPoolExecutor(max(1, len(names))) as ex:
        list(ex.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The shared library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err_fn: str, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (it returns
    cudaGetLastError() after each launch)."""
    if err != 0:
        msg = getattr(lib, err_fn)(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({msg.decode() if msg else 'unknown'})")
