"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library at first
use, then loaded with ``ctypes``.  Libraries are named by a hash of
their sources, so an edited kernel is rebuilt and a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

SOURCES = {
    "nibble_matmul": "nibble_matmul.cu",
    "flash_attention": "flash_attention.cu",
    "paged_decode": "paged_decode.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "lut_matmul": "lut_matmul.cu",
    "attention_f32": "attention_f32.cu",
}
# every header a source includes: their bytes are part of each library's
# hash, so an edit to a header alone rebuilds the libraries
_HEADERS = ("attention_common.cuh", "mma_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}       # ptxas register/smem report per kernel


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source (None when its library already exists)."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: readers never see a partial file


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns the build logs."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return dict(build_logs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
