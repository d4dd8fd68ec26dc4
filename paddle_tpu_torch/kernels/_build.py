"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface, ``build/kernels/<name>.so`` at the repository
root, on first use (and again whenever a source is newer than the
library), and loads with ``ctypes``. The C entry points take raw device
pointers, strides, ints and the caller's stream, and return
``cudaGetLastError()``.

Nothing is built when this module is imported: the CPU-only test runs
import every module and have no nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel library, by source name
SOURCES = ("flash_fwd", "flash_bwd", "flash_decode")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def _stale(name: str) -> bool:
    lib = _library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _library_path(name))   # atomic: no half-written .so
    return out


def build_all(names: Iterable[str] = SOURCES,
              force: bool = False) -> Dict[str, dict]:
    """Build every stale library at once, one nvcc process per source,
    all started together. Returns ``{name: {"seconds", "log"}}`` for
    the ones built (``log`` holds ptxas's register and shared-memory
    report). A library this process has already loaded stays loaded:
    build before the first launch."""
    todo = [n for n in names if force or _stale(n)]
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in todo}
    report = {}
    try:
        for n, proc in procs.items():
            report[n] = {"log": _finish(n, proc),
                         "seconds": time.perf_counter() - t0}
    finally:
        for proc in procs.values():   # a failed build stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return report


def library(name: str, signatures: Optional[Dict[str, tuple]] = None
            ) -> ctypes.CDLL:
    """The loaded library ``name``, built first when stale. Every
    function in ``signatures`` (``{fn: (restype, argtypes)}``) gets its
    ctypes types declared, so pointers and 64-bit strides are never cut
    to 32-bit ints."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all([name])
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, (restype, argtypes) in (signatures or {}).items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = list(argtypes)
    with _LOCK:
        _LIBS[name] = lib
    return lib
