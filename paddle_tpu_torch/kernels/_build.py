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
SOURCES = ("flash_fwd", "flash_bwd", "flash_decode", "flash_decode_paged",
           "fused_resnet", "fused_conv3x3", "fused_norm", "fused_adamw",
           "fused_ce", "row_gemm")

# held across every stale check, build and load: engines stepping on
# several threads (an in-process fleet, a relaunched replica warming up)
# may ask for the same library at once, and must not build it twice or
# see a half-declared one. A launch of a library already in _LIBS never
# takes it (a dict read is atomic), so a build never stalls a launch.
_LOCK = threading.RLock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# libraries nvcc built in this process: the serving engine's goodput
# ledger charges a dispatch to `compile` when this moved during it (the
# eager port's counterpart of the reference's retrace census)
_builds_seen = 0


def build_count() -> int:
    """Monotonic count of the kernel libraries this process built."""
    return _builds_seen


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
    global _builds_seen
    with _LOCK:
        todo = [n for n in names if force or _stale(n)]
        t0 = time.perf_counter()
        procs = {n: _start(n) for n in todo}
        report = {}
        try:
            for n, proc in procs.items():
                report[n] = {"log": _finish(n, proc),
                             "seconds": time.perf_counter() - t0}
                _builds_seen += 1
        finally:
            for proc in procs.values():   # a failed build stops the rest
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
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)     # another thread may have loaded it
        if lib is not None:
            return lib
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, (restype, argtypes) in (signatures or {}).items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = list(argtypes)
        _LIBS[name] = lib
        return lib


def raise_on(err: int, what: str):
    """Raise when a C entry point returned a CUDA error (a launch the
    card refused never runs, and no later synchronize reports it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
