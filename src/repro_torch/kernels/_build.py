"""Build, load and count the package's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of the source and the flags (an edited source builds anew; an
unchanged one is reused), and loaded with ``ctypes``.  Nothing here runs
at import time: a CPU-only host imports every module and never builds.

:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them together.  :func:`load` builds one library on demand, under a
lock, since native workers launch kernels from several threads.

Every kernel wrapper owns a :class:`LaunchCounter` and adds one to it
each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (source file name, {C function: ctypes argtypes})
_DECLARED: dict[str, tuple[str, dict]] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class LaunchCounter:
    """Plain-integer count of one kernel's launches, safe to bump from
    several threads."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0          # guarded-by: _lock

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def declare(name: str, source: str, functions: dict) -> None:
    """Register a kernel library: its source under ``csrc/`` and the
    argtypes of each C entry point (every entry point returns the
    ``cudaError_t`` of its launch as an int)."""
    _DECLARED[name] = (source, functions)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def library_path(name: str) -> Path:
    source = _DECLARED[name][0]
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc``
    per source, all running at once.  Returns each library's path;
    raises with the compiler's output if any build fails.  The
    compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``."""
    names = list(_DECLARED) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / _DECLARED[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _DECLARED[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def strided(t, inner: int):
    """``t`` (B, S, heads, inner) as the kernels read it: unit feature
    stride and a head stride of ``inner``, batch and sequence strides
    free (a slice of a packed projection goes in without a copy);
    otherwise a contiguous copy."""
    if t.stride(3) == 1 and (t.shape[2] == 1 or t.stride(2) == inner):
        return t
    return t.contiguous()


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
