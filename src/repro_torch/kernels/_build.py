"""Build, load and count the package's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of the source, the shared headers and the flags (an edited source
or header builds anew; an unchanged one is reused), and loaded with
``ctypes``.  Nothing here runs
at import time: a CPU-only host imports every module and never builds.

:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them together.  :func:`load` builds one library on demand, under a
lock, since native workers launch kernels from several threads.  Both
take the sources from ``csrc/`` unless given another directory (an
earlier commit's sources, to time old against new kernels in one
process: :func:`swapped` puts such a library under a wrapper).

Every kernel wrapper owns a :class:`LaunchCounter` and adds one to it
each time it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import contextlib
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
# after the source, so the linker keeps it: the CUDA library of the card's
# installation, for the tensor maps that TMA copies read
LINK_FLAGS = ("-lcuda",)

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


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where library ``name`` is built from the sources in ``csrc``:
    named by a hash of its source, every shared header there (a source
    may include any of them, so an edited header builds anew) and the
    flags."""
    digest = hashlib.sha256((csrc / _DECLARED[name][0]).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None, csrc: Path = CSRC) -> dict[str, Path]:
    """Compile every named library that is not built yet from the
    sources in ``csrc``, one ``nvcc`` per source, all running at once.  Returns each library's path;
    raises with the compiler's output if any build fails.  The
    compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``."""
    names = list(_DECLARED) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, csrc) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(csrc / _DECLARED[n][0]), *LINK_FLAGS]
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
            lib = open_library(name, build_all([name])[name])
            _LIBS[name] = lib
    return lib


def open_library(name: str, path: Path) -> ctypes.CDLL:
    """Load a built library of kernel ``name`` with its entry points'
    argtypes declared (an earlier commit's build may lack an entry point
    declared since; it is left out)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _DECLARED[name][1].items():
        if not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL):
    """Within the block, kernel ``name``'s wrapper launches ``lib``,
    another build of the same entry points (see :func:`open_library`)."""
    own = load(name)
    _LIBS[name] = lib
    try:
        yield
    finally:
        _LIBS[name] = own


def strided(t, inner: int):
    """``t`` (B, S, heads, inner) as the kernels read it: unit feature
    stride and a head stride of ``inner``, batch and sequence strides
    free (a slice of a packed projection goes in without a copy), with
    the base pointer and both free strides 16-byte aligned, since the
    kernels stage rows with 16-byte asynchronous copies; otherwise a
    contiguous copy in a fresh (aligned) allocation.  Rows whose width
    is no multiple of 16 bytes cannot be aligned by a copy; the SSD
    kernel stages those without 16-byte copies."""
    if (t.stride(3) == 1 and (t.shape[2] == 1 or t.stride(2) == inner)
            and t.data_ptr() % 16 == 0
            and all((s * t.element_size()) % 16 == 0 for s in outer(t))):
        return t
    copy = t.contiguous()
    return copy if copy.data_ptr() % 16 == 0 else copy.clone()


def outer(t) -> tuple[int, int]:
    """The batch and sequence strides of ``t`` as the kernels take them:
    0 along a dimension of size 1, which is never stepped (PyTorch leaves
    such a stride free, even in a contiguous tensor)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in (0, 1))


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would record a call of kernel ``what``: its
    output would carry no ``grad_fn``, and every parameter upstream of
    it would silently miss its share of the gradient.  A kernel with a
    backward runs under a ``torch.autograd.Function`` (flash attention's
    in ``flash_vjp``, SSD's and WKV6's beside their wrappers), whose
    forward autograd does not record."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward on the card: call it under "
            "torch.no_grad() or on tensors that need no gradient")
