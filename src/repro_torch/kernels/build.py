"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``). The library's file name carries a hash of the source,
of every header under ``csrc/`` and of the flags
(:func:`source_digest`), so an edited source or header is rebuilt and an
unchanged one is reused. Libraries of different names build in parallel
when they are loaded from several threads. Nothing here runs at import:
the CPU tests import every module, and a CPU-only PyTorch never reaches
``load_library``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BuiltLibrary", "load_library", "nvcc_path",
           "source_digest"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: nvcc flags of every kernel library: Hopper's sm_90a target, no fast
#: math, no fused multiply-add contraction (the folds must keep the
#: reference's float32 bits), and ptxas's register/spill report.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A compiled and loaded kernel library."""

    lib: ctypes.CDLL  # the loaded shared library
    path: Path        # where the library was built
    seconds: float    # nvcc wall time; 0.0 when an existing build was reused
    ptxas: str        # ptxas -v report of the build (registers, spills)


_LIBS: dict[str, BuiltLibrary] = {}
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _compile(source: Path, out: Path) -> tuple[float, str]:
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(source.parent), "-o", tmp,
           str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    report = proc.stdout + proc.stderr
    out.with_suffix(".ptxas.txt").write_text(report)
    os.replace(tmp, out)
    return seconds, report


def source_digest(source: Path) -> str:
    """SHA-256 over ``source``, every ``*.cuh`` header beside it (names
    and bytes, in name order) and :data:`NVCC_FLAGS`: what a build's
    output depends on. A header counts for every source, included or
    not."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load_library(name: str) -> BuiltLibrary:
    """Build (once per :func:`source_digest`) and load ``csrc/<name>.cu``.

    Thread-safe; calls for different names build concurrently."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        source = _CSRC / f"{name}.cu"
        out = _BUILD_DIR / f"lib{name}-{source_digest(source)[:16]}.so"
        if out.exists():
            seconds = 0.0
            log = out.with_suffix(".ptxas.txt")
            report = log.read_text() if log.exists() else ""
        else:
            seconds, report = _compile(source, out)
        built = BuiltLibrary(lib=ctypes.CDLL(str(out)), path=out,
                             seconds=seconds, ptxas=report)
        _LIBS[name] = built
        return built
