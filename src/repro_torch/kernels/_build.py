"""Build the port's CUDA kernel with ``nvcc`` at first use, load with ctypes.

``csrc/p2h_sweep.cu`` has a plain C interface and is compiled into
``build/kernels/libp2h_sweep-<hash>.so`` under the checkout (a directory
``.gitignore`` lists).  The hash covers the source and the compiler flags,
so an edited kernel or a changed flag is rebuilt and a stale library is
never loaded.

Nothing here runs at import: a host without ``nvcc`` imports this module and
only fails if the kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load", "library_path"]

_SRC = Path(__file__).resolve().parent / "csrc" / "p2h_sweep.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc", path=os.pathsep.join(
        [os.environ.get("PATH", ""), "/usr/local/cuda/bin"]))
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernel is built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update("\0".join(_FLAGS).encode())
    return _BUILD_DIR / f"libp2h_sweep-{digest.hexdigest()[:12]}.so"


def build(*, force: bool = False) -> str:
    """Compile the library if it is missing (always with ``force``); returns
    ptxas' report (registers, shared memory, spills), empty if nothing was
    built.  Raises ``RuntimeError`` with the compiler's output on failure.
    """
    out = library_path()
    if out.exists() and not force:
        return ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return "\n".join(line for line in proc.stdout.splitlines()
                     if "ptxas" in line or "spill" in line)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing."""
    global _LIB
    if _LIB is None:
        build()
        _LIB = ctypes.CDLL(str(library_path()))
    return _LIB
