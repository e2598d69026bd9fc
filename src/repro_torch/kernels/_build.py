"""Build the port's CUDA kernels with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled into its own
``build/kernels/lib<name>-<hash>.so`` under the checkout (a directory
``.gitignore`` lists).  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited kernel or header or a
changed flag is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: a host without ``nvcc`` imports this module and
only fails if a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load", "library_path", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the kernels, by name: ``csrc/<name>.cu``
SOURCES = tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc", path=os.pathsep.join(
        [os.environ.get("PATH", ""), "/usr/local/cuda/bin"]))
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernel is built on a "
                           "machine with the CUDA toolkit")
    return path


def _source(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"no kernel source csrc/{name}.cu (have {SOURCES})")
    return _CSRC / f"{name}.cu"


def library_path(name: str = "p2h_sweep") -> Path:
    digest = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update("\0".join(_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None, *, force: bool = False) -> dict[str, str]:
    """Compile the libraries of ``names`` (default: every kernel) that are
    missing (all of them with ``force``), one ``nvcc`` per source, started
    together.  Returns ptxas' report (registers, shared memory, spills) per
    library built.  Raises ``RuntimeError`` with the compiler's output if
    any build fails.
    """
    names = SOURCES if names is None else tuple(names)
    todo = [n for n in names if force or not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".so.tmp{os.getpid()}")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *_FLAGS, "-o", str(tmp), str(_source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, library_path(name))  # atomic: loaders see all/none
        reports[name] = "\n".join(line for line in out.splitlines()
                                  if "ptxas" in line or "spill" in line)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str = "p2h_sweep") -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
