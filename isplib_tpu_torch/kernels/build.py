"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/*.cu`` exposes a plain C interface and becomes its own shared
library, ``isplib_tpu_torch/_build/<name>-<hash>.so``, where the hash covers
every file of ``csrc/`` and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded.  All missing libraries are
compiled together, one ``nvcc`` process per source.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside each
library as ``<name>-<hash>.log``.  The port's C++ graph builder
(``isplib_tpu_torch/native/build.py``) is built by the same rule.

No PyTorch headers are compiled: ``nvcc`` takes seconds per file this way,
where ``torch.utils.cpp_extension.load`` takes minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "compile_libs", "load",
           "nvcc_path", "sources_hash"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def sources_hash(files, flags) -> str:
    """16 hex digits of a hash over the compiler flags and each file's name
    and bytes: a library named by it is rebuilt when either changes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(files):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def compile_libs(jobs) -> None:
    """Run the compiler command of each ``(library, command)`` job, all at
    once, with ``-o`` a temporary file that replaces the library when the
    command succeeds; keep each command's output beside its library as
    ``.log``.  Raises ``RuntimeError`` with the output of every command that
    failed."""
    procs = []
    for lib, cmd in jobs:
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((lib, tmp, cmd, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{lib.name} ({' '.join(cmd)}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("compiler failed:\n" + "\n".join(failed))


def _lib_path(name: str) -> Path:
    cu = [f for f in CSRC.iterdir() if f.suffix in (".cu", ".cuh")]
    return BUILD_DIR / f"{name}-{sources_hash(cu, NVCC_FLAGS)}.so"


def build_all() -> list[Path]:
    """Compile every source whose library is missing, all at once; return
    the libraries' paths."""
    todo = [(src, _lib_path(src.stem)) for src in sorted(CSRC.glob("*.cu"))]
    compile_libs([(lib, [nvcc_path(), *NVCC_FLAGS, str(src)])
                  for src, lib in todo if not lib.exists()])
    return [lib for _, lib in todo]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _lib_path(name)
    if not lib.exists():
        build_all()
    return ctypes.CDLL(str(lib))
