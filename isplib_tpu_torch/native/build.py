"""Build the port's graph builder, ``csrc/graphbuild.cpp``, at first use.

``g++ -O3 -fopenmp -shared -fPIC -std=c++17`` compiles it into
``isplib_tpu_torch/_build/graphbuild-<hash>.so``, by the rule of the CUDA
kernels (``kernels/build.py``): the hash covers the source and the flags, the
library replaces a temporary file atomically, and the compiler's output is
kept beside it as ``.log``.  A failed compile raises with that output.

The flags hold no ``-march=native``: a library built on one host could not
then be trusted on another, and the builder's loops are bound by memory.

    python -m isplib_tpu_torch.native.build     # build now, print the path
"""

from __future__ import annotations

import shutil
from pathlib import Path

from ..kernels import build as kbuild

__all__ = ["CXX", "CXX_FLAGS", "build", "lib_path"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "graphbuild.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


def lib_path() -> Path:
    """Where the library of the present source and flags is (or will be)."""
    return kbuild.BUILD_DIR / (
        f"graphbuild-{kbuild.sources_hash([SOURCE], CXX_FLAGS)}.so")


def build() -> Path:
    """The library's path, compiled first if it is missing."""
    lib = lib_path()
    if not lib.exists():
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(f"{CXX} not found: the port's graph builder "
                               "is compiled with a C++ compiler with OpenMP")
        kbuild.compile_libs([(lib, [cxx, *CXX_FLAGS, str(SOURCE)])])
    return lib


if __name__ == "__main__":
    print(build())
