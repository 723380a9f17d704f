"""Build the port's CUDA kernels from the package's sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (loaded with ``ctypes``; no PyTorch
headers, so a build takes seconds). The library name carries a hash of
the source, every header of ``csrc/`` (``*.cuh``, which sources share) and
the flags, so an edited source or header rebuilds, and lands in
``build/blendjax_torch_kernels/`` beside the package (listed in
``.gitignore``). :func:`build` compiles every missing library at once,
one ``nvcc`` process per source (:mod:`blendjax_torch.libbuild`). Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

from blendjax_torch import libbuild
from blendjax_torch.libbuild import entry

__all__ = ["SOURCES", "build", "entry", "library_path", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "blendjax_torch_kernels"
)
SOURCES = ("decode_spatial", "decode_scatter", "gamma_normalize",
           "flash_attention", "flash_fwd_sm90", "flash_bwd_sm90")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (on PATH or under $CUDA_HOME/bin): the CUDA "
            "toolkit is needed to build blendjax_torch's kernels"
        )
    return path


def library_path(name: str) -> Path:
    return libbuild.library_path(CSRC / f"{name}.cu", BUILD_DIR,
                                 ("nvcc", *NVCC_FLAGS),
                                 sorted(CSRC.glob("*.cuh")))


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes started together. Returns ``{name: compiler
    output}`` (``-Xptxas -v`` register and shared-memory report), or
    ``"cached"`` for a library that already existed."""
    missing = [n for n in names if not library_path(n).exists()]
    command = (nvcc_path(), *NVCC_FLAGS) if missing else ()
    return libbuild.build({
        n: (command, CSRC / f"{n}.cu", library_path(n)) for n in names})


def load(name: str):
    """The loaded library of kernel source ``name``, built if needed."""

    def make():
        build((name,))
        return ctypes.CDLL(str(library_path(name)))

    return libbuild.load(_libs, _lock, name, make)
