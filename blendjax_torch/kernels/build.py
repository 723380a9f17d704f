"""Build the port's CUDA kernels from the package's sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (loaded with ``ctypes``; no PyTorch
headers, so a build takes seconds). The library name carries a hash of
the source, every header of ``csrc/`` (``*.cuh``, which sources share) and
the flags, so an edited source or header rebuilds, and lands in
``build/blendjax_torch_kernels/`` beside the package (listed in
``.gitignore``). :func:`build` compiles every missing library at once,
one ``nvcc`` process per source. Nothing here runs at import time.
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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes started together. Returns ``{name: compiler
    output}`` (``-Xptxas -v`` register and shared-memory report), or
    ``"cached"`` for a library that already existed."""
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            jobs[name] = None
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, so)
    logs = {}
    for name, job in jobs.items():
        if job is None:
            logs[name] = "cached"
            continue
        proc, tmp, so = job
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed. A
    library already loaded is returned without taking the lock."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def entry(lib, name: str, argtypes, restype=ctypes.c_int):
    """``lib``'s C function ``name`` with its ctypes signature, which is set
    on the first call for that library only."""
    bound = vars(lib).setdefault("_bjt_entries", {})
    fn = bound.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
        bound[name] = fn
    return fn
