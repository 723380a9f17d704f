"""Build shared libraries from the package's sources at first use.

The CUDA kernels (``kernels/build.py``, ``nvcc``) and the producers' host
C++ (``_native/build.py``, ``g++``) share these helpers. A library's name
carries a hash of its source, the headers it may include and the compile
command, so an edited source, header or flag rebuilds. Every compiler of a
:func:`build` call starts at once; each writes a temporary file that is
renamed into place, so processes that build at once (test workers,
producers) never load half a library. A missing or failing compiler
raises. Libraries load with ``ctypes``, and :func:`entry` sets a C
function's signature once per library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def library_path(source: Path, build_dir: Path, command, headers=()) -> Path:
    """Where the library of ``source`` compiled by ``command`` (the
    compiler and its flags) lives."""
    digest = hashlib.sha256(source.read_bytes())
    for header in headers:
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(command).encode())
    return build_dir / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def _name(source: Path) -> str:
    try:
        return str(source.relative_to(REPO))
    except ValueError:
        return str(source)


def build(jobs: dict) -> dict:
    """Compile each ``{name: (command, source, library)}`` whose library
    does not exist yet, every compiler started together. Returns ``{name:
    compiler output}``, or ``"cached"`` for a library that already
    existed. Raises ``RuntimeError`` with the compiler's output when a
    build fails or the compiler is missing."""
    logs, running = {}, {}
    try:
        for name, (command, source, so) in jobs.items():
            if so.exists():
                logs[name] = "cached"
                continue
            so.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=f"{so.name}.", suffix=".tmp",
                                       dir=so.parent)
            os.close(fd)
            running[name] = (None, tmp, so)
            try:
                proc = subprocess.Popen(
                    [*command, "-o", tmp, str(source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
            except OSError as e:
                raise RuntimeError(
                    f"cannot build {_name(source)} with {command[0]}: {e}"
                ) from e
            running[name] = (proc, tmp, so)
        for name, (proc, tmp, so) in running.items():
            out, _ = proc.communicate()
            if proc.returncode:
                command, source, _ = jobs[name]
                raise RuntimeError(
                    f"{os.path.basename(command[0])} failed for "
                    f"{_name(source)}:\n{out}")
            os.replace(tmp, so)  # atomic: a loader never sees half a file
            logs[name] = out
    finally:
        for proc, tmp, _ in running.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return logs


def load(cache: dict, lock, name: str, make) -> ctypes.CDLL:
    """``cache[name]``, made by ``make()`` (which builds and loads) under
    ``lock`` the first time; a library already loaded is returned without
    taking the lock."""
    lib = cache.get(name)
    if lib is not None:
        return lib
    with lock:
        lib = cache.get(name)
        if lib is None:
            lib = cache[name] = make()
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
