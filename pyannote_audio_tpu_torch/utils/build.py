"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface; the host audio runtime,
``native/<name>.cc`` at the root of the checkout (the JAX package's C++
sources, read and never edited), is compiled by ``g++``. Both are loaded
with ``ctypes``. A library lands in ``_build/`` beside the sources
(git-ignored), named after a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is built once. Nothing is
built at import: the first call that needs a library builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
NATIVE_DIR = PACKAGE_DIR.parent / "native"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the default CUDA
    install prefix; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def find_gxx() -> str:
    """``g++`` (or ``$CXX``) from PATH; raises when there is none."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found: the native audio runtime needs a "
                           "C++17 compiler (set CXX or put g++ on PATH)")
    return found


def _hashed_path(source: Path, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def _compile(compiler: str, source: Path, flags: Sequence[str],
             libs: Sequence[str] = ()) -> dict:
    """Compile ``source`` unless its library exists; returns ``{"path",
    "seconds", "log"}`` (0.0 and "" when it was already built). Raises
    RuntimeError with the compiler's output when it fails."""
    path = _hashed_path(source, tuple(flags) + tuple(libs))
    if path.is_file():
        return {"path": path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # see (or load) a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(source),
                               *libs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed on "
                               f"{source.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": path, "seconds": time.perf_counter() - start,
            "log": proc.stdout + proc.stderr}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on source and flags."""
    return _hashed_path(CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def build(name: str, defines: Sequence[str] = ()) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0.0 and ``log``
    empty when the library was already built. ``log`` holds nvcc's output,
    including ``-Xptxas -v``'s registers, shared memory and spills.
    ``defines`` (``"NAME=value"``) build a variant for a tool, beside the
    library the port loads (which has none).
    """
    return _compile(find_nvcc(), CSRC_DIR / f"{name}.cu",
                    NVCC_FLAGS + tuple(f"-D{d}" for d in defines))


def build_host(name: str, libs: Sequence[str] = ()) -> dict:
    """Compile ``native/<name>.cc`` with ``g++``, linked against
    ``libs``, unless its library exists (same result as ``build``)."""
    return _compile(find_gxx(), NATIVE_DIR / f"{name}.cc", GXX_FLAGS, libs)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    return ctypes.CDLL(str(build(name)["path"]))


@functools.lru_cache(maxsize=None)
def load_host(name: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``native/<name>.cc``'s library."""
    return ctypes.CDLL(str(build_host(name, libs)["path"]))
