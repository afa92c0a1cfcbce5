"""Build a repository C++ source into a host shared library for ctypes.

The port builds ``native/*.cpp`` (the BPE merge core, the vector store's
top-k loop) with the host C++ compiler into its own build directory,
``githubrepostorag_tpu_torch/_build/``, under a name hashed from the source
and the flags, through a temporary file renamed into place (two processes
may build at once).  It never runs ``make -C native``: that writes
``native/*.so``, which the JAX package loads.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's flags without -march=native: a checkout (and its build
# directory) may be copied to another host, whose CPU must still run it
CXXFLAGS = ["-O3", "-fopenmp-simd", "-fPIC", "-shared", "-std=c++17", "-Wall"]


def library_path(source: Path, stem: str) -> Path:
    """``_build/<stem>-<hash of source and flags>.so``."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:12]}.so"


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` unless a library of the same source and flags is
    in the build directory; returns its path.  Raises
    ``subprocess.SubprocessError`` or ``OSError`` when the build fails."""
    target = library_path(source, stem)
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target
