"""Build and bind the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``<name>_launch``, loaded with
``ctypes``.  Libraries land in ``_build/`` inside the package, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  ``build()`` starts one ``nvcc`` per source, all
at once, and waits for all of them.

Nothing is built when this module is imported: the first launch builds
what it needs (or the caller runs ``build()`` up front, as
``chip_smoke.py`` does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argument list of each ``<name>_launch`` C function, in order
SIGNATURES = {
    # q, k_pages, v_pages, out, block_tables, cached_lens, new_lens, k_scales,
    # v_scales, B, S, n_q, n_kv, P, page_size, head_dim, max_pages, dtype,
    # pool, scale, stream
    "fused_window_attention": [_P] * 9 + [_I] * 10 + [_F, _P],
    # q, k_pages, v_pages, out, block_tables, cached_lens, new_lens,
    # workspace, counters, B, n_q, n_kv, P, page_size, head_dim, max_pages,
    # dtype, pages_per_split, n_splits, scale, stream
    "paged_decode": [_P] * 9 + [_I] * 10 + [_F, _P],
    # q, k_pages, v_pages, staged_k, staged_v, out, block_tables, pool_lens,
    # k_scales, v_scales, workspace, counters, B, n_q, n_kv, P, page_size,
    # head_dim, max_pages, n_steps, staged_len, layer, dtype, pool,
    # pages_per_split, n_splits, scale, stream
    "paged_decode_staged": [_P] * 12 + [_I] * 14 + [_F, _P],
    # q, k_pages, v_pages, out, block_tables, cached_lens, new_lens, row_of,
    # R, tq, n_q, n_kv, P, page_size, head_dim, max_pages, dtype, scale, stream
    "packed_prefill": [_P] * 8 + [_I] * 9 + [_F, _P],
    # x, q, s, zs, out, M, K, N, group_size, x dtype, out dtype, loader,
    # block_m, grid, stream
    "int4_matmul": [_P] * 5 + [_I] * 9 + [_P],
    # x, q, s, zs, out, codes, rsum, sxn, part, counters, M, K, N,
    # group_size, x dtype, out dtype, kernel, loader, block_m, splits,
    # groups per split, groups per stage, stages, stream
    "w4a8_matmul": [_P] * 10 + [_I] * 13 + [_P],
}

_lock = threading.Lock()
_launchers: dict[str, ctypes._CFuncPtr] = {}
# nvcc's stderr per built library (ptxas register / spill report)
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME); the CUDA kernels build from "
            "githubrepostorag_tpu_torch/csrc with the CUDA toolkit"
        )
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the wall
    seconds each build took (0.0 for a library that was already there).
    Raises with the compiler's output if any build fails."""
    names = list(SIGNATURES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    seconds: dict[str, float] = {}
    for name in names:
        target = _target(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, target, time.monotonic())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def launcher(name: str):
    """The ctypes function ``<name>_launch``, building its library first if
    needed.  It returns the kernel launch's ``cudaError_t`` as an int."""
    fn = _launchers.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _launchers.get(name)
        if fn is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _launchers[name] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error: a refused launch never runs
    and ``torch.cuda.synchronize()`` would not report it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
