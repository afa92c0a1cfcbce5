"""Native-accelerated local vector store; port of
``githubrepostorag_tpu/store/native.py``.

Same semantics as MemoryVectorStore, with the hot scoring loop delegated to
the repository's C++ SIMD loop (``native/vecsearch.cpp``'s ``topk_cosine``)
via ctypes.  The port builds it at first use into its own ``_build/``
(``utils/host_build.py``: native/Makefile's flags without -march=native),
never through ``make -C native``.  When the build or the load fails it
warns and keeps the memory store's numpy path, as the JAX store does, so
STORE_BACKEND=native is always safe to select; ``backend`` says which path
a store runs (``"native"`` or ``"numpy"``).

One divergence by design: ties come in insertion order, as in the memory
store and the device index.  ``topk_cosine`` keeps its heap ordered by
(score, row), so the JAX store returns tied rows last-inserted first, and
at the k boundary may keep a later tied row; the port over-fetches until
the tie group at the k-th score is whole, then orders the candidates by
score descending and row ascending.
"""

from __future__ import annotations

import ctypes
import subprocess
from functools import lru_cache
from typing import Mapping

import numpy as np

from githubrepostorag_tpu_torch.store.base import SearchHit, _match
from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
from githubrepostorag_tpu_torch.utils.host_build import NATIVE_DIR, build_library
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SOURCE = NATIVE_DIR / "vecsearch.cpp"


@lru_cache(maxsize=1)
def _get_lib() -> ctypes.CDLL | None:
    """``topk_cosine``, built at first use; None (the numpy path) when it
    cannot be built or loaded."""
    try:
        lib_path = build_library(_SOURCE, "libvecsearch")
    except (subprocess.SubprocessError, OSError) as exc:
        logger.warning("native vecsearch build failed, using numpy path: %s", exc)
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as exc:  # pragma: no cover - environment-specific
        logger.warning("native vecsearch load failed, using numpy path: %s", exc)
        return None
    lib.topk_cosine.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # row-normalized matrix [n, d]
        ctypes.c_int,  # n
        ctypes.c_int,  # d
        ctypes.POINTER(ctypes.c_float),  # normalized query [d]
        ctypes.c_int,  # k
        ctypes.POINTER(ctypes.c_int),  # out indices [k]
        ctypes.POINTER(ctypes.c_float),  # out scores [k]
    ]
    lib.topk_cosine.restype = ctypes.c_int
    return lib


def _topk(lib: ctypes.CDLL, mat: np.ndarray, q: np.ndarray, fetch: int
          ) -> tuple[np.ndarray, np.ndarray]:
    """The C++ loop's best ``fetch`` rows, ordered by score descending,
    then row ascending."""
    out_idx = np.empty(fetch, dtype=np.int32)
    out_score = np.empty(fetch, dtype=np.float32)
    got = lib.topk_cosine(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mat.shape[0],
        mat.shape[1],
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fetch,
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    idx, score = out_idx[:got], out_score[:got]
    order = np.lexsort((idx, -score))
    return idx[order], score[order]


class NativeVectorStore(MemoryVectorStore):
    @property
    def backend(self) -> str:
        return "native" if _get_lib() is not None else "numpy"

    def search(
        self,
        table: str,
        query_vector: np.ndarray,
        k: int,
        filter: Mapping[str, str] | None = None,
    ) -> list[SearchHit]:
        lib = _get_lib()
        if lib is None:
            return super().search(table, query_vector, k, filter)
        with self._lock:
            t = self._tables.get(table)
            if t is None or k <= 0:
                return []
            mat, ids = t.matrix()
            n = mat.shape[0]
            if n == 0:
                return []
            q = np.asarray(query_vector, dtype=np.float32).reshape(-1)
            qn = np.linalg.norm(q)
            if qn == 0:
                return []
            q = np.ascontiguousarray(q / qn)
            mat = np.ascontiguousarray(mat)
            # over-fetch so post-filtering can still fill k (a filter ranks
            # every row), and until the rows tied with the k-th score are
            # all in: a row left out scores no more than the least fetched
            fetch = n if filter else min(n, max(2 * k, 16))
            while True:
                idx, score = _topk(lib, mat, q, fetch)
                if fetch == n or score[k - 1] > score[-1]:
                    break
                fetch = min(n, fetch * 4)
            hits: list[SearchHit] = []
            for i, s in zip(idx, score):
                doc = t.docs[ids[i]]
                if _match(doc.metadata, filter):
                    hits.append(SearchHit(doc=doc, score=float(s)))
                    if len(hits) >= k:
                        break
            return hits
