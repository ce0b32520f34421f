"""ctypes loader of the native baselines library (``native/annlib.cpp``),
the port's own counterpart of ``rag_cobweb_tpu/bench/native.py``.

The library holds the C++ CPU baselines the reference got from FAISS and
hnswlib (benchmark_utils.py:536-566): a multithreaded exact flat top-k
and an HNSW graph index.  The port builds it from the source with ``g++``
at first use into ``build/native/`` (the library's name carries a hash of
the source, under a file lock, as the kernels' builds do); it never
writes into ``native/`` and never loads the library the JAX package's
loader builds there.  Without ``g++`` or with a failed build,
``available()`` is False and the harness skips the native rows.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "annlib.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
            "-Wall", "-shared")
_LIB: Optional[ctypes.CDLL] = None

METRIC_IP, METRIC_L2, METRIC_COSINE = 0, 1, 2
_metrics = {"ip": METRIC_IP, "l2": METRIC_L2, "cosine": METRIC_COSINE}


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libannlib_{h}.so"


def _build(so: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/annlib.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, so)


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ann_flat_topk.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, f32p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i64p, f32p,
    ]
    lib.ann_flat_topk.restype = None
    lib.ann_hnsw_create.restype = ctypes.c_void_p
    lib.ann_hnsw_create.argtypes = [ctypes.c_int] * 5
    lib.ann_hnsw_add.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.ann_hnsw_add.restype = None
    lib.ann_hnsw_search.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        i64p, f32p,
    ]
    lib.ann_hnsw_search.restype = None
    lib.ann_hnsw_set_ef.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ann_hnsw_set_ef.restype = None
    lib.ann_hnsw_size.restype = ctypes.c_int64
    lib.ann_hnsw_size.argtypes = [ctypes.c_void_p]
    lib.ann_hnsw_free.argtypes = [ctypes.c_void_p]
    lib.ann_hnsw_free.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the library loads (built first if needed)."""
    try:
        _load()
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def flat_topk(corpus: np.ndarray, queries: np.ndarray, k: int,
              metric: str = "ip", threads: int = 0):
    """Exact top-k over the corpus: (nq, k) ids + scores.  L2 scores are
    negative squared distances (larger = closer)."""
    lib = _load()
    corpus = np.ascontiguousarray(corpus, np.float32)
    queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
    n, d = corpus.shape
    if queries.shape[1] != d:
        raise ValueError(f"query width {queries.shape[1]} != corpus {d}")
    nq = len(queries)
    k = min(k, n)
    threads = threads or (os.cpu_count() or 1)
    ids = np.empty((nq, k), np.int64)
    scores = np.empty((nq, k), np.float32)
    lib.ann_flat_topk(_f32p(corpus), n, d, _f32p(queries), nq, k,
                      _metrics[metric], threads, _i64p(ids), _f32p(scores))
    return ids, scores


class NativeHNSW:
    """HNSW graph index (hnswlib's role: space "cosine", M=16,
    ef_construction=100, ef=50 by default, as benchmark_utils.py:559-566)."""

    def __init__(self, dim: int, M: int = 16, ef_construction: int = 100,
                 ef: int = 50, metric: str = "cosine"):
        self._lib = _load()
        self.dim = dim
        self._h = ctypes.c_void_p(self._lib.ann_hnsw_create(
            dim, M, ef_construction, ef, 1 if metric == "cosine" else 0))

    def add(self, xs: np.ndarray):
        xs = np.ascontiguousarray(np.atleast_2d(xs), np.float32)
        if xs.shape[1] != self.dim:
            raise ValueError(f"row width {xs.shape[1]} != index {self.dim}")
        self._lib.ann_hnsw_add(self._h, _f32p(xs), len(xs))

    def set_ef(self, ef: int):
        self._lib.ann_hnsw_set_ef(self._h, ef)

    def __len__(self):
        return int(self._lib.ann_hnsw_size(self._h))

    def search(self, queries: np.ndarray, k: int, threads: int = 0):
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        if queries.shape[1] != self.dim:
            raise ValueError(f"query width {queries.shape[1]} != index "
                             f"{self.dim}")
        nq = len(queries)
        threads = threads or (os.cpu_count() or 1)
        ids = np.empty((nq, k), np.int64)
        scores = np.empty((nq, k), np.float32)
        self._lib.ann_hnsw_search(self._h, _f32p(queries), nq, k, threads,
                                  _i64p(ids), _f32p(scores))
        return ids, scores

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ann_hnsw_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def make_native_flat_retriever(corpus_embs, metric: str = "ip"):
    corpus = np.ascontiguousarray(corpus_embs, np.float32)

    def retrieve(q, k):
        return flat_topk(corpus, q, k, metric)[0]

    return retrieve


def make_native_hnsw_retriever(corpus_embs, M: int = 16,
                               ef_construction: int = 100, ef: int = 50):
    corpus = np.ascontiguousarray(corpus_embs, np.float32)
    index = NativeHNSW(corpus.shape[1], M, ef_construction, ef)
    index.add(corpus)

    def retrieve(q, k):
        return index.search(q, k)[0]

    retrieve.index = index
    return retrieve
