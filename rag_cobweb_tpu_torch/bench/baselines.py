"""Retrieval baselines (port of ``rag_cobweb_tpu/bench/baselines.py``).

The reference benchmarks Cobweb against FAISS flat IP/L2, exact torch
dot, HNSWlib and Annoy (benchmark_utils.py:529-614).  The exact baseline
here is ``FlatIndex`` on the device: one float32 product (TF32 off) and
``torch.topk``, FAISS's role.  The C++ ANN libraries stay optional CPU
comparisons, each raising ``ImportError`` when its package is missing;
``bench/native.py`` has the first-party flat and HNSW baselines.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device


class FlatIndex:
    """Exact IP / cosine / L2 search over a corpus held on the device."""

    def __init__(self, corpus_embs, metric: str = "ip", device="cuda"):
        if metric not in ("ip", "l2", "cosine"):
            raise ValueError(f"unknown metric {metric}")
        self.device = resolve_device(device)
        full_f32_matmul()
        self.metric = metric
        embs = torch.as_tensor(np.asarray(corpus_embs, np.float32),
                               device=self.device)
        if metric == "cosine":
            embs = embs / embs.norm(dim=1, keepdim=True).clamp(min=1e-12)
        self.embs = embs
        self._sq_norms = torch.sum(torch.square(embs), dim=1)

    def search_device(self, queries, k: int) -> torch.Tensor:
        """(B, D) host rows or a tensor -> (B, k) ids as a device tensor
        (no host sync)."""
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, np.float32)
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device)
        if q.dim() == 1:
            q = q.unsqueeze(0)
        if self.metric == "cosine":
            q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
        scores = torch.matmul(q, self.embs.T)
        if self.metric == "l2":
            scores = 2.0 * scores - self._sq_norms   # 2qc - ||c||^2 ~ -d2
        return torch.topk(scores, min(k, self.embs.shape[0]), dim=1).indices

    def search(self, queries, k: int) -> np.ndarray:
        return self.search_device(queries, k).cpu().numpy()

    __call__ = search


def make_flat_retriever(corpus_embs, metric: str = "ip", device="cuda"):
    """``retrieve(queries, k)`` -> (B, k) ids as a device tensor (the
    caller's ``to_host`` waits for it)."""
    idx = FlatIndex(corpus_embs, metric, device=device)
    return idx.search_device


# -- optional C++ ANN baselines (CPU; parity with the reference harness) ----

def faiss_available() -> bool:
    try:
        import faiss  # noqa: F401
        return True
    except ImportError:
        return False


def hnswlib_available() -> bool:
    try:
        import hnswlib  # noqa: F401
        return True
    except ImportError:
        return False


def make_faiss_retriever(corpus_embs, metric: str = "ip"):
    """FAISS IndexFlatIP/L2 (reference setup_faiss :536-546)."""
    import faiss

    embs = np.ascontiguousarray(np.asarray(corpus_embs, np.float32))
    d = embs.shape[1]
    index = faiss.IndexFlatIP(d) if metric == "ip" else faiss.IndexFlatL2(d)
    index.add(embs)

    def retrieve(q, k):
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(q, np.float32)))
        _, ids = index.search(q, k)
        return ids

    return retrieve


def make_hnswlib_retriever(corpus_embs, M: int = 16,
                           ef_construction: int = 100, ef: int = 50):
    """hnswlib cosine graph (reference setup_hnswlib :559-566)."""
    import hnswlib

    embs = np.asarray(corpus_embs, np.float32)
    n, d = embs.shape
    index = hnswlib.Index(space="cosine", dim=d)
    index.init_index(max_elements=n, M=M, ef_construction=ef_construction)
    index.add_items(embs, np.arange(n))
    index.set_ef(ef)

    def retrieve(q, k):
        q = np.atleast_2d(np.asarray(q, np.float32))
        ids, _ = index.knn_query(q, k=k)
        return ids

    return retrieve


def make_annoy_retriever(corpus_embs, n_trees: int = 10):
    """Annoy angular trees (reference setup_annoy :549-556)."""
    from annoy import AnnoyIndex

    embs = np.asarray(corpus_embs, np.float32)
    n, d = embs.shape
    index = AnnoyIndex(d, "angular")
    for i in range(n):
        index.add_item(i, embs[i])
    index.build(n_trees)

    def retrieve(q, k):
        q = np.atleast_2d(np.asarray(q, np.float32))
        return np.asarray(
            [index.get_nns_by_vector(row, k) for row in q], np.int64)

    return retrieve
