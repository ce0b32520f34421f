"""The experiment twins' shared recipe: the synthetic set (hard or
easy), the PCA+ICA fit of the JAX scripts (``ica_max_iter=500, seed=0,
ica_sample_size=10000``, a float ``pca_dim`` below 1 a variance
fraction), the rows whitened on the device, and a ``CobwebIndex`` over
them with every row added.  Each script keeps its own arguments at its
call site."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.bench import datasets
from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
from rag_cobweb_tpu_torch.bench.metrics import to_host
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pca_arg(pca_dim: float):
    """A variance fraction below 1, else a component count."""
    return pca_dim if pca_dim < 1 else int(pca_dim)


def dataset(name: str, corpus_size: int, queries: int, dim: int, **kw):
    """``bench/datasets``' hard or easy synthetic set (looked up at call
    time, so a caller may stand a smaller one in)."""
    gen = (datasets.synthetic_retrieval_hard if name == "hard"
           else datasets.synthetic_retrieval)
    return gen(corpus_size, queries, dim, **kw)


def fit_whitener(corpus: np.ndarray, pca_dim: float,
                 fit_rows: int = 100_000) -> PCAICAWhiteningModel:
    """The JAX scripts' PCA+ICA fit on the first ``fit_rows`` rows."""
    return PCAICAWhiteningModel.fit(
        corpus[:fit_rows], pca_dim=pca_arg(pca_dim), ica_max_iter=500,
        seed=0, ica_sample_size=10000)


def whiten(w, x: np.ndarray, device, chunk: int = 131072) -> np.ndarray:
    """Rows through ``w.transform_torch`` on ``device`` (float64 sums,
    rounded once), in chunks, back to the host as float32."""
    return np.concatenate([
        w.transform_torch(torch.as_tensor(x[s:s + chunk], device=device))
        .cpu().numpy() for s in range(0, len(x), chunk)]).astype(np.float32)


def build_index(rows: np.ndarray, lanes: int, device, routing="round_robin"):
    """(the index, build seconds): a ``lanes``-lane forest (one tree at
    1) of capacity 4 n + 16 with every row added in one call, as the JAX
    scripts build it."""
    db = CobwebIndex(config=TreeConfig(dim=rows.shape[1]),
                     capacity=4 * len(rows) + 16, n_subtrees=lanes,
                     routing=routing, device=device)
    t0 = time.perf_counter()
    db.add_sentences([None] * len(rows), rows)
    sync(device)
    return db, time.perf_counter() - t0


def recall(ids, gold: np.ndarray, k: int) -> float:
    """Share of queries whose gold id is among the first ``k`` of its
    row."""
    ids = to_host(ids)[:, :k]
    return float(np.mean([g in row for g, row in zip(gold, ids)]))


def exact_recall(corpus: np.ndarray, queries: np.ndarray, gold: np.ndarray,
                 k: int, device) -> float:
    """recall@k of the exact L2 scan (``FlatIndex``) on ``device``."""
    return recall(FlatIndex(corpus, metric="l2", device=device)
                  .search_device(queries, k), gold, k)
