"""Retrieval metrics (port of ``rag_cobweb_tpu/bench/metrics.py``).

recall@k / MRR@k / nDCG@k for k in {2, 3, 5, 10, 20, 50, 100} capped at
top_k, with one gold id per query, plus total time and mean latency.  A
retriever returns a (B, k) id tensor; results are read back with
``.cpu()`` after ``torch.cuda.synchronize()``, so a timed window ends when
the device has finished.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

K_VALUES = (2, 3, 5, 10, 20, 50, 100)


def to_host(ids) -> np.ndarray:
    """A retriever's (B, k) result as a host array, after the device is
    done with it."""
    if isinstance(ids, torch.Tensor):
        if ids.is_cuda:
            torch.cuda.synchronize(ids.device)
        return ids.cpu().numpy()
    return np.asarray(ids)


def ranks_of_targets(retrieved_ids: np.ndarray,
                     target_ids: np.ndarray) -> np.ndarray:
    """1-based rank of each query's gold id in its row; 0 where absent."""
    hits = retrieved_ids == target_ids[:, None]
    first = hits.argmax(axis=1) + 1
    return np.where(hits.any(axis=1), first, 0)


def retrieval_metrics(retrieved_ids, target_ids, top_k: int,
                      k_values: Sequence[int] = K_VALUES) -> dict:
    ranks = ranks_of_targets(np.asarray(retrieved_ids),
                             np.asarray(target_ids))
    out: dict = {"num_queries": int(len(ranks))}
    for k in k_values:
        if k > top_k:
            continue
        in_k = (ranks > 0) & (ranks <= k)
        out[f"recall@{k}"] = float(in_k.mean())
        out[f"mrr@{k}"] = float(np.where(in_k, 1.0 / np.maximum(ranks, 1),
                                         0.0).mean())
        out[f"ndcg@{k}"] = float(
            np.where(in_k, 1.0 / np.log2(1.0 + np.maximum(ranks, 1)),
                     0.0).mean())
    return out


def evaluate_retrieval(name: str, retrieve_fn, query_embs: np.ndarray,
                       target_ids: np.ndarray, top_k: int,
                       batch_size: int = 256,
                       k_values: Sequence[int] = K_VALUES,
                       warmup: bool = True) -> dict:
    """Run ``retrieve_fn(query_batch, top_k) -> (B, top_k) ids`` over all
    queries.  Throughput: every batch is issued, then one synchronize ends
    the window.  ``batch_latency_ms``: median of 5 synchronous single
    batches over distinct query rows."""
    B = len(query_embs)
    if warmup and B:
        to_host(retrieve_fn(query_embs[:min(batch_size, B)], top_k))

    all_ids = np.full((B, top_k), -1, np.int64)
    results = []
    t0 = time.perf_counter()
    for s in range(0, B, batch_size):
        chunk = query_embs[s:s + batch_size]
        n = len(chunk)
        if n < batch_size and B > batch_size:   # one batch shape throughout
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - n,) + chunk.shape[1:],
                                 chunk.dtype)])
        results.append((s, n, retrieve_fn(chunk, top_k)))
    host = [(s, n, to_host(ids)[:n]) for s, n, ids in results]
    elapsed = time.perf_counter() - t0
    for s, n, ids in host:
        all_ids[s:s + n, :ids.shape[1]] = ids

    bs = min(batch_size, B)
    lats = []
    for i in range(5 if bs else 0):
        idx = (np.arange(bs) + (i * B) // 5) % B
        chunk = np.ascontiguousarray(query_embs[idx])
        t1 = time.perf_counter()
        to_host(retrieve_fn(chunk, top_k))
        lats.append(time.perf_counter() - t1)

    out = retrieval_metrics(all_ids, target_ids, top_k, k_values)
    out["method"] = name
    out["time_taken"] = elapsed
    out["avg_latency_ms"] = 1000.0 * elapsed / max(B, 1)
    out["batch_latency_ms"] = 1000.0 * float(np.median(lats)) if lats else 0.0
    out["qps"] = B / elapsed if elapsed > 0 else float("inf")
    return out
