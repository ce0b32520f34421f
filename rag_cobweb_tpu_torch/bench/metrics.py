"""Retrieval metrics (port of ``rag_cobweb_tpu/bench/metrics.py``).

recall@k / MRR@k / nDCG@k for k in {2, 3, 5, 10, 20, 50, 100} capped at
top_k, with one gold id per query, plus total time and mean latency, and
the results table of the reference's harness.  A retriever returns a
(B, k) id tensor or array; results are read back with ``.cpu()`` after
``torch.cuda.synchronize()``, so a timed window ends when the device has
finished.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

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
                       warmup: bool = True, control_fn=None,
                       control_threshold_ms: Optional[float] = None) -> dict:
    """Run ``retrieve_fn(query_batch, top_k) -> (B, top_k) ids`` over all
    queries.  Throughput: every batch is issued, then one synchronize ends
    the window.  ``batch_latency_ms``: median of 5 synchronous single
    batches over distinct query rows.

    ``control_fn``: a second retriever (a small exact scan) probed in the
    same measurement, 3 batches, whose batch time the record carries as
    ``control_batch_ms`` / ``control_ms`` and ``latency_vs_control``; with
    ``control_threshold_ms`` (a batch) the whole measurement is taken
    once more when the control exceeds it (``control_requeued``), as the
    JAX package does for a slowed host."""
    B = len(query_embs)
    bs = min(batch_size, B)
    if warmup and B:
        to_host(retrieve_fn(query_embs[:bs], top_k))
        if control_fn is not None:
            to_host(control_fn(query_embs[:bs], top_k))

    def probe_latency(fn, n_probes: int = 5) -> float:
        lats = []
        for i in range(n_probes if bs else 0):
            idx = (np.arange(bs) + (i * B) // n_probes) % B
            chunk = np.ascontiguousarray(query_embs[idx])
            t1 = time.perf_counter()
            to_host(fn(chunk, top_k))
            lats.append(time.perf_counter() - t1)
        return float(np.median(lats)) if lats else 0.0

    def measure_once():
        all_ids = np.full((B, top_k), -1, np.int64)
        results = []
        t0 = time.perf_counter()
        for s in range(0, B, batch_size):
            chunk = query_embs[s:s + batch_size]
            n = len(chunk)
            if n < batch_size and B > batch_size:   # one batch shape
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - n,) + chunk.shape[1:],
                                     chunk.dtype)])
            results.append((s, n, retrieve_fn(chunk, top_k)))
        host = [(s, n, to_host(ids)[:n]) for s, n, ids in results]
        elapsed = time.perf_counter() - t0
        for s, n, ids in host:
            all_ids[s:s + n, :ids.shape[1]] = ids
        control = (probe_latency(control_fn, n_probes=3)
                   if control_fn is not None else None)
        return all_ids, elapsed, probe_latency(retrieve_fn), control

    requeued = False
    for attempt in range(2):
        all_ids, elapsed, batch_latency, control = measure_once()
        if (control_fn is None or control_threshold_ms is None or attempt
                or 1000.0 * control <= control_threshold_ms):
            break
        requeued = True
        print(f"[evaluate_retrieval] control batch {1000.0 * control:.1f} "
              f"ms exceeds {control_threshold_ms:.1f} ms: measuring once "
              "more", flush=True)

    out = retrieval_metrics(all_ids, target_ids, top_k, k_values)
    out["method"] = name
    out["time_taken"] = elapsed
    out["avg_latency_ms"] = 1000.0 * elapsed / max(B, 1)
    out["batch_latency_ms"] = 1000.0 * batch_latency
    out["qps"] = B / elapsed if elapsed > 0 else float("inf")
    if control_fn is not None:
        out["control_batch_ms"] = 1000.0 * control
        out["control_ms"] = 1000.0 * control / max(bs, 1)
        out["latency_vs_control"] = (batch_latency / control if control
                                     else float("inf"))
        if control_threshold_ms is not None:
            out["control_requeued"] = requeued
    return out


def _is_number(s: str) -> bool:
    try:
        v = float(s)
    except ValueError:
        return False
    if math.isinf(v) or math.isnan(v):
        return s.lower() in ("inf", "-inf", "nan")
    return True


def _is_int(s: str) -> bool:
    try:
        int(s)
    except ValueError:
        return False
    return True


def _after_point(s: str) -> int:
    """Digits after the decimal point (or the exponent mark), -1 for an
    integer or none."""
    if _is_int(s):
        return -1
    pos = s.rfind(".")
    if pos < 0:
        pos = s.lower().rfind("e")
    return len(s) - pos - 1 if pos >= 0 else -1


def grid_table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    """``tabulate(rows, headers=header, tablefmt="grid")`` with its
    defaults, written here so that no ``tabulate`` is needed: a column
    whose cells all parse as numbers is re-formatted (``g``, or as ints),
    aligned on the decimal point and right-aligned under a right-aligned
    header; any other column is stripped and left-aligned.  Each column
    is as wide as its widest cell, at least its header plus 2."""
    cols = [list(c) for c in zip(*rows)] if rows else [[] for _ in header]
    out_cols, right = [], []
    for h, col in zip(header, cols):
        minw = len(h) + 2
        if col and all(_is_number(c) for c in col):
            if all(_is_int(c) for c in col):
                col = [format(int(c), "") for c in col]
            else:
                col = [format(float(c), "g") for c in col]
            dec = [_after_point(c) for c in col]
            col = [c + " " * (max(dec) - d) for c, d in zip(col, dec)]
            w = max([minw] + [len(c) for c in col])
            out_cols.append([c.rjust(w) for c in col])
            right.append(True)
        else:
            col = [c.strip() for c in col]
            w = max([minw] + [len(c) for c in col])
            out_cols.append([c.ljust(w) for c in col])
            right.append(False)
    widths = [max([len(h) + 2] + [len(c) for c in col])
              for h, col in zip(header, out_cols)]
    heads = [h.rjust(w) if r else h.ljust(w)
             for h, w, r in zip(header, widths, right)]

    def line(ch):
        return "+" + "+".join(ch * (w + 2) for w in widths) + "+"

    def cells(vals):
        return "|" + "|".join(f" {v} " for v in vals) + "|"

    lines = [line("-"), cells(heads), line("=")]
    for r in zip(*out_cols):
        lines += [cells(r), line("-")]
    if not rows:
        lines.append(line("-"))
    return "\n".join(lines)


def print_metrics_table(results: Sequence[dict],
                        out_path: Optional[str] = None,
                        k_values: Sequence[int] = K_VALUES,
                        top_k: int = 100) -> str:
    """The results as tabulate's ``grid`` table (reference
    print_metrics_table :836-868), appended to ``out_path`` when given, so
    the reference's table parsers and both packages'
    ``report.parse_results_file`` read it back."""
    ks = [k for k in k_values if k <= top_k]
    header = ["method"] + [f"recall@{k}" for k in ks] + \
        [f"mrr@{k}" for k in ks] + [f"ndcg@{k}" for k in ks] + \
        ["avg_latency_ms", "qps"]
    rows = []
    for r in results:
        rows.append(
            [str(r.get("method", "?"))]
            + [f"{r.get(f'recall@{k}', float('nan')):.4f}" for k in ks]
            + [f"{r.get(f'mrr@{k}', float('nan')):.4f}" for k in ks]
            + [f"{r.get(f'ndcg@{k}', float('nan')):.4f}" for k in ks]
            + [f"{r.get('avg_latency_ms', float('nan')):.3f}",
               f"{r.get('qps', float('nan')):.1f}"])
    table = grid_table(header, rows)
    if out_path:
        with open(out_path, "a") as f:
            f.write(table + "\n\n")
    return table
