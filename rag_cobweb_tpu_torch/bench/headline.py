"""Headline benchmark of the port: the flagship configuration of
``bench.py`` (QQP-like: c=10000 corpus, 1000 queries, 768-d, PCA+ICA
whitening at 0.96 variance, a 32-lane forest, k=10, pool 1024) built and
served on one device.

    python -m rag_cobweb_tpu_torch.bench.headline [--device cuda]
        [--vforest K] [--routing round_robin|content]
        [--engine fused|blocked|blocked_kernel ...]

``--vforest 1`` builds the single tree (``CobwebIndex``'s default) as
``bench.py`` does: a first index over 2048 rows (its time counts as the
warm-up), then the rest added, whose rate is the build rate.
``--routing`` picks the forest's lanes (``CobwebIndex(routing=...)``).
``--whitener`` picks the whitening model: ``pcaica`` (the flagship's,
``--pca-dim`` components or variance fraction), ``zca`` (full rank, the
tree as wide as the rows) or ``pcazca`` (``--pca-dim``, rotated back to
the rows' full width).
The tree or forest is built once; each ``--engine`` then serves the
queries and prints ONE JSON line with the keys of ``bench.py`` plus
``device``, ``engine``, ``corpus_size``, ``n_subtrees`` and ``routing``:

* ``fused`` (default): the fused sweep kernel, exact pool, exact re-rank;
* ``blocked``: ``use_fused=False``, the blocked sweep in PyTorch;
* ``blocked_kernel``: ``use_fused=False, use_pallas=True`` with
  ``pallas_threshold`` set to the corpus size, the blocked sweep kernel
  (the JAX default of 300 000 gates this opt-in engine on larger
  corpora).

A forest below the wrapper's ``blocked_threshold`` (8192 sentences) is
served by the small-forest engine whatever ``--engine`` says, and its
record says ``"engine": "small_forest"``.

There is no CPU build fallback and no warm-up thread: the build and the
serving run on ``--device``, and the card's name is recorded beside the
numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
from rag_cobweb_tpu_torch.bench.datasets import (synthetic_retrieval,
                                                 synthetic_retrieval_hard)
from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval, to_host
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.device import resolve_device
from rag_cobweb_tpu_torch.whitening import (PCAICAWhiteningModel,
                                            PCAZCAWhiteningModel,
                                            ZCAWhiteningModel)

REF_LATENCY_MS = 53.1     # BASELINE.md: reference Cobweb PCA+ICA Fast, CPU
REF_RECALL = 0.906        # reference cobweb, QQP roberta c=10000
REF_EXACT_RECALL = 0.913  # reference FAISS exact, same artifact
ENGINES = ("fused", "blocked", "blocked_kernel")
# whitener -> (its name in the record's metric, in its log lines)
WHITENERS = {"pcaica": ("pca_ica", "PCA+ICA"), "zca": ("zca", "ZCA"),
             "pcazca": ("pca_zca", "PCA+ZCA")}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _set_engine(db: CobwebIndex, engine: str, n: int) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    db.use_fused = engine == "fused"
    db.use_pallas = engine == "blocked_kernel"
    if db.use_pallas:
        db.pallas_threshold = n


def fit_whitener(kind: str, corpus: np.ndarray, pca_dim: float):
    """The whitening model ``kind`` fitted on ``corpus`` (PCA+ICA as the
    flagship fits it: 500 ICA iterations on at most 10000 rows)."""
    pca = pca_dim if pca_dim < 1 else int(pca_dim)
    if kind == "pcaica":
        return PCAICAWhiteningModel.fit(corpus, pca_dim=pca,
                                        ica_max_iter=500, seed=0,
                                        ica_sample_size=10000)
    if kind == "pcazca":
        return PCAZCAWhiteningModel.fit(corpus, pca_dim=pca)
    if kind == "zca":
        return ZCAWhiteningModel.fit(corpus)
    raise ValueError(f"whitener must be one of {tuple(WHITENERS)}, got "
                     f"{kind!r}")


def run(corpus_size: int = 10000, queries: int = 1000, dim: int = 768,
        pca_dim: float = 0.96, k: int = 10, batch: int = 1024,
        dataset: str = "hard", n_lanes: int = 32, rerank: int = 1024,
        device="cuda", engines=("fused",), log=None, hook=None,
        routing: str = "round_robin", whitener: str = "pcaica") -> list:
    """Build one configuration, serve it with each of ``engines`` in turn;
    returns one headline record per engine.  ``hook(event, engine, db,
    data)`` is called with ``"start"`` just before an engine serves its
    first query and ``"end"`` just after its last."""
    log = log or (lambda *a: None)
    hook = hook or (lambda *a: None)
    dev = resolve_device(device)
    gen = synthetic_retrieval_hard if dataset == "hard" \
        else synthetic_retrieval
    data = gen(corpus_size, queries, dim)
    log(f"[headline] corpus {data.corpus_embs.shape}, queries "
        f"{data.query_embs.shape} ({data.name})")

    t0 = time.perf_counter()
    kind, whitener = whitener, fit_whitener(whitener, data.corpus_embs,
                                            pca_dim)
    fit_s = time.perf_counter() - t0
    metric, label = WHITENERS[kind]
    log(f"[headline] {label} fit {fit_s:.1f}s -> dim {whitener.dim_out}")
    corpus = data.corpus_embs
    cfg, cap = TreeConfig(dim=whitener.dim_out), 4 * len(corpus) + 16
    warm_s = 0.0
    if n_lanes > 1:
        db = CobwebIndex(config=cfg, capacity=cap, n_subtrees=n_lanes,
                         routing=routing, whitener=whitener, device=dev)
        t0 = time.perf_counter()
        db.add_sentences([None] * len(corpus), corpus)
        _sync(dev)
        build_s = time.perf_counter() - t0
        rate = len(corpus) / build_s
    else:
        # bench.py's single-tree build: a warm first index, then the rest
        warm_n = min(2048, len(corpus))
        t0 = time.perf_counter()
        db = CobwebIndex(corpus_embeddings=corpus[:warm_n], config=cfg,
                         capacity=cap, whitener=whitener, device=dev)
        _sync(dev)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if len(corpus) > warm_n:
            db.add_sentences([None] * (len(corpus) - warm_n),
                             corpus[warm_n:])
        _sync(dev)
        steady_s = max(time.perf_counter() - t0, 1e-9)
        build_s = warm_s + steady_s
        rate = ((len(corpus) - warm_n) / steady_s if len(corpus) > warm_n
                else warm_n / warm_s)
    log(f"[headline] {'forest' if n_lanes > 1 else 'tree'} build "
        f"{build_s:.1f}s ({rate:.0f} inserts/s"
        + (f"; first {min(2048, len(corpus))} rows {warm_s:.1f}s)"
           if n_lanes == 1 else ")"))

    flat = FlatIndex(corpus, metric="l2", device=dev)
    exact = evaluate_retrieval(
        "Exact flat (torch)", lambda q, kk: flat.search_device(q, kk),
        data.query_embs, data.target_ids, k, batch_size=batch)
    ek = exact.get("recall@10", 0.0)
    log(f"[headline] exact recall@{k}={exact.get(f'recall@{k}')} "
        f"{exact['avg_latency_ms']:.4f} ms/query")

    rr = None if rerank == -1 else rerank
    records = []
    small_forest = n_lanes > 1 and len(corpus) < db.blocked_threshold
    for engine in engines:
        _set_engine(db, engine, len(corpus))
        engine = "small_forest" if small_forest else engine
        hook("start", engine, db, data)
        t0 = time.perf_counter()
        to_host(db.query_ids(data.query_embs[:8], k, rerank=rr))
        index_s = time.perf_counter() - t0
        log(f"[headline] {engine}: index build + first query "
            f"{index_s:.2f}s")
        res = evaluate_retrieval(
            f"Cobweb {label} Fast (torch, {engine})",
            lambda q, kk: db.query_ids(q, kk, rerank=rr),
            data.query_embs, data.target_ids, k, batch_size=batch)
        small = {}
        for bs in (1, 32):
            if len(data.query_embs) < bs:
                continue
            to_host(db.query_ids(data.query_embs[:bs], k, rerank=rr))
            lats = []
            for i in range(7):
                off = (i * 131) % (len(data.query_embs) - bs + 1)
                chunk = np.ascontiguousarray(data.query_embs[off:off + bs])
                t1 = time.perf_counter()
                to_host(db.query_ids(chunk, k, rerank=rr))
                lats.append(time.perf_counter() - t1)
            small[bs] = 1000.0 * float(np.median(lats))
        hook("end", engine, db, data)
        ours_ms = res["avg_latency_ms"]
        rk = res.get("recall@10", 0.0)
        log(f"[headline] {engine}: recall@{k}={res.get(f'recall@{k}')} "
            f"{ours_ms:.4f} ms/query")
        records.append({
            "metric": f"cobweb_{metric}_fast_query_latency_c{corpus_size}",
            "value": ours_ms,
            "unit": "ms/query",
            "vs_baseline": REF_LATENCY_MS / ours_ms,
            "dataset": data.name,
            "recall@10": rk,
            "exact_recall@10": ek,
            "recall_delta_vs_exact": ek - rk,
            "ref_recall_delta_vs_exact": round(REF_EXACT_RECALL - REF_RECALL,
                                               4),
            "ref_recall@10": REF_RECALL,
            "exact_latency_ms": exact["avg_latency_ms"],
            "latency_vs_exact": ours_ms / max(exact["avg_latency_ms"], 1e-9),
            "build_inserts_per_s": rate,
            "build_total_s": build_s,
            "build_device": dev.type,
            "compile_warmup_s": warm_s,
            "index_build_s": index_s,
            "qps": res["qps"],
            "b1_latency_ms": small.get(1),
            "b32_latency_ms": small[32] / 32 if 32 in small else None,
            "warmup_in_flight": False,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "engine": engine,
            "corpus_size": corpus_size,
            "n_subtrees": n_lanes,
            "routing": routing if n_lanes > 1 else None,
            "whitener": kind,
            "whitener_fit_s": fit_s,
            "tree_dim": whitener.dim_out,
        })
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus-size", type=int, default=10000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--pca-dim", type=float, default=0.96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--dataset", choices=["hard", "easy"], default="hard")
    ap.add_argument("--vforest", type=int, default=32, metavar="K")
    ap.add_argument("--routing", choices=["round_robin", "content"],
                    default="round_robin")
    ap.add_argument("--rerank", type=int, default=1024,
                    help="exact re-rank pool size; -1 = wrapper auto")
    ap.add_argument("--whitener", choices=tuple(WHITENERS),
                    default="pcaica")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=ENGINES, action="append",
                    help="serving engine, repeatable (default: fused)")
    args = ap.parse_args(argv)
    recs = run(args.corpus_size, args.queries, args.dim, args.pca_dim,
               args.k, args.batch, args.dataset, args.vforest, args.rerank,
               args.device, engines=tuple(args.engine or ("fused",)),
               log=lambda *a: print(*a, file=sys.stderr, flush=True),
               routing=args.routing, whitener=args.whitener)
    for rec in recs:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
