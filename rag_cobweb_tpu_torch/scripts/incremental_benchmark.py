"""Add-then-query freshness on the card (twin of
``scripts/incremental_benchmark.py``).

Builds a ``--size`` index (``--vforest`` lanes, rows added 8192 at a
time), times one warm ``predict_fast``, then adds ``--add`` rows and
queries again: the index is kept and the new rows are served from the
pending tier (kernel 5, ``index.pending_leaf_lp``) beside the served
index (kernels 1 and 5).  Then the adds that push the pending rows past
``stale_pending_limit``, which moves them into the delta segment, and
the queries after that.  One JSON line with the JAX script's keys.

    python -m rag_cobweb_tpu_torch.scripts.incremental_benchmark \\
        [--cache mb_cache_*.npz] [--device cuda]

``--cache``: a whitened cache (``corpus_w``) written by either package
(``scripts/million_benchmark.py``, ``derive_caches``).  Without it the
rows are the easy synthetic set whitened by PCA+ICA fitted on the first
50000 rows.  Not carried over, as they exist only for the TPU: the XLA
compile cache and ``warmup_insert_programs`` (the port compiles no
insert program; its descent step is a CUDA graph captured on first use).
"""

import argparse
import json
import time

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=100_000)
    p.add_argument("--add", type=int, default=1000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=int, default=128)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--vforest", type=int, default=64)
    p.add_argument("--cache", type=str, default=None,
                   help=".npz with a precomputed whitened corpus_w")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.scripts._sweeps import sync, whiten
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

    enable_persistent_cache()
    total = args.size + args.add
    if args.cache:
        with np.load(args.cache) as z:
            corpus_w = z["corpus_w"]
        assert len(corpus_w) >= total, (len(corpus_w), total)
        corpus_w = np.ascontiguousarray(corpus_w[:total])
    else:
        data = synthetic_retrieval(total, 256, args.dim,
                                   n_clusters=max(256, total // 256))
        wh = PCAICAWhiteningModel.fit(data.corpus_embs[:50_000],
                                      pca_dim=args.pca_dim, ica_max_iter=300)
        corpus_w = whiten(wh, data.corpus_embs, dev)

    lanes = max(1, args.vforest)
    # ~2 nodes a sentence, the JAX script's sizing
    cap = (lanes * max(2048, (2 * total) // lanes + 64) if lanes > 1
           else 4 * total + 16)
    db = CobwebIndex(config=TreeConfig(dim=corpus_w.shape[1]),
                     capacity=cap, n_subtrees=lanes, device=dev)
    t0 = time.perf_counter()
    for s in range(0, args.size, 8192):
        n = min(8192, args.size - s)
        db.add_sentences([None] * n, corpus_w[s:s + n])
    sync(dev)
    build_s = time.perf_counter() - t0

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()          # predict_fast returns host lists: synced
        return out, time.perf_counter() - t0

    q = corpus_w[:256] + 0.01 * np.random.default_rng(0).normal(
        size=(256, corpus_w.shape[1])).astype(np.float32)
    _, first_q = timed(lambda: db.predict_fast(q, k=args.k,
                                               is_embedding=True))
    _, warm_q = timed(lambda: db.predict_fast(q, k=args.k,
                                              is_embedding=True))

    # the measured event: add, then query
    new_w = corpus_w[args.size:args.size + args.add]

    def add(rows):
        db.add_sentences([None] * len(rows), rows)
        sync(dev)

    _, add_s = timed(lambda: add(new_w))
    stale = bool(db._pending_sids)
    _, fresh_q = timed(lambda: db.predict_fast(
        new_w[:256], k=args.k, is_embedding=True, return_ids=True))
    got, fresh_q_warm = timed(lambda: db.predict_fast(
        new_w[:256], k=args.k, is_embedding=True, return_ids=True))
    hit = np.mean([args.size + i in row
                   for i, row in enumerate(got[:len(new_w)])])

    # the pending rows pushed past stale_pending_limit: the next query
    # serves them from the delta segment
    n_over = db.stale_pending_limit - len(db._pending_sids) + 1
    over_s = cliff_q_s = cliff_warm_s = -1.0
    if n_over > 0 and args.size >= n_over:
        over_w = corpus_w[:n_over] + np.float32(0.02)   # reuse rows as adds
        _, over_s = timed(lambda: add(over_w))
        overflowed = not db._pending_sids
        _, cliff_q_s = timed(lambda: db.predict_fast(q, k=args.k,
                                                     is_embedding=True))
        _, cliff_warm_s = timed(lambda: db.predict_fast(q, k=args.k,
                                                        is_embedding=True))
    else:
        overflowed = False

    rec = {
        "size": args.size, "added": args.add,
        "build_s": round(build_s, 1),
        "index_build_plus_query_s": round(first_q, 2),
        "warm_query_s": round(warm_q, 3),
        "add_s": round(add_s, 2),
        "stale_served": stale,
        "add_then_query_s": round(fresh_q, 3),
        "add_then_query_warm_s": round(fresh_q_warm, 3),
        "new_sentence_self_hit@10": round(float(hit), 4),
        "overflow_adds": int(max(n_over, 0)),
        "overflow_invalidated": overflowed,
        "overflow_add_s": round(over_s, 2),
        "overflow_rebuild_query_s": round(cliff_q_s, 2),
        "overflow_warm_query_s": round(cliff_warm_s, 3),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
