"""Streaming-scale benchmark on the card (twin of
``scripts/scale_benchmark.py``): the corpus streamed in chunks through
``CobwebIndex.add_sentences``; at each checkpoint the insert rate, the
index build time, and recall@10 and pipelined QPS of the fast engine,
the beam, the exact flat scan and the native C++ HNSW (where the
library loads), each measured by ``evaluate_retrieval`` with the small
whitened exact scan as its control in the same window.

    python -m rag_cobweb_tpu_torch.scripts.scale_benchmark \\
        --vforest 64 --max-size 40000 --checkpoints 10000,40000

The fast row: with ``--vforest K``, ``VForest.build_index`` and
``vforest._vforest_query`` (the lanes' path-ranked top-k merged by leaf
log-prob); for one tree, ``index.blocked_query_topk_rerank`` (the leaf
log-prob re-rank of ``--rerank`` candidates; 0: ``blocked_query_topk``).
The beam row: ``VForest.beam_topk``, or ``index.beam_query_ids`` on the
tree's packed beam index.  Only queries whose gold is already inserted
count.  One JSON line per checkpoint.  Not carried over, as it exists
only for the TPU: the XLA compile cache.  The control's re-measure
threshold (90 ms a batch) is the JAX script's.
"""

import argparse
import json
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--max-size", type=int, default=100000)
    p.add_argument("--checkpoints", type=str, default="10000,40000,100000")
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=int, default=128)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--beam-width", type=int, default=128)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--vforest", type=int, default=0, metavar="K",
                   help="K-subtree forest build")
    p.add_argument("--rerank", type=int, default=128,
                   help="leaf-lp re-rank candidates of the single tree's "
                        "fast path (0 = pure path-score)")
    p.add_argument("--skip-beam", action="store_true")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.bench import native
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.parallel.vforest import _vforest_query
    from rag_cobweb_tpu_torch.scripts._sweeps import sync, whiten
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

    enable_persistent_cache()
    sizes = sorted(int(s) for s in args.checkpoints.split(","))
    sizes = [s for s in sizes if s <= args.max_size]
    data = synthetic_retrieval(args.max_size, args.queries, args.dim,
                               n_clusters=max(256, args.max_size // 256))
    # the whitening is fitted once on the first checkpoint's rows
    wh = PCAICAWhiteningModel.fit(data.corpus_embs[: sizes[0]],
                                  pca_dim=args.pca_dim, ica_max_iter=300)
    corpus_w = whiten(wh, data.corpus_embs, dev)
    queries_w = whiten(wh, data.query_embs, dev)

    db = CobwebIndex(config=TreeConfig(dim=corpus_w.shape[1]),
                     capacity=4 * args.max_size + 16,
                     n_subtrees=args.vforest or 1, device=dev)

    def dq(qb):
        return torch.as_tensor(np.asarray(qb, np.float32), device=dev)

    inserted = 0
    results = []
    for size in sizes:
        t0 = time.perf_counter()
        while inserted < size:
            n = min(args.chunk, size - inserted)
            db.add_sentences([None] * n, corpus_w[inserted:inserted + n])
            inserted += n
        sync(dev)
        dt = time.perf_counter() - t0
        rate = (size - (results[-1]["size"] if results else 0)) / dt
        t0 = time.perf_counter()
        pidx = db.build_prediction_index()
        sync(dev)
        index_s = time.perf_counter() - t0

        # only queries whose gold is already inserted
        mask = data.target_ids < size
        q = queries_w[mask]
        gold = data.target_ids[mask]

        flat = FlatIndex(data.corpus_embs[:size], metric="l2", device=dev)
        row = {"size": size, "insert_rate": round(rate, 1),
               "index_build_s": round(index_s, 2)}
        if args.vforest:
            fidx = db.forest.build_index()

            def cobweb_fast(qb, k):
                return _vforest_query(fidx, dq(qb), k)[1]

            def cobweb_beam(qb, k):
                return db.forest.beam_topk(qb, k,
                                           beam_width=args.beam_width)
        else:
            bidx = db._blocked_index()

            def cobweb_fast(qb, k):
                if args.rerank:
                    return index_mod.blocked_query_topk_rerank(
                        bidx, pidx, dq(qb), k, rerank=args.rerank)[1]
                return index_mod.blocked_query_topk(bidx, dq(qb), k)[1]

            def cobweb_beam(qb, k):
                md = -(-max(db.max_depth, 1) // 4) * 4
                return index_mod.beam_query_ids(
                    db._beam_index(), dq(qb), k,
                    beam_width=args.beam_width, max_depth=md)

        evals = [
            ("cobweb_fast", cobweb_fast, q, gold),
            ("flat_exact", flat.search_device, data.query_embs[mask], gold),
        ]
        if not args.skip_beam:
            evals.insert(1, ("cobweb_beam", cobweb_beam, q, gold))
        if native.available() and size <= 200_000:
            # HNSW on the whitened rows (the reference's "HNSW PCA+ICA")
            hnsw = native.make_native_hnsw_retriever(corpus_w[:size], ef=100)
            evals.append(("hnsw_cpp", hnsw, q, gold))
        # the control: a small whitened exact scan probed in each row's
        # window
        ctrl = FlatIndex(corpus_w[:min(size, 10000)], metric="l2",
                         device=dev)
        for name, fn, qq, gg in evals:
            in_w = qq is q   # the control only for whitened-space rows
            r = evaluate_retrieval(
                name, fn, qq, gg, args.k, batch_size=args.batch,
                control_fn=ctrl.search_device if in_w else None,
                control_threshold_ms=90.0)
            row[f"{name}_recall@{args.k}"] = round(
                r.get(f"recall@{args.k}", 0.0), 4)
            row[f"{name}_qps"] = round(r["qps"], 1)
            row[f"{name}_ms"] = round(r["avg_latency_ms"], 4)
            if "control_batch_ms" in r:
                row[f"{name}_control_batch_ms"] = round(
                    r["control_batch_ms"], 2)
                row[f"{name}_vs_control"] = round(
                    r["latency_vs_control"], 2)
                if r.get("control_requeued"):
                    row[f"{name}_control_requeued"] = True
        del ctrl, flat
        results.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
