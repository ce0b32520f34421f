"""Recall against the re-rank pool at the headline scale, on the card
(twin of ``scripts/pool_sweep_10k.py``): the hard set at c=10000, 1000
queries, 768-d, PCA+ICA at 0.96, a 32-lane forest, pools 512 to 4096,
each served by ``query_ids`` (kernel 1's exact pool over the fused
index, kernel 5's exact re-rank) and measured by ``evaluate_retrieval``
at batches of 1024; the exact scans over the raw and the whitened rows
first.

    python -m rag_cobweb_tpu_torch.scripts.pool_sweep_10k [--device cuda]

Each pool's ``approx=1`` line prints ``null`` for its numbers: PyTorch
has no ``approx_max_k`` and the port's pools are exact by design
(kernel 1 selects the exact top of every slab), so the approximate arm
has no counterpart; ``approx=0`` is the served engine.  Not carried
over, as they exist only for the TPU: the XLA compile cache and
``warmup_insert_programs``.
"""

import argparse

from rag_cobweb_tpu_torch.device import resolve_device

POOLS = (512, 1024, 2048, 4096)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval
    from rag_cobweb_tpu_torch.scripts._sweeps import (
        build_index, dataset, fit_whitener, whiten)
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    data = dataset("hard", 10000, 1000, 768)
    wh = fit_whitener(data.corpus_embs, 0.96)
    cw = whiten(wh, data.corpus_embs, dev)
    qw = whiten(wh, data.query_embs, dev)
    print(f"dim {cw.shape[1]}", flush=True)

    flat = FlatIndex(data.corpus_embs, metric="l2", device=dev)
    ex = evaluate_retrieval("exact-raw", flat.search_device,
                            data.query_embs, data.target_ids, 10,
                            batch_size=1024)
    print(f"exact(raw): recall@10={ex['recall@10']:.4f} "
          f"{ex['avg_latency_ms']:.3f} ms/q", flush=True)
    flatw = FlatIndex(cw, metric="l2", device=dev)
    exw = evaluate_retrieval("exact-whitened", flatw.search_device, qw,
                             data.target_ids, 10, batch_size=1024)
    print(f"exact(whitened): recall@10={exw['recall@10']:.4f}", flush=True)
    del flat, flatw

    db, _ = build_index(cw, 32, dev)
    rec = {"dim": int(cw.shape[1]), "exact_raw": ex["recall@10"],
           "exact_raw_ms": ex["avg_latency_ms"],
           "exact_whitened": exw["recall@10"], "pools": []}
    for pool in POOLS:
        for approx in (True, False):
            if approx:
                rec["pools"].append({"pool": pool, "approx": 1,
                                     "recall@10": None, "delta": None,
                                     "ms_per_query": None})
                print(f"pool={pool:5d} approx=1: recall@10=null "
                      "delta=null null ms/q", flush=True)
                continue
            db.query_ids(qw[:8], 10, rerank=pool)     # warm
            r = evaluate_retrieval(
                f"pool{pool}a0",
                lambda q, k: db.query_ids(q, k, rerank=pool),
                qw, data.target_ids, 10, batch_size=1024)
            rec["pools"].append({
                "pool": pool, "approx": 0, "recall@10": r["recall@10"],
                "delta": ex["recall@10"] - r["recall@10"],
                "ms_per_query": r["avg_latency_ms"]})
            print(f"pool={pool:5d} approx=0: "
                  f"recall@10={r['recall@10']:.4f} "
                  f"delta={ex['recall@10'] - r['recall@10']:+.4f} "
                  f"{r['avg_latency_ms']:.3f} ms/q", flush=True)
    return rec


if __name__ == "__main__":
    main()
