"""Whitening-dimension sweep at c=10000 on the hard set, on the card
(twin of ``scripts/pcadim_sweep_10k.py``): the engine serves at the
whitened exact ceiling (``pool_sweep_10k``), so the recall gap to the
raw exact scan is set by what ``pca_dim`` drops.  For each variance
fraction (0.98, 0.99, 0.995): PCA+ICA, the whitened exact scan, a
32-lane forest, and its recall at pool 1024 (``query_ids``: kernel 1's
exact pool, kernel 5's re-rank), each by ``evaluate_retrieval`` at
batches of 1024.

    python -m rag_cobweb_tpu_torch.scripts.pcadim_sweep_10k [--device cuda]

Not carried over, as they exist only for the TPU: the XLA compile cache
and ``warmup_insert_programs``.
"""

import argparse

from rag_cobweb_tpu_torch.device import resolve_device

FRACTIONS = (0.98, 0.99, 0.995)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    import torch

    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval
    from rag_cobweb_tpu_torch.scripts._sweeps import (
        build_index, dataset, fit_whitener, whiten)
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    data = dataset("hard", 10000, 1000, 768)
    flat = FlatIndex(data.corpus_embs, metric="l2", device=dev)
    ex = evaluate_retrieval("exact-raw", flat.search_device,
                            data.query_embs, data.target_ids, 10,
                            batch_size=1024)
    print(f"exact(raw): recall@10={ex['recall@10']:.4f}", flush=True)
    del flat
    rec = {"exact_raw": ex["recall@10"], "fractions": []}

    for frac in FRACTIONS:
        wh = fit_whitener(data.corpus_embs, frac)
        cw = whiten(wh, data.corpus_embs, dev)
        qw = whiten(wh, data.query_embs, dev)
        flatw = FlatIndex(cw, metric="l2", device=dev)
        exw = evaluate_retrieval("exact-w", flatw.search_device, qw,
                                 data.target_ids, 10, batch_size=1024)
        del flatw
        db, _ = build_index(cw, 32, dev)
        db.query_ids(qw[:8], 10, rerank=1024)      # warm
        r = evaluate_retrieval(
            "cobweb", lambda q, k: db.query_ids(q, k, rerank=1024),
            qw, data.target_ids, 10, batch_size=1024)
        rec["fractions"].append({
            "frac": frac, "dim": int(cw.shape[1]),
            "exact_whitened": exw["recall@10"], "cobweb": r["recall@10"],
            "delta_vs_raw": ex["recall@10"] - r["recall@10"],
            "ms_per_query": r["avg_latency_ms"]})
        print(f"frac={frac} dim={cw.shape[1]}: "
              f"exact_w={exw['recall@10']:.4f} "
              f"cobweb={r['recall@10']:.4f} "
              f"delta_vs_raw={ex['recall@10'] - r['recall@10']:+.4f} "
              f"{r['avg_latency_ms']:.3f} ms/q", flush=True)
        del db
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


if __name__ == "__main__":
    main()
