"""Tuning surface on the card (twin of ``scripts/tuning_sweep.py``):
recall against the re-rank pool and against the beam width on the hard
(or easy) synthetic set, so that the serving defaults come from measured
curves.

    python -m rag_cobweb_tpu_torch.scripts.tuning_sweep \\
        --corpus-size 100000 [--out tuning.json] [--device cuda]

The pool curve is ``CobwebIndex.query_ids(q, k, rerank=pool)`` for each
pool: from ``blocked_threshold`` rows the fused engine, kernel 1's exact
pool and kernel 5's re-rank (``rerank=0``: the path-score order, kernel
1's f32 entry); below it the small-forest engine.  The beam curve is
``VForest.beam_topk(q, k, beam_width=w, lanes_per_query=L)``.  Each point
is timed after a warm call, with a synchronize after the call.  The
exact ceilings on the raw and on the whitened rows come first.  Progress
goes to standard error, the record (the JAX script's keys) to standard
output.  Not carried over, as they exist only for the TPU: the XLA
compile cache and ``warmup_insert_programs``.
"""

import argparse
import json
import os
import time

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus-size", type=int, default=100000)
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=float, default=0.96)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--lanes", type=int, default=64)
    p.add_argument("--pools", type=str, default="0,64,128,256,512,1024,2048")
    p.add_argument("--widths", type=str, default="2,4,8,16,32")
    p.add_argument("--beam-lanes", type=str, default="0",
                   help="comma list of lanes_per_query for the beam curve "
                        "(0 = all lanes)")
    p.add_argument("--routing", choices=["round_robin", "content"],
                   default="round_robin")
    p.add_argument("--dataset", choices=["hard", "easy"], default="hard")
    p.add_argument("--skip-beam", action="store_true")
    p.add_argument("--skip-pools", action="store_true")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.scripts._sweeps import (
        build_index, dataset, exact_recall, fit_whitener, log, recall, sync,
        whiten)
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    data = dataset(args.dataset, args.corpus_size, args.queries, args.dim)
    gold = data.target_ids
    exact_raw = exact_recall(data.corpus_embs, data.query_embs, gold,
                             args.k, dev)
    wh = fit_whitener(data.corpus_embs, args.pca_dim)
    cw = whiten(wh, data.corpus_embs, dev)
    qw = whiten(wh, data.query_embs, dev)
    exact_w = exact_recall(cw, qw, gold, args.k, dev)
    log(f"[sweep] exact raw {exact_raw} whitened {exact_w} "
        f"(dim {cw.shape[1]})")

    db, build_s = build_index(cw, args.lanes, dev, routing=args.routing)
    log(f"[sweep] build {build_s:.1f}s")

    out = {"corpus_size": args.corpus_size, "dim": int(cw.shape[1]),
           "dataset": data.name, "routing": args.routing,
           "exact_raw": exact_raw, "exact_whitened": exact_w,
           "pool_curve": [], "beam_curve": []}

    def timed(fn):
        fn()                        # warm
        sync(dev)
        t0 = time.perf_counter()
        ids = fn()
        sync(dev)
        return ids, (time.perf_counter() - t0) * 1e3 / len(qw)

    for pool in ([] if args.skip_pools
                 else [int(x) for x in args.pools.split(",")]):
        ids, dt = timed(lambda: db.query_ids(qw, args.k, rerank=pool))
        r = recall(ids, gold, args.k)
        out["pool_curve"].append(
            {"pool": pool, "recall": round(r, 4),
             "ms_per_query": round(dt, 4)})
        log(f"[sweep] pool={pool}: recall {r:.4f} ({dt:.3f} ms/q warm)")

    if not args.skip_beam:
        lane_list = [int(x) for x in args.beam_lanes.split(",")]
        for w in [int(x) for x in args.widths.split(",")]:
            for L in lane_list:
                lpq = None if L == 0 else L
                ids, dt = timed(lambda: db.forest.beam_topk(
                    qw, args.k, beam_width=w, lanes_per_query=lpq))
                r = recall(ids, gold, args.k)
                out["beam_curve"].append(
                    {"beam_width": w, "lanes_per_query": L,
                     "recall": round(r, 4), "ms_per_query": round(dt, 4)})
                log(f"[sweep] beam={w} lanes={L or 'all'}: recall {r:.4f} "
                    f"({dt:.3f} ms/q)")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
