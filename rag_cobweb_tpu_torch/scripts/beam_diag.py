"""Forest-beam recall diagnostic on the card (twin of
``scripts/beam_diag.py``): where is beam recall lost?

  1. routing coverage: is the gold row's lane among the query's top-L
     lanes (``VForest.select_lanes``; round-robin probes every lane)?
  2. beam pool coverage: does the gold row appear among the rows of
     every leaf the lane-fair packed beam kept
     (``index.beam_pack_topk_lanes``, expanded by
     ``index.leaf_runs_to_sids`` up to 512 rows)?
  3. the final recall@k (the same leaves cut at k rows).

    python -m rag_cobweb_tpu_torch.scripts.beam_diag \\
        --corpus-size 10000 --routing content [--device cuda]

The beam engine is plain PyTorch, as XLA ran it: no kernel launches
here.  Lines go to standard error as in the JAX script; ``main``
returns them as a record.  Not carried over, as they exist only for the
TPU: the XLA compile cache and ``warmup_insert_programs``.
"""

import argparse

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus-size", type=int, default=10000)
    p.add_argument("--queries", type=int, default=500)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=float, default=0.96)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--lanes", type=int, default=64)
    p.add_argument("--widths", type=str, default="4,8,16")
    p.add_argument("--probe-lanes", type=str, default="4,8,16,0")
    p.add_argument("--routing", choices=["round_robin", "content"],
                   default="content")
    p.add_argument("--dataset", choices=["hard", "easy"], default="easy")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.scripts._sweeps import (
        build_index, dataset, fit_whitener, log, recall, whiten)
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    data = dataset(args.dataset, args.corpus_size, args.queries, args.dim)
    gold = data.target_ids
    wm = fit_whitener(data.corpus_embs, args.pca_dim)
    cw = whiten(wm, data.corpus_embs, dev)
    qw = whiten(wm, data.query_embs, dev)

    db, build_s = build_index(cw, args.lanes, dev, routing=args.routing)
    log(f"[diag] build {build_s:.1f}s ({args.routing}, {args.lanes} lanes)")
    f = db.forest
    rec = {"build_s": build_s, "routing_coverage": {}, "beam": []}

    # the lane of every sentence
    lane_of_sid = np.asarray(f.shard_of, np.int64)
    lane_sizes = np.bincount(lane_of_sid, minlength=f.K)
    rec["lane_sizes"] = [int(lane_sizes.min()), float(lane_sizes.mean()),
                         int(lane_sizes.max())]
    log(f"[diag] lane sizes: min {lane_sizes.min()} "
        f"mean {lane_sizes.mean():.0f} max {lane_sizes.max()}")

    probe_list = [int(x) for x in args.probe_lanes.split(",")]
    for L in probe_list:
        Lp = f.K if L == 0 else L
        sel = f.select_lanes(qw, Lp)                       # (B, Lp)
        hit = float(np.mean([lane_of_sid[g] in row
                             for g, row in zip(gold, sel)]))
        rec["routing_coverage"][Lp] = hit
        log(f"[diag] routing coverage L={Lp}: gold-lane hit {hit:.4f}")

    bidx = f.beam_index()
    md = -(-max(f._beam_depth, 1) // 4) * 4
    q = torch.as_tensor(qw, device=dev)
    for W in [int(x) for x in args.widths.split(",")]:
        for L in probe_list:
            Lp = f.K if L == 0 else L
            roots = None
            n_lanes = f.K
            if Lp < f.K:
                n_lanes = Lp
                roots = torch.as_tensor(f.select_lanes(qw, Lp),
                                        device=dev)
            scores, leaves = index_mod.beam_pack_topk_lanes(
                bidx, q, args.k, lane_width=W, max_depth=md,
                n_lanes=n_lanes, roots=roots)
            # pool coverage: every surviving leaf expanded to its rows
            M = leaves.shape[1]
            pool = index_mod.leaf_runs_to_sids(
                bidx.leaf_sentence_start, bidx.leaf_sentence_count,
                bidx.sentence_order, leaves, scores,
                min(4 * M, 512)).cpu().numpy()
            cov = float(np.mean([g in row for g, row in zip(gold, pool)]))
            ids = index_mod.leaf_runs_to_sids(
                bidx.leaf_sentence_start, bidx.leaf_sentence_count,
                bidx.sentence_order, leaves, scores, args.k)
            r = recall(ids, gold, args.k)
            rec["beam"].append({"width": W, "lanes": Lp,
                                "pool_coverage": cov, "recall": r})
            log(f"[diag] W={W} L={Lp}: pool-coverage {cov:.4f} "
                f"recall@{args.k} {r:.4f}")
    return rec


if __name__ == "__main__":
    main()
