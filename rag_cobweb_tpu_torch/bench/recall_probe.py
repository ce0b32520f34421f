"""Where the card's flagship recall and the host's part.

    python -m rag_cobweb_tpu_torch.bench.recall_probe [--corpus-size N]
        [--queries Q] [--lanes K] [--out FILE]

The flagship configuration of ``bench/headline.py`` (hard synthetic
corpus, PCA+ICA at 0.96, K lanes, k=10, pool 1024), taken apart stage by
stage on one card and on the host:

1. whitening: the corpus whitened on the card and on the host, as a
   float32 product and accumulated in float64 (rounded once to float32);
   the rows that differ between the devices;
2. build: forests built on the card and on the host from the SAME rows,
   compared slot for slot (``state_to_numpy``, ``_leaf_global``); then a
   forest per whitening (card f32 rows, host f32 rows, float64 rows) and,
   where two part, the first insert (lane, round) whose leaf differs and a
   trace of that insert's descent from both row sets: at every step the
   two best children's insert gains and the four operation utilities,
   with the gap that decided;
3. serving: the host-built forest served on the card (kernels 1 and 5)
   and on the host (their plain versions), ids compared; each whitening's
   forest served with its own query whitening, recall@10 against the
   exact scan;
4. for each query whose gold hit differs between two servings: the gold's
   path score and rank against kernel 1's pool (and ``slab_topk_plain``'s
   on the same query) and kernel 5's keys against ``rerank_lp_plain``'s
   (the gold's key, the 10th and 11th).

``--whitener FILE`` adds a whitener fitted elsewhere (a
``PCAICAWhiteningModel.save`` pickle of the same corpus, e.g. from
another host's numpy and LAPACK): its matrices against this host's fit,
and its forest built and served on the card beside the others.

Prints a summary and writes the full record as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu_torch.bench.metrics import retrieval_metrics
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree, state_to_numpy
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.device import full_f32_matmul
from rag_cobweb_tpu_torch.ops import fused_topk, opscore, rerank
from rag_cobweb_tpu_torch.parallel.vforest import VForest
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Whitening:
    """The fitted whitener's affine transform as a float32 product (the
    port's transform before float64 accumulation) or accumulated in
    float64 and rounded once (``transform_torch``)."""

    def __init__(self, whitener: PCAICAWhiteningModel, f64: bool):
        self.dtype = torch.float64 if f64 else torch.float32
        self.dim_out = whitener.dim_out
        self.M, self.b = whitener.affine(np.float64 if f64 else np.float32)

    def transform_torch(self, x: torch.Tensor) -> torch.Tensor:
        M = torch.as_tensor(self.M, device=x.device)
        b = torch.as_tensor(self.b, device=x.device)
        return (torch.matmul(x.to(self.dtype), M) + b).float()


def serving_index(vf: VForest, whitener, corpus, device) -> CobwebIndex:
    """A flagship CobwebIndex around an already built forest."""
    db = CobwebIndex(config=vf.cfg, n_subtrees=vf.K, whitener=whitener,
                     device=device)
    db.forest = vf
    db.sentences = [None] * vf.n_sentences
    db.blocked_threshold = min(db.blocked_threshold, vf.n_sentences)
    raw = torch.as_tensor(np.ascontiguousarray(corpus, np.float32),
                          device=db.device)
    db._store_rows(raw, whitener.transform_torch(raw))
    return db


def forest_diff(a: VForest, b: VForest) -> dict:
    """Slot-for-slot comparison of two forests and the first differing
    insert: (round, lane) of the first leaf that differs, in round
    order."""
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    out = {"leaf_global_equal": bool(np.array_equal(a._leaf_global(),
                                                    b._leaf_global()))}
    for f in ("parent", "children", "n_children", "counts"):
        out[f"{f}_equal"] = bool(np.array_equal(sa[f], sb[f]))
    for f in ("means", "m2s"):
        out[f"{f}_max_abs_diff"] = float(np.abs(sa[f] - sb[f]).max())
    first = None
    for lane in range(a.K):
        la, lb = a._leaf_of_local[lane], b._leaf_of_local[lane]
        for r, (x, y) in enumerate(zip(la, lb)):
            if x != y:
                if first is None or r < first[0]:
                    first = (r, lane)
                break
    out["first_differing_insert"] = (
        None if first is None else
        {"round": first[0], "lane": first[1],
         "row": int(first[0] * a.K + first[1])})
    out["lanes_differing"] = [
        i for i, (la, lb) in enumerate(zip(a._leaf_of_local,
                                           b._leaf_of_local)) if la != lb]
    return out


def trace_insert(tree: CobwebTree, x: torch.Tensor) -> dict:
    """Insert ``x`` into a host tree, recording at each descent step the
    two best children's insert gains and the four operation utilities
    (best, new, merge, split; invalid ones None)."""
    steps = []
    tb0, bo0 = opscore.two_best_children, opscore.best_operation

    def two_best(x_, parent, children, mask, cfg, noise):
        out = tb0(x_, parent, children, mask, cfg, noise)
        if bool(mask.any()):
            gain = opscore.insert_gains(x_, parent, children, cfg)
            g = gain[0][mask[0]].double().numpy()
            srt = np.sort(g)[::-1]
            steps.append({"children": int(mask.sum()),
                          "best1": int(out.best1[0]),
                          "best2": int(out.best2[0]),
                          "gains": [float(v) for v in g],
                          "gain_gap_1_2": float(srt[0] - srt[1])
                          if len(srt) > 1 else None})
        return out

    def best_op(x_, parent, children, mask, tb, gc, gc_mask, cfg, noise,
                full, fits):
        op, u = bo0(x_, parent, children, mask, tb, gc, gc_mask, cfg, noise,
                    full, fits)
        if bool(mask.any()):
            util, valid = opscore.operation_utilities(
                x_, parent, children, mask, tb, gc, gc_mask, cfg, full, fits)
            vals = [float(v) if ok else None
                    for v, ok in zip(util[0].double(), valid[0])]
            ok = sorted((v for v in vals if v is not None), reverse=True)
            steps[-1].update(op=["best", "new", "merge", "split"][int(op[0])],
                             utilities=vals,
                             op_gap=float(ok[0] - ok[1]) if len(ok) > 1
                             else None)
        return op, u

    opscore.two_best_children, opscore.best_operation = two_best, best_op
    try:
        leaf = tree.ifit(x)
    finally:
        opscore.two_best_children, opscore.best_operation = tb0, bo0
    return {"leaf": leaf, "steps": steps}


def near_tie(rows: dict, K: int, lane: int, j: int, cfg,
             forest: VForest) -> dict:
    """The ``j``-th insert of ``lane`` traced from each row set: the lane's
    tree rebuilt on the host as one tree from the lane's first ``j`` rows
    (round-robin lanes, no retries: checked by rebuilding the whole lane
    and comparing its leaves with ``forest``'s), then that insert."""
    out = {"lane": lane, "insert": j}
    for name, r in rows.items():
        lr = r[lane::K].cpu()
        t = CobwebTree(cfg, capacity=4 * len(lr) + 16, device="cpu")
        t.fit(lr[:j], batch_size=len(lr))
        out[name] = trace_insert(t, lr[j])
    name0 = next(iter(rows))
    lr = rows[name0][lane::K].cpu()
    t = CobwebTree(cfg, capacity=4 * len(lr) + 16, device="cpu")
    out["replay_equals_forest_lane"] = bool(
        list(t.fit(lr, batch_size=len(lr))) == forest._leaf_of_local[lane])
    return out


def query_detail(db: CobwebIndex, q_raw: np.ndarray, gold: int, k: int,
                 pool: int) -> dict:
    """Kernel 1's and kernel 5's view of one query on the card, beside
    their plain versions on the same inputs."""
    fidx = db._fused_index()
    emb = db._emb_device()
    qs = torch.as_tensor(q_raw[None], device=db.device)
    q = db.whitener.transform_torch(qs)
    qq = fused_topk.query_terms(q, fidx.GT.dtype)
    kappa = min(pool, fused_topk.SLAB)
    full = fused_topk.slab_scores_plain(qq, fidx.GT, fidx.c, fidx.valid,
                                        float("-inf")).reshape(-1)
    out = {"gold": gold, "gold_path_score": float(full[gold]),
           "gold_path_rank": int((full > full[gold]).sum()) + 1}
    pools = {}
    for name, fn in (("kernel", fused_topk.slab_topk),
                     ("plain", fused_topk.slab_topk_plain)):
        cs, cand = fused_topk.merge(*fn(qq, fidx.GT, fidx.c, fidx.valid,
                                        kappa), pool)
        pools[name] = (cs, cand)
        out[f"gold_in_{name}_pool"] = bool(gold in cand[0].tolist())
        out[f"{name}_pool_last_score"] = float(cs[0, -1])
    out["pools_equal_as_sets"] = bool(
        set(pools["kernel"][1][0].tolist())
        == set(pools["plain"][1][0].tolist()))
    cs, cand = pools["kernel"]
    cand32 = cand.to(torch.int32).contiguous()
    pv = float(db.cfg.prior_var)
    keys = {}
    for name, fn in (("kernel", rerank.rerank_lp),
                     ("plain", rerank.rerank_lp_plain)):
        lp = fn(emb, qs.float().contiguous(), cand32, cs.contiguous(), pv)[0]
        top, pos = torch.topk(lp, k + 1)
        keys[name] = lp
        g = np.nonzero(cand[0].cpu().numpy() == gold)[0]
        out[f"{name}_top_ids"] = [int(v) for v in cand[0][pos][:k]]
        out[f"{name}_key_10th"] = float(top[k - 1])
        out[f"{name}_key_11th"] = float(top[k])
        out[f"{name}_gold_key"] = float(lp[g[0]]) if len(g) else None
    fin = torch.isfinite(keys["plain"])
    out["key_max_abs_diff"] = float(
        (keys["kernel"][fin] - keys["plain"][fin]).abs().max())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus-size", type=int, default=10000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pool", type=int, default=1024)
    ap.add_argument("--whitener", default=None,
                    help="a whitener of the same corpus fitted elsewhere")
    ap.add_argument("--out", default="chiprun_out/recall_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("recall_probe: needs a CUDA device")
    full_f32_matmul()
    rec: dict = {"device": torch.cuda.get_device_name(0)}
    data = synthetic_retrieval_hard(args.corpus_size, args.queries, args.dim)
    fitted = PCAICAWhiteningModel.fit(
        data.corpus_embs, pca_dim=0.96, ica_max_iter=500, seed=0,
        ica_sample_size=10000)
    corpus, k, pool, K = data.corpus_embs, args.k, args.pool, args.lanes
    import numpy
    rec["host"] = {"numpy": numpy.__version__,
                   "torch": torch.__version__}
    whiten = {"f32": Whitening(fitted, False), "f64": Whitening(fitted, True)}
    raw = {"card": torch.as_tensor(corpus, device="cuda"),
           "host": torch.as_tensor(corpus)}
    rows = {f"{dev}_{m}": w.transform_torch(raw[dev]).cpu()
            for m, w in whiten.items() for dev in raw}
    if args.whitener:
        given = PCAICAWhiteningModel.load(args.whitener)
        whiten["given"] = Whitening(given, True)
        rows["card_given"] = whiten["given"].transform_torch(
            raw["card"]).cpu()
        M0, M1 = whiten["f64"].M, whiten["given"].M
        rec["given_whitener"] = {
            "dim_out": given.dim_out,
            "M_max_abs_diff": float(np.abs(M0 - M1).max())
            if M0.shape == M1.shape else None,
            "M_max_abs": float(np.abs(M0).max()),
            "explained_var_max_rel_diff": float(np.abs(
                fitted.pca_explained_var[:given.dim_out]
                - given.pca_explained_var[:fitted.dim_out])
                .max() / fitted.pca_explained_var.max()),
            "rows_max_abs_diff": float((rows["card_given"]
                                        - rows["card_f64"]).abs().max()),
        }
        log(f"[probe] given whitener vs this host's fit: "
            f"{rec['given_whitener']}")
    rec["whitening"] = {
        m: {"rows_differing_card_host": int(
            (rows[f"card_{m}"] != rows[f"host_{m}"]).any(1).sum()),
            "max_abs_diff": float((rows[f"card_{m}"]
                                   - rows[f"host_{m}"]).abs().max())}
        for m in ("f32", "f64")}
    log(f"[probe] whitening card vs host: {rec['whitening']}")

    cfg = TreeConfig(dim=fitted.dim_out)
    cap = max(1024, (4 * len(corpus) + 16) // K)

    def build(r, dev):
        vf = VForest(cfg, n_subtrees=K, capacity_per_tree=cap, device=dev)
        vf.add(r.to(dev))
        return vf

    forests = {name: build(r, "cuda") for name, r in rows.items()}
    same_rows_host = build(rows["card_f32"], "cpu")
    rec["build_card_vs_host_same_rows"] = forest_diff(forests["card_f32"],
                                                      same_rows_host)
    log(f"[probe] build card vs host, same rows: "
        f"{rec['build_card_vs_host_same_rows']}")
    rec["forests"] = {}
    pairs = [("card_f32", "host_f32"), ("card_f64", "host_f64"),
             ("card_f32", "card_f64"), ("host_f32", "card_f64")]
    if args.whitener:
        pairs.append(("card_f64", "card_given"))
    for a, b in pairs:
        d = forest_diff(forests[a], forests[b])
        rec["forests"][f"{a} vs {b}"] = d
        log(f"[probe] forest {a} vs {b}: {d}")
    first = rec["forests"]["card_f32 vs host_f32"]["first_differing_insert"]
    if first is not None:
        rec["near_tie"] = near_tie(
            {"card_f32": rows["card_f32"], "host_f32": rows["host_f32"]}, K,
            first["lane"], first["round"], cfg, forests["card_f32"])
        log("[probe] near tie: " + json.dumps(rec["near_tie"]))

    flat = FlatIndex(corpus, metric="l2", device="cuda")
    served = {"exact": flat.search(data.query_embs, k)}
    servings = {
        # (forest, whitening, serving device)
        "card_f32 on card": ("card_f32", "f32", "cuda"),
        "host_f32 on host": ("host_f32", "f32", "cpu"),
        "host_f32 on card": ("host_f32", "f32", "cuda"),
        "card_f64 on card": ("card_f64", "f64", "cuda"),
        "host_f64 on host": ("host_f64", "f64", "cpu"),
    }
    if args.whitener:
        servings["card_given on card"] = ("card_given", "given", "cuda")
    dbs = {}
    for name, (fname, m, dev) in servings.items():
        vf = forests[fname]
        if dev == "cpu":
            meta = {"cfg": cfg, "shard_of": vf.shard_of,
                    "local_sid": vf.local_sid,
                    "leaf_of_local": vf._leaf_of_local}
            vf = interop.forest_from_numpy(state_to_numpy(vf.state), meta,
                                           device="cpu")
        dbs[name] = serving_index(vf, whiten[m], corpus, dev)
        t0 = time.perf_counter()
        served[name] = dbs[name].query_ids(data.query_embs, k,
                                           rerank=pool).cpu().numpy()
        log(f"[probe] served {name} {time.perf_counter() - t0:.1f}s")
    rec["recall@10"] = {
        name: retrieval_metrics(ids, data.target_ids, k)["recall@10"]
        for name, ids in served.items()}
    log(f"[probe] recall@10: {rec['recall@10']}")
    rec["served"] = {}
    look = set()
    names = [n for n in served if n != "exact"]
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            diff = np.nonzero((served[a] != served[b]).any(axis=1))[0]
            gold = [int(q) for q in diff
                    if (data.target_ids[q] in served[a][q])
                    != (data.target_ids[q] in served[b][q])]
            rec["served"][f"{a} vs {b}"] = {"ids_differ": int(len(diff)),
                                            "gold_hit_differs": gold}
            look.update(gold)
            log(f"[probe] {a} vs {b}: ids differ on {len(diff)} queries; "
                f"gold hit differs on {gold}")
    rec["query_details"] = {}
    for q in sorted(look):
        det = {"served": {n: [int(v) for v in served[n][q]]
                          for n in served}}
        for name, db in dbs.items():
            if db.device.type == "cuda":
                det[name] = query_detail(db, data.query_embs[q],
                                         int(data.target_ids[q]), k, pool)
        rec["query_details"][int(q)] = det
        log(f"[probe] query {q}: " + json.dumps(
            {n: v for n, v in det.items() if n != "served"}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({x: rec[x] for x in ("whitening", "recall@10",
                                          "served")}))


if __name__ == "__main__":
    main()
