"""The served path at 1M rows taken apart on the card (twin of
``scripts/pipeline_probe.py``): the grouped pool against the exact one,
the sweep and the re-rank split into sub-chunks on two CUDA streams, each
stage alone, small batches and the roofline composite.

    python -m rag_cobweb_tpu_torch.scripts.pipeline_probe [--cache W.npz] \\
        [--size 1000000] [--vforest 512] [--batch 1024] [--pool 1024] \\
        [--k 10] [--probes 5] [--out build/experiments/...json] \\
        [--device cuda]

``--cache``: a whitened cache (``corpus_w``, ``queries_w``), from
``derive_caches``; the forest is built on its first ``--size`` rows
without a whitener (the store holds the whitened rows), in adds of
``--vforest`` x 128 rows.  Rows of the record, each the median wall ms
of ``--probes`` synchronized calls on distinct rotated query batches:

* ``one_program_grouped_pool``: kernel 2 (``ops/fused_topk.
  fused_group_topk``: the top ``per_group`` of every 128 adjacent rows,
  merged to the pool) and kernel 5's re-rank.  The JAX script's arm
  meant the strided grouped pool (``index.grouped_pool_topk``) but never
  ran it: its threshold is 2^62 columns, so both of its arms took
  ``approx_max_k`` (a reference fault, ROADMAP queue C); here the arm
  really launches kernel 2 (``per_group``: the least, from 2, that gives
  the pool enough candidates).
* ``one_program_approx_max_k``: the served ``query_ids`` (kernel 1's
  exact pool, kernel 5).  PyTorch has no ``approx_max_k``; the key keeps
  the JAX name and holds kernel 1's exact pool, so
  ``approx_vs_exactpool`` is 1 by construction.
* ``pool_top10_overlap``, ``grouped_vs_exactpool``,
  ``approx_vs_exactpool``: top-10 overlaps on the first batch;
  ``strided_grouped_vs_exactpool``: the JAX arm's algorithm
  (``grouped_pool_topk`` over the plain f32 scores, then kernel 5).
* ``split_interleaved_4x``: 4 sub-chunks, sweep i+1 (kernel 1 and its
  merge) on one CUDA stream while re-rank i (kernel 5 and the top-k)
  runs on another; ``split_overlap`` says, from CUDA events on both
  streams, how many ms the two streams' intervals overlapped.
  ``split_sequential_4x``: the same calls on one stream;
  ``one_program_4x_subchunks``: ``fused_query_rerank`` a sub-chunk.
* ``stage_sweep_pool_only``, ``stage_rerank_only``,
  ``stage_gather_only`` (``emb[cand]`` summed), the whole batch at once.
* ``b1_latency``, ``b32_latency``, ``b256_latency``: median of 7.
* the roofline composite (``bench/roofline.product_path_model``) of the
  two one-program arms, ``config``.

Writes ``--out`` (under the git-ignored ``build/experiments/`` by
default; the JAX script writes under ``outputs/``).  ``probe`` takes a
built index, so a caller that has one (``chip_smoke.py`` phase 3n) runs
it without a second build.  Not carried over, as they exist only for the
TPU: the XLA compile cache and ``warmup_insert_programs``.
"""

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device

EXPERIMENTS = Path(__file__).resolve().parents[2] / "build" / "experiments"


def _ovl(a, b, k: int) -> float:
    return float(np.mean([len(set(x) & set(y)) / k
                          for x, y in zip(a.tolist(), b.tolist())]))


def build(corpus: np.ndarray, lanes: int, device, log=print):
    """(the forest index over ``corpus``, build seconds), the JAX script's
    capacity and adds."""
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.scripts._sweeps import sync
    K, n = lanes, len(corpus)
    db = CobwebIndex(config=TreeConfig(dim=corpus.shape[1]),
                     capacity=K * max(2048, int(1.6 * n) // K + 64),
                     n_subtrees=K, seed=0, device=device)
    t0 = time.perf_counter()
    chunk = K * 128
    for s in range(0, n, chunk):
        db.add_sentences([None] * len(corpus[s:s + chunk]),
                         corpus[s:s + chunk])
    sync(device)
    build_s = time.perf_counter() - t0
    log(f"[probe] build {build_s:.1f}s ({n/build_s:.0f}/s)", flush=True)
    return db, build_s


def probe(db, queries: np.ndarray, batch: int = 1024, pool: int = 1024,
          k: int = 10, probes: int = 5, log=print) -> dict:
    """The record's rows on the built index ``db`` (no whitener) with the
    whitened ``queries``."""
    from rag_cobweb_tpu_torch.bench import roofline as rl
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.ops import fused_topk
    from rag_cobweb_tpu_torch.scripts._sweeps import sync

    dev = db.device
    card = dev.type == "cuda"
    fidx = db._fused_index()
    emb = db._emb_device()
    Sp = fidx.num_slots
    D = fidx.GT.shape[0] // 2
    pv = float(db.cfg.prior_var)
    B = batch
    nq = len(queries)
    NS = Sp // fused_topk.SLAB
    per_group = min(fused_topk.GROUP,
                    max(2, -(-pool // (NS * fused_topk.NG))))
    log(f"[probe] Sp={Sp} slots, pool={pool}, B={B}, kernel 2 per_group "
        f"{per_group}", flush=True)
    rows = {}

    def probe_ms(fn, n=None):
        lats = []
        for i in range(n or probes):
            off = (i * 131) % (nq - B + 1)
            qb = np.ascontiguousarray(queries[off:off + B])
            t1 = time.perf_counter()
            fn(qb)
            sync(dev)
            lats.append(time.perf_counter() - t1)
        return float(np.median(lats)), lats

    def record(name, fn):
        fn(queries[:B])
        sync(dev)
        med, lats = probe_ms(fn)
        rows[name] = {"batch_ms": round(1e3 * med, 2),
                      "ms_per_query": round(1e3 * med / B, 4),
                      "all_ms": [round(1e3 * x, 1) for x in lats]}
        log(f"[probe] {name}: {1e3*med:.1f} ms/batch "
            f"({1e3*med/B:.4f} ms/q)", flush=True)
        return med

    def up(qb):
        return torch.as_tensor(np.asarray(qb, np.float32), device=dev)

    def sweep(qd):
        return index_mod.fused_query_topk(fidx, qd, pool)

    def rerank(qd, cs, cand):
        return index_mod.exact_rerank(emb, qd, cand, cs, k, pv)

    def grouped(qb):
        qd = up(qb)
        cs, cand = fused_topk.fused_group_topk(fidx, qd, pool, per_group)
        live = cs > fused_topk.NEG / 2
        cs = torch.where(live, cs, torch.full_like(cs, float("-inf")))
        return rerank(qd, cs, torch.where(live, cand,
                                          torch.zeros_like(cand)))[1]

    def product(qb):
        return db.query_ids(qb, k, rerank=pool)

    record("one_program_grouped_pool", grouped)
    record("one_program_approx_max_k", product)
    q0 = queries[:B]
    ids_g = grouped(q0).cpu().numpy()
    ids_e = product(q0).cpu().numpy()
    ids_a = ids_e          # the exact pool stands for approx_max_k's
    rows["pool_top10_overlap"] = _ovl(ids_g, ids_a, k)
    rows["grouped_vs_exactpool"] = _ovl(ids_g, ids_e, k)
    rows["approx_vs_exactpool"] = _ovl(ids_a, ids_e, k)
    qd0 = up(q0)
    cs_s, cand_s = index_mod.grouped_pool_topk(
        index_mod.fused_scores(fidx, qd0), pool)
    cand_s = torch.where(torch.isfinite(cs_s), cand_s,
                         torch.zeros_like(cand_s))
    ids_s = rerank(qd0, cs_s, cand_s)[1].cpu().numpy()
    rows["strided_grouped_vs_exactpool"] = _ovl(ids_s, ids_e, k)
    del cs_s, cand_s
    log(f"[probe] grouped (kernel 2) vs exact pool "
        f"{rows['grouped_vs_exactpool']:.4f}; strided grouped "
        f"{rows['strided_grouped_vs_exactpool']:.4f}", flush=True)

    sub = B // 4
    overlap = {"ms": [], "pairs": 0}

    def split_interleaved(qb):
        qd = up(qb)
        if not card:
            return split_sequential(qb)
        main = torch.cuda.current_stream(dev)
        s_sw, s_rr = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        s_sw.wait_stream(main)
        keep, outs, spans = [qd], [], []

        def ev(stream):
            e = torch.cuda.Event(enable_timing=True)
            e.record(stream)
            return e

        t_start = ev(main)
        pend = None
        for s in range(0, B, sub):
            qc = qd[s:s + sub]
            with torch.cuda.stream(s_sw):
                a = ev(s_sw)
                cs, cand = sweep(qc)
                done = ev(s_sw)
            spans.append(("sweep", a, done))
            keep += [cs, cand]
            if pend is not None:
                outs.append(rr_on(s_rr, pend, spans))
            pend = (qc, cs, cand, done)
        outs.append(rr_on(s_rr, pend, spans))
        main.wait_stream(s_rr)
        sync(dev)           # ``keep`` held every operand until here
        sw = [(t_start.elapsed_time(a), t_start.elapsed_time(b))
              for kind, a, b in spans if kind == "sweep"]
        rr = [(t_start.elapsed_time(a), t_start.elapsed_time(b))
              for kind, a, b in spans if kind == "rerank"]
        both = sum(max(0.0, min(b1, b2) - max(a1, a2))
                   for a1, b1 in sw for a2, b2 in rr)
        overlap["ms"].append(both)
        overlap["pairs"] = len(rr)
        return outs

    def rr_on(stream, pend, spans):
        qc, cs, cand, done = pend
        with torch.cuda.stream(stream):
            stream.wait_event(done)
            a = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            out = rerank(qc, cs, cand)[1]
            b = torch.cuda.Event(enable_timing=True)
            b.record(stream)
        spans.append(("rerank", a, b))
        return out

    def split_sequential(qb):
        qd = up(qb)
        outs = []
        for s in range(0, B, sub):
            qc = qd[s:s + sub]
            cs, cand = sweep(qc)
            outs.append(rerank(qc, cs, cand)[1])
        return outs

    def one_program_subchunks(qb):
        qd = up(qb)
        return [index_mod.fused_query_rerank(
            fidx, emb, qd[s:s + sub], qd[s:s + sub], k, pool,
            prior_var=pv)[1] for s in range(0, B, sub)]

    record("split_interleaved_4x", split_interleaved)
    record("split_sequential_4x", split_sequential)
    record("one_program_4x_subchunks", one_program_subchunks)
    split_ids = torch.cat(split_interleaved(q0)).cpu().numpy()
    rows["split_overlap"] = (
        {"overlap_ms_median": float(np.median(overlap["ms"])),
         "overlap_ms": [round(x, 4) for x in overlap["ms"]],
         "overlapped": bool(np.median(overlap["ms"]) > 0),
         "rerank_sweep_pairs": overlap["pairs"],
         "ids_equal_one_program": bool(np.array_equal(split_ids, ids_e))}
        if card else None)

    record("stage_sweep_pool_only", lambda qb: sweep(up(qb)))
    cs0, cand0 = sweep(qd0)
    record("stage_rerank_only", lambda qb: rerank(up(qb), cs0, cand0))
    record("stage_gather_only",
           lambda qb: torch.sum(emb[cand0.long()], dim=(1, 2)))

    for bs in (1, 32, 256):
        db.query_ids(queries[:bs], k, rerank=pool)
        sync(dev)
        lats = []
        for i in range(7):
            off = (i * 131) % (nq - bs + 1)
            qb = np.ascontiguousarray(queries[off:off + bs])
            t1 = time.perf_counter()
            db.query_ids(qb, k, rerank=pool)
            sync(dev)
            lats.append(time.perf_counter() - t1)
        med = float(np.median(lats))
        rows[f"b{bs}_latency"] = {"batch_ms": round(1e3 * med, 2),
                                  "ms_per_query": round(1e3 * med / bs, 4)}
        log(f"[probe] B={bs}: {1e3*med:.2f} ms/batch "
            f"({1e3*med/bs:.4f} ms/q)", flush=True)

    model = rl.product_path_model(B, Sp, D, pool, D,
                                  gt_dtype_bytes=fidx.GT.dtype.itemsize)
    for name in ("one_program_grouped_pool", "one_program_approx_max_k"):
        rep = model.report(rows[name]["batch_ms"] / 1e3, B)
        rows[name]["roofline_frac"] = rep["roofline_frac"]
        rows[name]["bound"] = rep["bound"]
    rows["model_min_ms"] = round(1e3 * model.min_time_s(), 2)
    rows["config"] = {"size": len(db), "Sp": int(Sp), "D": int(D),
                      "batch": B, "pool": pool, "k": k,
                      "gt_dtype": str(fidx.GT.dtype).replace("torch.", ""),
                      "per_group": per_group}
    rows["served_ids"] = ids_e
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=str(
        EXPERIMENTS / "mb_cache_hard_s4000000_q4096_d768_p128.npz"))
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--vforest", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--pool", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--probes", type=int, default=5)
    ap.add_argument("--out", default=str(EXPERIMENTS
                                         / "pipeline_probe_1m.json"))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    with np.load(args.cache) as z:
        corpus = z["corpus_w"][: args.size]
        queries = z["queries_w"]
    print(f"[probe] corpus {corpus.shape} queries {queries.shape}",
          flush=True)
    db, build_s = build(corpus, args.vforest, dev)
    rows = probe(db, queries, args.batch, args.pool, args.k, args.probes)
    rows.pop("served_ids")
    rows["config"]["build_s"] = round(build_s, 1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(json.dumps({k: v for k, v in rows.items()
                      if not isinstance(v, dict) or "all_ms" not in v},
                     default=str), flush=True)
    print(f"[probe] wrote {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
