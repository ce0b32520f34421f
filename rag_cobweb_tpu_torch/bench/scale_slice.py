"""The scale slice: a whitener-mode forest served at 131072 indexed
sentences, where ``backstop_pool="auto"`` turns the backstop pool on,
with adds in between served from the pending and delta tiers.

    python -m rag_cobweb_tpu_torch.bench.scale_slice [--device cuda]

Settings of the 100k blocked cell (``bench/headline.py --corpus-size
100000 --pca-dim 128 --vforest 64 --rerank 512``) at 131072 rows: the
hard synthetic corpus, 768-d, PCA+ICA to 128, a 64-lane forest, k=10,
pool 512, batches of 1024.  The data (4096 queries) is drawn over 131072
+ 9216 rows; the first 131072 are built and indexed, the rest added
later.  ``run`` does, in order, each serving in a window of the kernels'
launch counters (set to 0 just before, read just after):

1. serves every query with the backstop on (kernel 1 twice a chunk: the
   sweep's pool and the backstop's; kernel 5 once) and holds the served
   ids against the same pipeline in plain PyTorch (``probes.plain_check``:
   equal except at ties); recall@10 beside the exact scan's over the same
   rows;
2. the same with ``backstop_pool = 0``;
3. ``hook("backstop", db, data)`` (the caller's kernel checks);
4. adds 2048 rows (tier 0), 6144 (past ``stale_pending_limit``: into the
   delta segment) and 1024 (tier 0), checks that the serving index was
   kept and the tiers' counts, serves every query (recall@10 beside the
   exact scan over all 140288 rows; the ids held against the plain
   pipeline, which takes the added rows from the raw corpus) and the added
   rows as themselves (each must come back first);
   ``hook("pending", db, data)``;
5. times add-then-query (1024 rows added, then one B=1 query answered)
   with the stale index, and again with ``stale_reads = False`` (each
   add drops the index; the query rebuilds it);
6. with ``stale_reads`` back on, ``hook("tools", db, data)``: the
   caller's steps on the memory tools of a large index (``chip_smoke.py``
   phase 3g), on this build and the rows step 5 added to it.

On the card each served state (backstop on, off, after the adds) also
gets a stage split of one batch of 1 and of 1024 queries
(``probes.stage_split``).

Any failed check raises.  Prints one JSON line (the record ``run``
returns, without the windows' raw tensors).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval, to_host
from rag_cobweb_tpu_torch.bench.probes import (plain_check, read_counters,
                                               stage_split, zero_counters)
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.device import resolve_device
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

ADDS = (2048, 6144, 1024)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(db, queries, k: int, batch: int) -> np.ndarray:
    return np.concatenate([to_host(db.query_ids(queries[s:s + batch], k))
                           for s in range(0, len(queries), batch)])


def _evaluate(db, data, k, batch, name):
    calls = [0]

    def fn(q, kk):
        calls[0] += 1
        return db.query_ids(q, kk)

    res = evaluate_retrieval(name, fn, data.query_embs, data.target_ids, k,
                             batch_size=batch)
    return res, calls[0]


def _b1_ms(db, data, k, reps=7):
    lats = []
    for i in range(reps):
        q = np.ascontiguousarray(data.query_embs[i * 131 % len(
            data.query_embs)][None])
        t0 = time.perf_counter()
        to_host(db.query_ids(q, k))
        lats.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(lats))


def _add_then_query_ms(db, rows, q, k):
    _sync(db.device)
    t0 = time.perf_counter()
    db.add_sentences([None] * len(rows), rows)
    to_host(db.query_ids(q, k))
    return 1e3 * (time.perf_counter() - t0)


def run(corpus_size: int = 131072, queries: int = 4096, dim: int = 768,
        pca_dim: int = 128, n_lanes: int = 64, k: int = 10, pool: int = 512,
        batch: int = 1024, adds=ADDS, device="cuda", log=None,
        hook=None) -> dict:
    """The phases of the module docstring; returns their record."""
    log = log or (lambda *a: None)
    hook = hook or (lambda *a: None)
    dev = resolve_device(device)
    extra = sum(adds)
    t0 = time.perf_counter()
    data = synthetic_retrieval_hard(corpus_size + extra, queries, dim)
    log(f"[scale] data {data.corpus_embs.shape} in "
        f"{time.perf_counter() - t0:.1f}s")
    corpus = data.corpus_embs
    t0 = time.perf_counter()
    w = PCAICAWhiteningModel.fit(corpus[:corpus_size], pca_dim=pca_dim,
                                 ica_max_iter=500, seed=0,
                                 ica_sample_size=10000)
    rec = {"corpus_size": corpus_size, "extra_rows": extra,
           "queries": queries, "whitened_dim": w.dim_out,
           "n_subtrees": n_lanes, "k": k, "pool": pool, "batch": batch,
           "whitener_fit_s": time.perf_counter() - t0, "windows": {}}
    db = CobwebIndex(config=TreeConfig(dim=w.dim_out),
                     capacity=4 * len(corpus) + 16, n_subtrees=n_lanes,
                     whitener=w, device=dev)
    db.rerank_candidates = pool     # the auto pool (whitener mode)
    t0 = time.perf_counter()
    db.add_sentences([None] * corpus_size, corpus[:corpus_size])
    _sync(dev)
    rec["build_s"] = time.perf_counter() - t0
    rec["build_inserts_per_s"] = corpus_size / rec["build_s"]
    log(f"[scale] forest build {rec['build_s']:.1f}s "
        f"({rec['build_inserts_per_s']:.0f} inserts/s)")
    flat = FlatIndex(corpus[:corpus_size], metric="l2", device=dev)
    exact = evaluate_retrieval("exact", flat.search_device, data.query_embs,
                               data.target_ids, k, batch_size=batch)
    rec["exact_recall@10"] = exact["recall@10"]
    del flat

    # 1-2: backstop on ("auto": on from 131072 sentences), then off
    if db._backstop_k(pool, corpus_size) != pool:
        raise AssertionError("the backstop is not on at "
                             f"{corpus_size} sentences")
    t0 = time.perf_counter()
    to_host(db.query_ids(data.query_embs[:8], k))
    rec["index_build_s"] = time.perf_counter() - t0
    for name, bs in (("backstop_on", "auto"), ("backstop_off", 0)):
        db.backstop_pool = bs
        zero_counters()
        res, calls = _evaluate(db, data, k, batch, name)
        rec["windows"][name] = dict(read_counters(), query_ids_calls=calls)
        rec[name] = {"recall@10": res["recall@10"],
                     "ms_per_query": res["avg_latency_ms"],
                     "b1_ms": _b1_ms(db, data, k)}
        if dev.type == "cuda":
            rec[name]["split"] = {
                B: stage_split(db, data.query_embs[:B], k, pool)
                for B in (1, batch)}
        log(f"[scale] {name}: recall@10 {res['recall@10']} (exact "
            f"{rec['exact_recall@10']}), {res['avg_latency_ms']:.6f} "
            f"ms/query; launches {rec['windows'][name]}")
    db.backstop_pool = "auto"
    served = serve(db, data.query_embs, k, batch)
    rec["backstop_on"].update(plain_check(db, data.query_embs, served, k,
                                          pool, pool, batch, corpus,
                                          data.target_ids))
    on, off = rec["windows"]["backstop_on"], rec["windows"]["backstop_off"]
    card = dev.type == "cuda"     # on the host nothing launches
    if card and not (on["rerank_l2"] == on["query_ids_calls"]
                     == on["backstop"]
                     and on["fused_topk"] == 2 * on["rerank_l2"]
                     and on["fused_topk_f32"] == on["pending"] == 0):
        raise AssertionError(f"backstop on: kernel 1 must launch twice a "
                             f"chunk (once for the backstop) and kernel 5 "
                             f"once: {on}")
    if card and not (off["fused_topk"] == off["rerank_l2"]
                     == off["query_ids_calls"] and off["backstop"] == 0):
        raise AssertionError(f"backstop off: one launch of kernels 1 and 5 "
                             f"a chunk: {off}")
    if not (rec["backstop_on"]["recall@10"]
            >= rec["exact_recall@10"] - 0.005):
        raise AssertionError(f"backstop on: recall@10 "
                             f"{rec['backstop_on']} is more than 0.005 "
                             f"below the exact scan's")
    hook("backstop", db, data)

    # 4: adds served from the tiers, on the index built before them
    fused = db._fused
    n = corpus_size
    for size in adds:
        t0 = time.perf_counter()
        db.add_sentences([None] * size, corpus[n:n + size])
        _sync(dev)
        log(f"[scale] add {size} rows: {time.perf_counter() - t0:.2f}s; "
            f"unindexed {db._unindexed_count()}, delta {db._delta_n}")
        n += size
    if db._fused is not fused:
        raise AssertionError("an add rebuilt the serving fused index")
    rec["unindexed"], rec["delta_n"] = db._unindexed_count(), db._delta_n
    if (rec["unindexed"], rec["delta_n"]) != (extra, adds[0] + adds[1]):
        raise AssertionError(f"tiers after the adds: {rec['unindexed']} "
                             f"unindexed, {rec['delta_n']} in the delta")
    flat = FlatIndex(corpus, metric="l2", device=dev)
    exact = evaluate_retrieval("exact", flat.search_device, data.query_embs,
                               data.target_ids, k, batch_size=batch)
    del flat
    zero_counters()
    res, calls = _evaluate(db, data, k, batch, "after_adds")
    rec["windows"]["after_adds"] = dict(read_counters(),
                                        query_ids_calls=calls)
    self_ids = serve(db, corpus[corpus_size:], 1, batch)[:, 0]
    rec["after_adds"] = {
        "recall@10": res["recall@10"], "exact_recall@10": exact["recall@10"],
        "ms_per_query": res["avg_latency_ms"], "b1_ms": _b1_ms(db, data, k),
        "added_rows_found_first": int(np.sum(
            self_ids == np.arange(corpus_size, len(corpus))))}
    served = serve(db, data.query_embs, k, batch)
    rec["after_adds"].update(plain_check(db, data.query_embs, served, k,
                                         pool, pool, batch, corpus))
    if dev.type == "cuda":
        rec["after_adds"]["split"] = {
            B: stage_split(db, data.query_embs[:B], k, pool)
            for B in (1, batch)}
    log(f"[scale] after the adds: {rec['after_adds']}; launches "
        f"{rec['windows']['after_adds']}")
    wa = rec["windows"]["after_adds"]
    if card and not (wa["fused_topk"] == 2 * calls == 2 * wa["backstop"]
                     and wa["rerank_l2"] == 2 * calls == 2 * wa["pending"]
                     and wa["fused_topk_f32"] == 0):
        raise AssertionError(f"after the adds: kernel 1 twice a chunk (once "
                             f"for the backstop), kernel 5 twice (the union "
                             f"and the pending tier): {wa}")
    if not res["recall@10"] >= exact["recall@10"] - 0.005:
        raise AssertionError(f"after the adds: recall@10 {res['recall@10']}"
                             f" is more than 0.005 below the exact scan's "
                             f"{exact['recall@10']}")
    if rec["after_adds"]["added_rows_found_first"] != extra:
        raise AssertionError("added rows queried as themselves did not all "
                             "come back first")
    hook("pending", db, data)

    # 5: add-then-query, stale index against a rebuild
    # (the new rows: the query rows, 1024 at a time)
    q1 = data.query_embs[:1]
    m = min(1024, queries // 4)
    parts = [data.query_embs[i * m:(i + 1) * m] for i in range(4)]
    stale = [_add_then_query_ms(db, rows, q1, k) for rows in parts[:2]]
    if db._fused is not fused:
        raise AssertionError("an add rebuilt the serving fused index")
    db.stale_reads = False
    fresh = [_add_then_query_ms(db, rows, q1, k) for rows in parts[2:]]
    rec["add_then_query_ms"] = {"rows": m, "stale": stale, "rebuild": fresh}
    log(f"[scale] add {m} rows then one B=1 query, ms: {stale} with the "
        f"stale index, {fresh} rebuilding")

    # 6: the memory tools, on this build
    db.stale_reads = True
    hook("tools", db, data)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(device=args.device,
              log=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
