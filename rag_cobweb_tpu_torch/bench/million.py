"""Million-row forests on one device: the port's twin of
``scripts/million_benchmark.py``, its product row and the exact scan.

    python -m rag_cobweb_tpu_torch.bench.million --raw-store \\
        [--compress-stats --emb-bf16 --offload-state] [--backstop N] \\
        [--build-device cpu] [--size N] [--checkpoints a,b] [--device cuda]

Defaults are the JAX script's: 1M rows of the hard synthetic corpus
(768-d, one cluster per 1024 rows, at least 256), 1000 queries,
checkpoints at 500000 and 1000000, PCA+ICA to 128 (fitted on the first
100000 rows), k=10, a 256-lane forest, batches of 256, pool 512.

``--raw-store``: the index owns the whitener (``CobwebIndex(whitener=)``):
the forest and its pools in whitened space, the exact re-rank on the raw
rows, the backstop pool on by default (``backstop_pool="auto"``: from
131072 rows); without it the index takes whitened rows and no whitener.
``--backstop``: -1 auto, 0 off, N a pool of N.

The rows go in, in adds of 128 a lane; at each checkpoint the build rate
is taken, then the memory tools, each with the device bytes of every
component after it (forest state, raw store, whitened store, fused
index GT, and ``torch.cuda.memory_allocated``): ``--compress-stats``
(bf16 stats), the serving fused index's build, ``--emb-bf16`` (the bf16
re-rank store), ``--offload-state`` (the state to host memory).
``--build-device cpu`` builds the forest on the host and promotes it to
the card at the first checkpoint.  Then the product row
(``CobwebIndex.query_ids`` on the queries whose gold is indexed): recall@10
and ms/query at B=``--batch`` and at B=1; with the backstop on, the same
without it; the exact scan over the same rows (``FlatIndex``, L2, in the
store's space).  One JSON line per checkpoint.

The corpus, the queries and the fitted whitener are cached under
``build/million_cache/`` (git ignores it): generating 1M rows takes
minutes on one host core.  On the card with ``--raw-store`` each
checkpoint also records the stream ms of each stage of one served batch
(``probes.stage_split``), with the backstop and without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rag_cobweb_tpu_torch import files
from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval, to_host
from rag_cobweb_tpu_torch.bench.probes import stage_split
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.device import resolve_device
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "million_cache"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_data(size: int, queries: int, dim: int, pca_dim, cache_dir=None):
    """(corpus, queries, target ids, whitener): the hard corpus and the
    PCA+ICA fit of the JAX script, from the cache when it holds them."""
    cache_dir = Path(cache_dir or CACHE_DIR)
    path = cache_dir / f"hard_s{size}_q{queries}_d{dim}_p{pca_dim}.npz"
    if path.exists():
        with np.load(path) as z:
            w = files.whitener_from_pickle(z["whitener_pickle"].tobytes())
            return z["corpus"], z["queries"], z["target_ids"], w
    t0 = time.perf_counter()
    data = synthetic_retrieval_hard(size, queries, dim,
                                    n_clusters=max(256, size // 1024))
    log(f"[million] data {data.corpus_embs.shape} in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    w = PCAICAWhiteningModel.fit(data.corpus_embs[:100_000], pca_dim=pca_dim,
                                 ica_max_iter=300, ica_sample_size=20000)
    log(f"[million] whitener -> {w.dim_out} in "
        f"{time.perf_counter() - t0:.1f}s")
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.npz")
    np.savez(tmp, corpus=data.corpus_embs, queries=data.query_embs,
             target_ids=data.target_ids,
             whitener_pickle=np.frombuffer(files.whitener_pickle(w),
                                           np.uint8))
    os.replace(tmp, path)
    return data.corpus_embs, data.query_embs, data.target_ids, w


def _whiten(w, x, dev, chunk=131072):
    """Rows through the whitener on ``dev`` (float64 sums), to the host."""
    return np.concatenate([
        w.transform_torch(torch.as_tensor(x[s:s + chunk], device=dev))
        .cpu().numpy() for s in range(0, len(x), chunk)])


def device_bytes(db) -> dict:
    """Bytes of each component of ``db`` and where it lives: the forest
    state, the raw store (and its exact host copy under a bf16 store), the
    whitened store with its half-norms, the serving fused index; with
    ``torch.cuda.memory_allocated`` on the card."""
    st = db.forest.state
    out = {"forest_state": tree_mod.state_bytes(st),
           "forest_state_on": st.device.type,
           "forest_stats_dtype": str(st.means.dtype).replace("torch.", ""),
           "raw_store": db._emb_dev.nbytes if db._emb_dev is not None else 0,
           "raw_store_dtype": (str(db._emb_dev.dtype).replace("torch.", "")
                               if db._emb_dev is not None else None),
           "raw_store_host_copy": (db._emb_host.nbytes
                                   if db._emb_host is not None else 0),
           "whitened_store": ((db._wemb_dev.nbytes + db._half_n2.nbytes)
                              if db._wemb_dev is not None else 0),
           "fused_index": (sum(t.nbytes for t in db._fused)
                           if db._fused is not None else 0)}
    if db.device.type == "cuda":
        _sync(db.device)
        out["cuda_memory_allocated"] = torch.cuda.memory_allocated(db.device)
    return out


def _b1_ms(db, q, k, reps=20):
    lats = []
    for i in range(reps):
        row = np.ascontiguousarray(q[(i * 37) % len(q)][None])
        t0 = time.perf_counter()
        to_host(db.query_ids(row, k))
        lats.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(lats))


def _serve_row(db, name, q, gold, k, batch, rerank, backstop=None):
    """Recall@k and ms/query of ``query_ids`` at ``batch`` and at B=1,
    with ``backstop_pool`` set to ``backstop`` for the row (None: as is)."""
    old = db.backstop_pool
    if backstop is not None:
        db.backstop_pool = backstop
    try:
        res = evaluate_retrieval(
            name, lambda qb, kk: db.query_ids(qb, kk, rerank=rerank), q,
            gold, k, batch_size=batch)
        row = {"recall@10": res["recall@10"],
               "ms_per_query": res["avg_latency_ms"],
               "batch_ms": res["batch_latency_ms"],
               "b1_ms": _b1_ms(db, q, k)}
    finally:
        db.backstop_pool = old
    log(f"[million]   {name}: {row}")
    return row


def run(size: int = 1_000_000, checkpoints=(500_000, 1_000_000),
        queries: int = 1000, dim: int = 768, pca_dim=128, k: int = 10,
        vforest: int = 256, batch: int = 256, rerank: int = 512,
        raw_store: bool = False, backstop: int = -1,
        compress_stats: bool = False, emb_bf16: bool = False,
        offload_state: bool = False, build_device=None, device="cuda",
        cache_dir=None) -> list:
    """The checkpoints of the module docstring; returns their records."""
    dev = resolve_device(device)
    sizes = sorted(s for s in checkpoints if s <= size)
    corpus, qs, targets, w = load_data(size, queries, dim, pca_dim,
                                       cache_dir)
    whitener = w if raw_store else None
    if raw_store:
        feed, qfeed = corpus[:size], qs
    else:
        t0 = time.perf_counter()
        feed, qfeed = _whiten(w, corpus[:size], dev), _whiten(w, qs, dev)
        log(f"[million] whitened views in {time.perf_counter() - t0:.1f}s")
    K = vforest
    slots = 2 * size
    db = CobwebIndex(config=TreeConfig(dim=w.dim_out),
                     capacity=K * max(2048, slots // K + 64), n_subtrees=K,
                     seed=0, whitener=whitener, device=dev,
                     build_device=build_device)
    if backstop >= 0:
        db.backstop_pool = backstop
    chunk = K * 128
    tools = {"compress_stats": compress_stats, "emb_bf16": emb_bf16,
             "offload_state": offload_state, "build_device": build_device}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records, n = [], 0
    for cp in sizes:
        t0 = time.perf_counter()
        while n < cp:
            m = min(chunk, cp - n)
            db.add_sentences([None] * m, feed[n:n + m])
            n += m
        _sync(db.device)
        build_s = time.perf_counter() - t0
        prev = records[-1]["size"] if records else 0
        rec = {"size": cp, "device": name, "tools": tools,
               "n_subtrees": K, "whitened_dim": w.dim_out, "k": k,
               "batch": batch, "rerank": rerank, "raw_store": raw_store,
               "build_s": build_s,
               "insert_rate": (cp - prev) / build_s, "bytes": {}}
        log(f"[million] c={cp}: build {build_s:.1f}s "
            f"({rec['insert_rate']:.0f} inserts/s)")
        if db.device != dev:
            t0 = time.perf_counter()
            db.promote_build_device()
            rec["promote_s"] = time.perf_counter() - t0
        rec["bytes"]["built"] = device_bytes(db)
        if compress_stats:
            db.compress_stats()
            rec["bytes"]["compress_stats"] = device_bytes(db)
        t0 = time.perf_counter()
        db._fused_index()
        _sync(dev)
        rec["fused_build_s"] = time.perf_counter() - t0
        rec["bytes"]["fused_index"] = device_bytes(db)
        if emb_bf16:
            db.emb_store_dtype = "bfloat16"
            db._emb_device()
            rec["bytes"]["emb_bf16"] = device_bytes(db)
        if offload_state:
            t0 = time.perf_counter()
            db.offload_state()
            _sync(dev)
            rec["offload_s"] = time.perf_counter() - t0
            rec["bytes"]["offload_state"] = device_bytes(db)
        for stage, b in rec["bytes"].items():
            log(f"[million]   bytes after {stage}: {b}")
        mask = targets < cp
        q, gold = qfeed[mask], targets[mask]
        rec["queries"] = int(mask.sum())
        bs = db._backstop_k(rerank, cp)
        rec["backstop"] = bs
        rec["product"] = _serve_row(db, "product", q, gold, k, batch, rerank)
        if bs:
            rec["product_nobackstop"] = _serve_row(
                db, "product_nobackstop", q, gold, k, batch, rerank,
                backstop=0)
        if dev.type == "cuda" and raw_store:
            # stream ms of each stage of one served batch, with the
            # backstop as served and without it
            rec["split"] = {}
            for name, b in (("product", None), ("product_nobackstop", 0)):
                old = db.backstop_pool
                db.backstop_pool = old if b is None else b
                rec["split"][name] = stage_split(db, q[:batch], k, rerank)
                db.backstop_pool = old
            log(f"[million]   stage split: {rec['split']}")
        flat = FlatIndex(feed[:cp], metric="l2", device=dev)
        ex = evaluate_retrieval("exact", flat.search_device, q, gold, k,
                                batch_size=batch)
        rec["exact"] = {"recall@10": ex["recall@10"],
                        "ms_per_query": ex["avg_latency_ms"]}
        del flat
        log(f"[million]   exact: {rec['exact']}")
        # the next build phase gets the serving replicas' bytes back
        db._invalidate_index()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1_000_000)
    ap.add_argument("--checkpoints", default="500000,1000000")
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--pca-dim", type=float, default=128,
                    help="an int dim, or a variance fraction below 1")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--vforest", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rerank", type=int, default=512)
    ap.add_argument("--raw-store", action="store_true")
    ap.add_argument("--backstop", type=int, default=-1)
    ap.add_argument("--compress-stats", action="store_true")
    ap.add_argument("--emb-bf16", action="store_true")
    ap.add_argument("--offload-state", action="store_true")
    ap.add_argument("--build-device", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pca = args.pca_dim if args.pca_dim < 1 else int(args.pca_dim)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log("[million] " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    run(size=args.size,
        checkpoints=[int(s) for s in args.checkpoints.split(",")],
        queries=args.queries, dim=args.dim, pca_dim=pca, k=args.k,
        vforest=args.vforest, batch=args.batch, rerank=args.rerank,
        raw_store=args.raw_store, backstop=args.backstop,
        compress_stats=args.compress_stats, emb_bf16=args.emb_bf16,
        offload_state=args.offload_state, build_device=args.build_device,
        device=args.device)


if __name__ == "__main__":
    main()
