"""Roofline sweep on the card (twin of ``scripts/roofline_benchmark.py``):
each query engine's achieved operations and bytes against the H100
model of ``bench/roofline.py``, across batch sizes.

    python -m rag_cobweb_tpu_torch.scripts.roofline_benchmark \\
        --corpus-size 100000 --batches 32,256,1024,4096 [--device cuda]

Engines, each on the whitened queries of one build (``--lanes`` lanes,
PCA+ICA to ``--pca-dim``):
  * ``exact_flat``: the exact L2 scan (``FlatIndex.search_device``);
  * ``torch_blocked``: the blocked sweep in PyTorch
    (``index.blocked_query_topk``);
  * ``fused_flat_<dtype>``: the fused sweep, kernel 1's exact pool of
    ``--rerank`` (``index.fused_query_topk``; the JAX script asked XLA
    for an approximate one, which PyTorch lacks);
  * ``kernel_blocked_tiled``: the blocked kernel with 16 candidates a
    block (``ops/blocked_topk.blocked_topk_tiled``, kernels 3/4; the
    JAX script's ``pallas_fused_tiled``);
  * ``kernel_blocked``: the untiled arm, ``blocked_topk`` for the pool.
    The JAX script took it where the batch fitted the TPU's VMEM and
    fell back to the wrapper's chunked engine otherwise; the card's
    kernel streams its operands through shared memory, so every batch
    fits and the fallback has no counterpart (``CobwebIndex._pallas_topk``
    says the same);
  * ``leaf_rerank``: ``index._leaf_lp_rerank`` of ``--rerank`` candidates;
  * ``beam_pack``: the packed beam over every lane (plain PyTorch).

``measured_ms`` is "pipelined": ``reps`` calls issued, then one
synchronize, the engine's throughput cost, which the model bounds.
``sync_ms`` is the median of 3 single calls each followed by a
synchronize, in milliseconds (the JAX script stores seconds under that
name).  Both are ``perf_counter`` times on the card.  ``rows`` takes a
built index, so a caller that has one (``chip_smoke.py`` phase 3b)
runs the sweep without a second build.  Not carried over, as they exist
only for the TPU: the XLA compile cache and ``warmup_insert_programs``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device


def timed(fn, q, device, reps: int = 8):
    """(pipelined s, sync s, out): ``reps`` calls then one synchronize,
    and the median of 3 synchronized single calls, after a warm call."""
    from rag_cobweb_tpu_torch.scripts._sweeps import sync
    out = fn(q)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(q)
    sync(device)
    pipelined = (time.perf_counter() - t0) / reps
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(q)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(pipelined), float(np.median(ts)), out


def rows(db, corpus_w: np.ndarray, queries_w: np.ndarray, batches,
         k: int = 10, rerank: int = 512, beam_width: int = 64,
         skip_beam: bool = False, log=None) -> list:
    """The engines' roofline rows at each batch size in ``batches``, on
    the forest index ``db`` built over the whitened rows ``corpus_w``
    (or over raw rows with ``corpus_w`` its whitener's image), queried
    with whitened rows ``queries_w`` (host arrays)."""
    from rag_cobweb_tpu_torch.bench import roofline as rl
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.ops import blocked_topk

    log = log or (lambda *a: None)
    dev = db.device
    D = corpus_w.shape[1]
    flat = db._flat_pred_index()
    bidx = db._blocked_index()
    fidx = db._fused_index()
    fi = FlatIndex(corpus_w, metric="l2", device=dev)
    lanes = db.n_subtrees
    out = []
    for B in batches:
        q = torch.as_tensor(np.resize(queries_w, (B, D)).astype(np.float32),
                            device=dev)
        new = []

        def add(model, fn, engine=None):
            ms, sync_s, _ = timed(fn, q, dev)
            r = dict(model.report(ms, B), sync_ms=round(1e3 * sync_s, 3))
            if engine:
                r["engine"] = engine
            new.append(r)

        add(rl.exact_flat_model(B, len(corpus_w), D),
            lambda qq: fi.search_device(qq, k))
        add(rl.model_for_blocked_index(bidx, B, fused=False),
            lambda qq: index_mod.blocked_query_topk(bidx, qq, k))
        add(rl.model_for_fused_index(fidx, B),
            lambda qq: index_mod.fused_query_topk(fidx, qq, rerank),
            f"fused_flat_{str(fidx.GT.dtype).replace('torch.', '')}")
        add(rl.model_for_blocked_index(bidx, B, fused=True),
            lambda qq: blocked_topk.blocked_topk_tiled(
                bidx, qq, rerank, block_k=db.pallas_block_k),
            "kernel_blocked_tiled")
        add(rl.model_for_blocked_index(bidx, B, fused=True),
            lambda qq: blocked_topk.blocked_topk(
                bidx, qq, max(k, rerank), block_k=db.pallas_block_k))
        zeros_i = torch.zeros((B, rerank), dtype=torch.int64, device=dev)
        zeros_s = torch.zeros((B, rerank), device=dev)
        add(rl.leaf_rerank_model(B, rerank, D),
            lambda qq: index_mod._leaf_lp_rerank(flat, qq, zeros_i, zeros_s,
                                                 k))
        if not skip_beam and db.forest is not None:
            bmidx = db.forest.beam_index()
            depth = -(-max(db.forest._beam_depth, 1) // 4) * 4
            W = max(beam_width, lanes)
            C = min(64 * max(1, -(-4 * W // 64)), W * 16)
            add(rl.beam_pack_model(B, depth, C, D,
                                   pack_bytes=bmidx.pack.dtype.itemsize),
                lambda qq: index_mod.beam_pack_topk(
                    bmidx, qq, k, beam_width=beam_width, max_depth=depth,
                    n_roots=lanes))
        for r in new:
            log(f"[roofline] B={B} {r['engine']}: {r['measured_ms']} ms "
                f"(min {r['roofline_min_ms']} ms, {r['bound']}-bound, "
                f"flops {r['flops_pct']}%, HBM {r['hbm_pct']}%)")
        out += new
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus-size", type=int, default=100000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=int, default=128)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--rerank", type=int, default=512)
    p.add_argument("--lanes", type=int, default=64)
    p.add_argument("--batches", type=str, default="32,256,1024,4096")
    p.add_argument("--beam-width", type=int, default=64)
    p.add_argument("--skip-beam", action="store_true")
    p.add_argument("--dataset", choices=["hard", "easy"], default="hard")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.scripts._sweeps import (
        build_index, dataset, fit_whitener, log, whiten)
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    data = dataset(args.dataset, args.corpus_size,
                   min(4096, args.corpus_size // 4), args.dim)
    log(f"[roofline] corpus {data.corpus_embs.shape} ({data.name})")
    wh = fit_whitener(data.corpus_embs, args.pca_dim)
    corpus_w = whiten(wh, data.corpus_embs, dev)
    queries_w = whiten(wh, data.query_embs, dev)
    db, build_s = build_index(corpus_w, args.lanes, dev)
    log(f"[roofline] build: {build_s:.1f}s")
    flat = db._flat_pred_index()
    bidx = db._blocked_index()
    NB, M, _ = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    log(f"[roofline] NB={NB} M={M} TS={TS} N={flat.num_nodes}")
    out = {"corpus_size": args.corpus_size, "dim": int(corpus_w.shape[1]),
           "NB": NB, "M": M, "TS": TS, "nodes": flat.num_nodes,
           "sentences": flat.num_sentences,
           "rows": rows(db, corpus_w, queries_w,
                        [int(x) for x in args.batches.split(",")],
                        k=args.k, rerank=args.rerank,
                        beam_width=args.beam_width,
                        skip_beam=args.skip_beam, log=log)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
