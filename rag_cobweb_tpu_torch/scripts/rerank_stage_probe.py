"""Stage-level timing of the raw re-rank serving path, on the card (twin
of ``scripts/rerank_stage_probe.py``): (1) whitening on the device, (2)
the fused sweep and its pool (kernel 1), (3) the exact raw re-rank
(kernel 5), (4) the whole ``query_ids``.

    python -m rag_cobweb_tpu_torch.scripts.rerank_stage_probe [C [POOL]] \\
        [--device cuda]

C (10000) corpus rows of the hard synthetic set, 1000 queries, 768-d,
PCA+ICA at 0.96, a 32-lane forest with the whitener; POOL (1024) the
re-rank pool.  Each row is the mean over 8 distinct batches (the
queries plus 0.001 i) issued back to back, then one synchronize, after
two warm calls: the rows' lines as the JAX script prints them.  The JAX
script's pool is ``approx_max_k``; PyTorch has none, so the pool is
kernel 1's exact top-POOL and the row says so.  The script holds
``query_ids``' ids against the ids its stages compose on the same batch
(``stages_equal_query_ids``).  ``stages`` takes a built index, so a
caller that has one (``chip_smoke.py`` phase 3n, the flagship forest)
times it without a second build.  Not carried over, as it exists only
for the TPU: the XLA compile cache and ``warmup_insert_programs``.
"""

import argparse
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device

ROWS = ("whiten (transform_torch)", "fused sweep + exact pool",
        "exact raw rerank (kernel 5)", "full query_ids")


def stages(db, queries: np.ndarray, pool: int, k: int = 10,
           reps: int = 8, out=print) -> dict:
    """ms a batch of each stage of ``db``'s served path on ``queries``
    (raw rows), over 8 distinct batches; prints each row as the JAX
    script does."""
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.scripts._sweeps import sync

    dev = db.device
    B = len(queries)
    q_raw = [torch.as_tensor(queries + 0.001 * i, device=dev)
             for i in range(8)]
    emb = db._emb_device()
    fidx = db._fused_index()
    pv = float(db.cfg.prior_var)
    rec = {}

    def timeit(name, fn):
        for i in range(2):          # warm
            fn(i)
        sync(dev)
        t0 = time.perf_counter()
        for i in range(reps):       # distinct batches
            fn(i)
        sync(dev)
        dt = (time.perf_counter() - t0) / reps
        out(f"{name:34s} {dt*1e3:8.2f} ms/batch  {dt*1e6/B:7.1f} us/q",
            flush=True)
        rec[name] = 1e3 * dt

    timeit(ROWS[0], lambda i: db.whitener.transform_torch(q_raw[i % 8]))
    qw = [db.whitener.transform_torch(q) for q in q_raw]
    timeit(ROWS[1], lambda i: db._fused_chunked(fidx, qw[i % 8], pool))
    pools = [db._fused_chunked(fidx, q, pool) for q in qw]
    timeit(ROWS[2], lambda i: index_mod.exact_rerank(
        emb, q_raw[i % 8], pools[i % 8][1], pools[i % 8][0], k, pv))
    timeit(ROWS[3], lambda i: db.query_ids(q_raw[i % 8], k, rerank=pool))
    composed = index_mod.exact_rerank(emb, q_raw[0], pools[0][1],
                                      pools[0][0], k, pv)[1]
    served = db.query_ids(q_raw[0], k, rerank=pool)
    rec["stages_equal_query_ids"] = bool(torch.equal(
        composed.long().cpu(), served.long().cpu()))
    rec["served_ids"] = served.cpu().numpy()
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("c", type=int, nargs="?", default=10000)
    p.add_argument("pool", type=int, nargs="?", default=1024)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.scripts._sweeps import fit_whitener
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    C = args.c
    data = synthetic_retrieval_hard(C, 1000, 768)
    wh = fit_whitener(data.corpus_embs, 0.96)
    db = CobwebIndex(config=TreeConfig(dim=wh.dim_out), capacity=4 * C + 16,
                     n_subtrees=32, whitener=wh, device=dev)
    db.add_sentences([None] * C, data.corpus_embs)
    db.query_ids(data.query_embs[:8], 10, rerank=args.pool)   # warm
    rec = stages(db, data.query_embs, args.pool)
    if not rec["stages_equal_query_ids"]:
        raise AssertionError("query_ids' ids differ from its stages'")
    return rec


if __name__ == "__main__":
    main()
