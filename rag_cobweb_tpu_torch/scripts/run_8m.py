"""8M sentences on one card, built as sequential half-forests (twin of
``scripts/run_8m.py``).

    python -m rag_cobweb_tpu_torch.scripts.run_8m [--cache W.npz] \\
        [--size 8000000] [--halves 2] [--vforest 512] \\
        [--slots-per-sentence 1.4] [--batch 512] [--pool 512] [--k 10] \\
        [--score-budget 4.0] [--backstop 192] \\
        [--gt-cache build/experiments/run8m_gt_{h}.npz] \\
        [--out build/experiments/million_r5_8m.json] [--device cuda]

Each half (``--halves`` sequential parts of the cache's first ``--size``
whitened rows): a ``VForest`` of ``--vforest`` lanes built in f32 in
adds of lanes x 128 rows, its stats compressed to bf16
(``compress_stats``), its bf16 fused index kept on the host
(``fused_index(dtype=bfloat16)``; also written to ``--gt-cache`` and
read from there on a later run: ``''`` writes none), the forest freed.
The JAX script split the build into halves because one 8M insert
program did not compile within a TPU's memory; the card has room for
one, but the twin keeps ``--halves`` and the composition.

Serving: the halves' fused indexes concatenated column-wise (each
half's column j is its sentence j; a pool position in half h maps to
``j + first row of h``), one bf16 whitened store (the re-rank store,
row-major, and the backstop's copy in kernel 1's GT layout), and per
query chunk: kernel 1's exact pool of ``--pool`` (the JAX script takes
``approx_max_k``, which PyTorch lacks), the positions remapped to
sentence ids, the ``--backstop`` pool (``index.backstop_topk``: kernel 1
over the whitened store), their union, and kernel 5's bf16-row entry
for the re-rank to ``--k``.  The chunk follows the wrapper's budget on
the card (kernel 1's per-slab pools, ``--score-budget`` GiB; the (B, Sp)
scores on the host).  Reports recall@k and ms/query
(``bench/metrics.evaluate_retrieval`` against a 10000-row flat control),
B = 1, 32 and 256 (median of 7), the roofline
(``bench/roofline.product_path_model``) and ``hbm_serving_gb``
(``torch.cuda.memory_allocated``; null on the host).  Writes ``--out``
under the git-ignored ``build/experiments/`` by default (the JAX
script's is under ``outputs/``).  Not carried over, as they exist only
for the TPU: the XLA compile cache, ``warmup_insert_programs`` and
``jax.clear_caches`` (the twin empties the CUDA cache).  ``run(args)``
returns the record and the composed index (``Composed``), whose
``global_index()`` a caller holds against the plain pipeline
(``chip_smoke.py`` phase 3n).
"""

import argparse
import gc
import json
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device

EXPERIMENTS = Path(__file__).resolve().parents[2] / "build" / "experiments"


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=str(
        EXPERIMENTS / "mb_cache_hard_s8000000_q4096_d768_p128.npz"))
    ap.add_argument("--size", type=int, default=8_000_000)
    ap.add_argument("--halves", type=int, default=2)
    ap.add_argument("--vforest", type=int, default=512)
    ap.add_argument("--slots-per-sentence", type=float, default=1.4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--pool", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--score-budget", type=float, default=4.0,
                    help="GiB budget for one query chunk's sweep output")
    ap.add_argument("--backstop", type=int, default=192,
                    help="whitened-proximity backstop pool off the "
                         "re-rank store; 0 = off")
    ap.add_argument("--gt-cache", default=str(EXPERIMENTS
                                              / "run8m_gt_{h}.npz"),
                    help="per-half fused-index cache ('' = none)")
    ap.add_argument("--out", default=str(EXPERIMENTS / "million_r5_8m.json"))
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def hbm_gb(dev):
    return (round(torch.cuda.memory_allocated(dev) / 1e9, 2)
            if dev.type == "cuda" else None)


class Composed:
    """The halves' fused indexes served as one (see the module doc)."""

    def __init__(self, parts, rows, corpus, n: int, prior_var: float, dev):
        from rag_cobweb_tpu_torch.core.index import FusedIndex
        self.device, self.n, self.pv = dev, n, prior_var
        self.fidx = FusedIndex(
            GT=torch.cat([p.GT for p in parts], dim=1).contiguous(),
            c=torch.cat([p.c for p in parts]),
            valid=torch.cat([p.valid for p in parts]))
        widths = [p.num_slots for p in parts]
        self.col0 = torch.as_tensor(np.cumsum([0] + widths[:-1]), device=dev)
        self.row0 = torch.as_tensor(np.cumsum([0] + rows[:-1]), device=dev)
        self.rows = rows
        self.parts = parts
        D = corpus.shape[1]
        emb_rows = max(n, int(self.row0[-1]) + widths[-1]) + 8
        self.emb = torch.zeros((emb_rows, D), dtype=torch.bfloat16,
                               device=dev)
        for s in range(0, n, 1 << 20):
            self.emb[s:min(s + (1 << 20), n)] = torch.as_tensor(
                corpus[s:min(s + (1 << 20), n)], device=dev).to(
                    torch.bfloat16)
        Sw = -(-n // 2048) * 2048
        self.wemb = torch.zeros((D, Sw), dtype=torch.bfloat16, device=dev)
        self.wemb[:, :n] = self.emb[:n].T
        self.half_n2 = torch.zeros((Sw,), device=dev)
        self.half_n2[:n] = 0.5 * torch.sum(
            torch.square(self.emb[:n].float()), dim=1)

    def to_ids(self, pos):
        """Pool positions of the concatenated index -> sentence ids."""
        h = torch.searchsorted(self.col0, pos.long(), right=True) - 1
        return pos.long() - self.col0[h] + self.row0[h]

    def topk(self, q, k: int, pool: int, bs: int):
        from rag_cobweb_tpu_torch.core import index as index_mod
        cs, pos = index_mod.fused_query_topk(self.fidx, q, pool)
        gids = self.to_ids(pos)
        if bs:
            bcs, bcand = index_mod.backstop_topk(
                self.wemb, self.half_n2, q, bs, self.n, gt_layout=True)
            gids, cs = index_mod.union_candidates(gids, cs, bcand, bcs)
        return index_mod.exact_rerank(self.emb, q, gids, cs, k, self.pv)

    def global_index(self):
        """The same scores with column = sentence id (each half's valid
        columns in order, padded to 2048): the served pool's function
        with no remap, for holding the served ids against the plain
        pipeline."""
        from rag_cobweb_tpu_torch.core.index import FusedIndex
        GT = torch.cat([p.GT[:, :r] for p, r in zip(self.parts, self.rows)],
                       dim=1)
        c = torch.cat([p.c[:r] for p, r in zip(self.parts, self.rows)])
        Sp = -(-self.n // 2048) * 2048
        pad = Sp - self.n
        return FusedIndex(
            GT=torch.nn.functional.pad(GT, (0, pad)).contiguous(),
            c=torch.nn.functional.pad(c, (0, pad)),
            valid=torch.arange(Sp, device=self.device) < self.n)

    def as_db(self):
        """What ``bench/probes.plain_check`` reads of an index."""
        return _PlainView(self.global_index(), self.n, self.pv)


class _PlainView:
    """The global-order fused index, the prior variance, the counts and
    an identity whitener (the store is the whitened rows), as
    ``bench/probes.plain_check`` reads them of a ``CobwebIndex``."""

    whitener = SimpleNamespace(transform_torch=lambda x: x)

    def __init__(self, fidx, n: int, prior_var: float):
        self.fidx, self.n = fidx, n
        self.cfg = SimpleNamespace(prior_var=prior_var)

    def _fused_index(self):
        return self.fidx

    def _indexed_count(self) -> int:
        return self.n

    def __len__(self) -> int:
        return self.n


def build_halves(corpus, args, cfg, dev, log=print):
    """Each half's bf16 fused index (host tensors) and its record."""
    import rag_cobweb_tpu_torch.core.tree as tree_mod
    from rag_cobweb_tpu_torch.core.index import FusedIndex
    from rag_cobweb_tpu_torch.parallel.vforest import VForest
    from rag_cobweb_tpu_torch.scripts._sweeps import sync

    K, H = args.vforest, args.halves
    half = -(-args.size // H)
    chunk = K * 128
    parts, meta, rows = [], [], []
    for h in range(H):
        lo, hi = h * half, min((h + 1) * half, args.size)
        rows.append(hi - lo)
        gpath = args.gt_cache.format(h=h) if args.gt_cache else ""
        if gpath and os.path.exists(gpath):
            with np.load(gpath) as z:
                parts.append(FusedIndex(
                    GT=torch.from_numpy(z["GT"].view(np.int16)).view(
                        torch.bfloat16),
                    c=torch.from_numpy(z["c"]),
                    valid=torch.from_numpy(z["valid"])))
            meta.append({"half": h, "rows": hi - lo, "from_cache": gpath})
            log(f"[8m] half {h}: fused index from cache {gpath}", flush=True)
            continue
        cap_lane = tree_mod.align_capacity(
            max(2048, int(args.slots_per_sentence * (hi - lo)) // K + 64))
        forest = VForest(cfg, n_subtrees=K, capacity_per_tree=cap_lane,
                         seed=h, device=dev)
        t0 = time.perf_counter()
        for s in range(lo, hi, chunk):
            forest.add(corpus[s:s + min(chunk, hi - s)])
        sync(dev)
        build_s = time.perf_counter() - t0
        rate = (hi - lo) / build_s
        log(f"[8m] half {h}: build {build_s:.1f}s ({rate:.0f}/s), hbm "
            f"{hbm_gb(dev)} GB", flush=True)
        t0 = time.perf_counter()
        forest.compress_stats()
        sync(dev)
        comp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fidx = forest.fused_index(dtype=torch.bfloat16)
        sync(dev)
        fuse_s = time.perf_counter() - t0
        log(f"[8m] half {h}: compress {comp_s:.1f}s, fused {fuse_s:.1f}s "
            f"({fidx.GT.numel() * 2 / 1e9:.2f} GB GT), hbm {hbm_gb(dev)} GB",
            flush=True)
        parts.append(FusedIndex(GT=fidx.GT.cpu(), c=fidx.c.cpu(),
                                valid=fidx.valid.cpu()))
        if gpath:
            os.makedirs(os.path.dirname(gpath) or ".", exist_ok=True)
            np.savez(gpath, GT=parts[-1].GT.view(torch.int16).numpy()
                     .view(np.uint16), c=parts[-1].c.numpy(),
                     valid=parts[-1].valid.numpy())
        meta.append({"half": h, "rows": hi - lo,
                     "insert_rate": round(rate, 1),
                     "build_s": round(build_s, 1), "warmup_s": None,
                     "compress_s": round(comp_s, 1),
                     "fused_build_s": round(fuse_s, 1)})
        del fidx, forest
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"[8m] half {h} released: hbm {hbm_gb(dev)} GB", flush=True)
    return parts, meta, rows


def run(args, log=print):
    """(the record, the ``Composed`` index) of one run of ``args``."""
    from rag_cobweb_tpu_torch.bench import roofline as rl
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.metrics import evaluate_retrieval
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.ops.fused_topk import SLAB
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    dev = resolve_device(args.device)
    enable_persistent_cache()
    t0 = time.perf_counter()
    with np.load(args.cache) as z:
        corpus = z["corpus_w"][: args.size]
        queries = z["queries_w"]
        target_ids = z["target_ids"]
    D = corpus.shape[1]
    log(f"[8m] cache {corpus.shape} / {queries.shape}: "
        f"{time.perf_counter()-t0:.1f}s", flush=True)
    cfg = TreeConfig(dim=D)
    parts, meta, rows = build_halves(corpus, args, cfg, dev, log)
    comp = Composed([p._replace(GT=p.GT.to(dev), c=p.c.to(dev),
                                valid=p.valid.to(dev)) for p in parts],
                    rows, corpus, len(corpus), float(cfg.prior_var), dev)
    del parts
    gc.collect()
    Sp = comp.fidx.num_slots
    log(f"[8m] serving index: GT {comp.fidx.GT.numel() * 2 / 1e9:.2f} GB + "
        f"emb {comp.emb.numel() * 2 / 1e9:.2f} GB, hbm {hbm_gb(dev)} GB",
        flush=True)

    B, pool, k, bs_k = args.batch, args.pool, args.k, args.backstop
    budget = int(args.score_budget * (1 << 30))
    if dev.type == "cuda":
        row = (Sp // SLAB * min(pool, SLAB) * 8
               + (comp.wemb.shape[1] // SLAB * min(bs_k, SLAB) * 8
                  if bs_k else 0))
    else:
        row = Sp * 4 * (2 if bs_k else 1)
    bmax = max(32, budget // row)
    if bmax < B:
        bmax = 1 << (bmax.bit_length() - 1)
    log(f"[8m] Sp={Sp}, serve chunk {min(bmax, B)}, backstop {bs_k}",
        flush=True)

    def serve(qb, kk):
        qd = torch.as_tensor(np.asarray(qb, np.float32), device=dev)
        n = qd.shape[0]
        outs = []
        for s in range(0, n, bmax):
            qc = qd[s:s + bmax]
            m = qc.shape[0]
            if m < bmax and n > bmax:
                qc = torch.cat([qc, torch.zeros((bmax - m, D), device=dev)])
            outs.append(comp.topk(qc, kk, pool, bs_k)[1][:m])
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    ctrl = FlatIndex(corpus[:10000], metric="l2", device=dev)
    res = evaluate_retrieval(
        "product_8m", serve, queries, target_ids, k, batch_size=B,
        control_fn=lambda q, kk: ctrl.search_device(q, kk),
        control_threshold_ms=90.0)
    log(f"[8m] product: recall@{k}={res.get(f'recall@{k}'):.4f} "
        f"{res['avg_latency_ms']:.4f} ms/q ({res['qps']:.0f} qps), "
        f"control {res['control_batch_ms']:.1f} ms/batch", flush=True)
    model = rl.product_path_model(min(B, bmax), Sp, D, pool, D,
                                  gt_dtype_bytes=2, backstop=bs_k)
    rep = model.report(res["batch_latency_ms"] / 1e3 / max(B // bmax, 1),
                       min(B, bmax))

    small = {}
    for b in (1, 32, 256):
        serve(queries[:b], k).cpu()
        lats = []
        for i in range(7):
            off = (i * 131) % (len(queries) - b + 1)
            t1 = time.perf_counter()
            serve(queries[off:off + b], k).cpu()
            lats.append(time.perf_counter() - t1)
        small[f"b{b}_batch_ms"] = round(1e3 * float(np.median(lats)), 2)
        log(f"[8m] B={b}: {small[f'b{b}_batch_ms']} ms/batch", flush=True)

    rec = {"size": args.size, "halves": meta, "Sp": Sp,
           "pool": pool, "backstop": bs_k,
           "gt_gb": round(comp.fidx.GT.numel() * 2 / 1e9, 2),
           "emb_gb": round(comp.emb.numel() * 2 / 1e9, 2),
           "hbm_serving_gb": hbm_gb(dev),
           f"recall@{k}": round(res.get(f"recall@{k}", 0.0), 4),
           "ms_per_query": round(res["avg_latency_ms"], 4),
           "batch_ms": round(res["batch_latency_ms"], 2),
           "qps": round(res["qps"], 1),
           "control_batch_ms": round(res["control_batch_ms"], 2),
           "latency_vs_control": round(res["latency_vs_control"], 2),
           "control_requeued": res.get("control_requeued", False),
           "roofline": rep, **small}
    comp.serve = serve
    return rec, comp


def main(argv=None):
    args = parse(argv)
    resolve_device(args.device)
    rec, _ = run(args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
