"""The rank program of ``chip_smoke.py``'s phase 3j: the multi-device port
driven on the cards (or, for a rehearsal, on the host).

``run(spec, n, device)`` starts ``n`` ranks (``bench/multichip.spawn``:
a card a rank over NCCL, or ranks sharing one card over gloo) on the
inputs the parent wrote under ``spec["dir"]`` (``write_flagship``: the
flagship forest's served fused index, its raw store, its whitened rows
and queries; the single tree's ``CobwebIndex.save`` file) and returns
each rank's record:

(a) ``TPFusedPredictionIndex`` over the flagship's served index with the
    raw store: every query at ``rerank=pool`` in a counter window (kernels
    1 and 5 must launch on every rank), recall@10, the batch timed at
    B = 1000, 1, 32 and split into its stages (``probes.tp_split``); on
    rank 0 the ids held against the same pipeline in plain PyTorch on one
    device (``probes.tp_fused_plain``);
(b) ``TPPredictionIndex`` over the single tree with the raw store, on
    its queries (``spec["single_queries"]``): the ids, on rank 0 held
    against ``exact_rerank`` over the union of the shards' pools
    (``probes.tp_path_plain``), and the all-reduce timed;
(c) ``MeshVForest``, ``lanes`` lanes in all, over the flagship's
    whitened rows: build time, the rank's lanes' arrays and leaves, the
    ids of the flagship's queries;
(d) ``CobwebQueryTrainer`` over (b)'s tree: 5 data-parallel steps at the
    global batch ``16 n``, held on rank 0 against single-process steps on
    a host copy (``train_steps.hold``), a step timed and the gradient
    all-reduce alone timed, then one epoch of ``fit_dp``;
(e) ``CobwebForest`` on the flagship's first ``forest_rows`` whitened
    rows: each row's own id among its top 10, and this shard's leaves
    against a single tree built here from the shard's rows alone;
(f) ``EndToEndQueryTrainer``: 2 data-parallel steps held likewise.

Every check raises in the rank, which fails the whole run.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from rag_cobweb_tpu_torch.bench import multichip

FLAGSHIP = "flagship.npz"
SINGLE = "single_tree.npz"


def write_flagship(out_dir: Path, fidx, raw, rows_w, queries_w, queries,
                   targets, cfg) -> Path:
    """The flagship's served fused index (bf16 GT kept as its f32 values),
    raw store, whitened corpus rows and queries, raw queries, gold rows
    and tree config, for the ranks."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / FLAGSHIP
    np.savez(path, GT=fidx.GT.float().cpu().numpy(),
             GT_bf16=np.asarray(fidx.GT.dtype == torch.bfloat16),
             c=fidx.c.cpu().numpy(), valid=fidx.valid.cpu().numpy(),
             raw=np.asarray(raw, np.float32),
             rows_w=np.asarray(rows_w, np.float32),
             queries_w=np.asarray(queries_w, np.float32),
             queries=np.asarray(queries, np.float32),
             targets=np.asarray(targets, np.int64),
             cfg=np.frombuffer(json.dumps(cfg.to_json_dict()).encode(),
                               np.uint8))
    return path


def _timer(card: bool):
    """``ms(fn, reps)``: mean ms of ``fn()`` over ``reps`` calls after one,
    between CUDA events on the card (host launch and syncs included: each
    call ends on the host), the host clock otherwise."""
    def ms(fn, reps: int) -> float:
        fn()
        if not card:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    return ms


def rank_main(rank: int, n: int, spec: dict, device: str) -> dict:
    import torch.distributed as dist
    from rag_cobweb_tpu_torch.bench import probes, train_steps
    from rag_cobweb_tpu_torch.bench.metrics import retrieval_metrics
    from rag_cobweb_tpu_torch.core import tree as tree_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.index import FusedIndex
    from rag_cobweb_tpu_torch.core.tree import CobwebTree
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.device import resolve_device
    from rag_cobweb_tpu_torch.files import read_npz
    from rag_cobweb_tpu_torch.parallel import (CobwebForest,
                                               TPFusedPredictionIndex,
                                               TPPredictionIndex, collectives,
                                               make_mesh)
    from rag_cobweb_tpu_torch.parallel.mesh_vforest import MeshVForest
    from rag_cobweb_tpu_torch.training import (CobwebQueryTrainer,
                                               EndToEndQueryTrainer)

    t_rank = time.perf_counter()
    dev = resolve_device(device)
    card = dev.type == "cuda"
    ms = _timer(card)

    def sync():
        if card:
            torch.cuda.synchronize()

    mesh = make_mesh(n)
    group = mesh.get_group("shard")
    k, pool = spec["k"], spec["pool"]
    out = {"rank": rank, "device": str(dev),
           "card": torch.cuda.get_device_name(dev) if card else "host",
           "backend": dist.get_backend()}
    F = read_npz(str(Path(spec["dir"]) / FLAGSHIP))
    cfg = TreeConfig.from_json_dict(json.loads(bytes(F["cfg"]).decode()))
    qw, qs, targets = F["queries_w"], F["queries"], F["targets"]

    # (a) the fused TP engine over the flagship's served index
    GT = torch.as_tensor(F["GT"])
    if bool(F["GT_bf16"]):
        GT = GT.to(torch.bfloat16)
    fidx = FusedIndex(GT=GT.to(dev), c=torch.as_tensor(F["c"], device=dev),
                      valid=torch.as_tensor(F["valid"], device=dev))
    tpf = TPFusedPredictionIndex(fidx, mesh, embeddings=F["raw"],
                                 device=dev)
    probes.zero_counters()
    _, ids_a = tpf.query_topk(qw, k, rerank=pool, queries_store=qs)
    sync()
    a = {"window": probes.read_counters(),
         "recall@10": retrieval_metrics(ids_a, targets, k)["recall@10"],
         "slab": (tuple(tpf.slab.GT.shape), str(tpf.slab.GT.dtype),
                  tpf.slab.width),
         "ms": {B: ms(lambda B=B: tpf.query_topk(
             qw[:B], k, rerank=pool, queries_store=qs[:B]), reps)
             for B, reps in ((len(qw), 10), (1, 30), (32, 30))}}
    if card:
        a["split"] = probes.tp_split(tpf, qw, qs, k, pool)
    for kern in ("fused_topk", "rerank_l2"):
        if card and a["window"][kern] <= 0:
            raise AssertionError(f"rank {rank}: {kern} never launched in "
                                 f"the TP window: {a['window']}")
    out["a"] = a

    # (b) the TP engine over the single tree, with its raw store
    db = CobwebIndex.load(str(Path(spec["dir"]) / SINGLE), device=dev)
    idx = db.build_prediction_index()
    raw_b = db._emb_device()[:len(db)].cpu().numpy()
    qs_b, gold = spec["single_queries"], spec["single_targets"]
    qw_b = db.whitener.transform_torch(
        torch.as_tensor(qs_b, device=dev)).cpu().numpy()
    tp = TPPredictionIndex(idx, mesh, embeddings=raw_b, device=dev)
    _, ids_b = tp.query_topk(qw_b, k, rerank=pool, queries_store=qs_b)
    buf = torch.zeros((len(qw_b), idx.num_nodes), device=dev)
    b = {"N": idx.num_nodes, "S": idx.num_sentences,
         "ms": ms(lambda: tp.query_topk(qw_b, k, rerank=pool,
                                        queries_store=qs_b), 5),
         "all_reduce_ms": ms(lambda: collectives.all_reduce_sum(buf, group),
                             5),
         "all_reduce_bytes": buf.nbytes,
         "recall@10": retrieval_metrics(ids_b, gold, k)["recall@10"]}
    del buf
    out["b"] = b

    # (c) the composed mesh forest over the flagship's whitened rows
    rows_w = F["rows_w"]
    lanes = spec["lanes"]
    m = MeshVForest(cfg, mesh, lanes_per_shard=lanes // n,
                    capacity_per_lane=spec["capacity_per_lane"], seed=0,
                    device=dev)
    sync()
    t0 = time.perf_counter()
    m.add(rows_w)
    sync()
    c_s = time.perf_counter() - t0
    mine = int(np.isin(np.asarray(m.shard_of), np.arange(
        m.lane0, m.lane0 + m.K)).sum())
    scores_c, ids_c = m.query_topk(qw, k)
    arrays = tree_mod.state_to_numpy(m.state)
    out["c"] = {"build_s": c_s, "rows": mine, "inserts_per_s": mine / c_s,
                "lane0": m.lane0,
                "arrays": {f: arrays[f] for f in (
                    "counts", "parent", "children", "n_children", "root",
                    "n_alloc", "free_top")},
                "leaves": m._leaf_of_local[m.lane0:m.lane0 + m.K],
                "ids": ids_c, "scores": scores_c}
    del m

    # (d) data-parallel steps of the query trainer over (b)'s tree
    host_db = (CobwebIndex.load(str(Path(spec["dir"]) / SINGLE),
                                device="cpu") if rank == 0 else None)
    G = spec["batch_per_rank"] * n
    tr = CobwebQueryTrainer(db, in_dim=qs_b.shape[1], hidden_dim=512,
                            lr=1e-3)
    steps = train_steps.dp_steps(train_steps.query_steps(qs_b, gold, n=5,
                                                         batch=G), tr, group)
    d = {"global_batch": G}
    if rank == 0:
        d["hold"] = train_steps.hold(tr, train_steps.host_copy(tr, host_db),
                                     steps)
        if not d["hold"]["ok"]:
            raise AssertionError(f"(d) fit_dp steps against fit steps: "
                                 f"{d['hold']['fails'][:4]}")
    else:
        for st in steps:
            st.run(tr)
    d["ms_per_step"] = ms(lambda: steps[0].run(tr), 10)
    params = list(tr.head.parameters())
    flat = torch.zeros(sum(p.numel() for p in params) + 1, device=dev)
    d["grad_all_reduce_ms"] = ms(
        lambda: collectives.all_reduce_sum(flat, group), 20)
    d["grad_all_reduce_bytes"] = flat.nbytes
    tr = CobwebQueryTrainer(db, in_dim=qs_b.shape[1], hidden_dim=512,
                            lr=1e-3)
    d["fit_dp_losses"] = tr.fit_dp(qs_b, gold, mesh, epochs=1, batch_size=G)
    if not all(math.isfinite(x) for x in d["fit_dp_losses"]):
        raise AssertionError(f"(d) fit_dp loss {d['fit_dp_losses']}")
    out["d"] = d

    # (f) data-parallel steps of the end-to-end trainer
    et = EndToEndQueryTrainer(db)
    esteps = train_steps.dp_steps(train_steps.e2e_steps(
        spec["texts"], gold, et.vocab_size, et.max_len, n=2, batch=G), et,
        group)
    f = {"global_batch": G}
    if rank == 0:
        f["hold"] = train_steps.hold(et, train_steps.host_copy(et, host_db),
                                     esteps)
        if not f["hold"]["ok"]:
            raise AssertionError(f"(f) fit_dp steps against fit steps: "
                                 f"{f['hold']['fails'][:4]}")
    else:
        for st in esteps:
            st.run(et)
    f["ms_per_step"] = ms(lambda: esteps[0].run(et), 5)
    out["f"] = f
    del tr, et, host_db

    # (e) one tree a rank on the flagship's first rows
    rows_e = rows_w[:spec["forest_rows"]]
    fo = CobwebForest(cfg, mesh, capacity_per_shard=4096, seed=0,
                      device=dev)
    sync()
    t0 = time.perf_counter()
    fo.add(rows_e)
    sync()
    e_s = time.perf_counter() - t0
    _, ids_e = fo.query_topk(rows_e, k)
    own = np.nonzero(np.arange(len(rows_e)) % n == fo.shard)[0]
    ref = CobwebTree(cfg, capacity=4096, seed=fo.shard, device=dev)
    ref_leaves = ref.fit(rows_e[own], batch_size=len(own))
    e = {"rows": len(own), "build_s": e_s,
         "inserts_per_s": len(own) / e_s,
         "found_itself": float(np.mean([b in ids_e[b]
                                        for b in range(len(rows_e))])),
         "leaves_equal_single_build":
             list(ref_leaves) == fo._leaf_of_local[fo.shard]}
    if not e["leaves_equal_single_build"]:
        raise AssertionError(f"(e) shard {fo.shard}: leaves differ from a "
                             "single-process build of its rows")
    out["e"] = e

    # every rank serves the same merged ids; rank 0 holds them against the
    # plain pipelines on one device
    out["ids_a"], out["ids_b"], out["ids_e"] = ids_a, ids_b, ids_e
    if rank == 0:
        out["a"]["plain"] = probes.tp_fused_plain(
            fidx, F["raw"], qw, qs, ids_a, k, pool, n, targets=targets)
        out["b"]["plain"] = probes.tp_path_plain(
            idx, raw_b, qw_b, qs_b, ids_b, k, pool, n)
    out["s"] = time.perf_counter() - t_rank
    return out


def run(spec: dict, n: int, device: str = "cuda",
        timeout: float = 600.0) -> list:
    """Phase 3j's ranks (module docstring); each rank's record, in rank
    order.  Every rank must serve the same ids."""
    recs = multichip.spawn(rank_main, n, spec, device=device,
                           timeout=timeout,
                           threads=1 if device == "cpu" else 0)
    for r in recs[1:]:
        for key in ("ids_a", "ids_b", "ids_e"):
            if not np.array_equal(r[key], recs[0][key]):
                raise AssertionError(f"rank {r['rank']} serves other ids "
                                     f"than rank 0 ({key})")
    return recs
