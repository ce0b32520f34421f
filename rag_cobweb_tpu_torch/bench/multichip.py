"""Multi-device runs of the port: the rank launcher and the dry run of
every multi-device module.

    python -m rag_cobweb_tpu_torch.bench.multichip [--ranks N]
        [--device cuda|cpu]

``spawn(fn, n, payload, device)`` starts ``n`` ranks with
``torch.multiprocessing`` (``spawn``, never a fork of a process whose CUDA
is up), starts their process group through a file under a temporary
directory, runs ``fn(rank, n, payload, device)`` on each and returns
their results in rank order; a rank that raises fails the call, and a
call past ``timeout`` seconds kills the ranks and raises.  On the card
the ranks map to the cards one to one over NCCL while there are as many
cards as ranks; with fewer cards they share them over gloo (NCCL refuses
two ranks on one card), rank ``r`` on card ``r % cards``.  On the host
(``device="cpu"``) they run gloo.

``dryrun_multichip(n, device)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, the same five steps and checks on
``n`` ranks: the sharded forest (each query finds itself), the TP index
with a re-rank, the fused TP index in bf16 with stored rows, the composed
``MeshVForest``, and two epochs of ``CobwebQueryTrainer.fit_dp`` (the loss
falls).  ``--ranks`` defaults to the cards (2 on one card, or on the
host).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "rag_cobweb_tpu")


def rank_layout(n: int, device: str):
    """(backend, cards) of ``n`` ranks on ``device``: NCCL with a card a
    rank, else gloo (the host, or ranks sharing fewer cards)."""
    if torch.device(device).type == "cpu":
        return "gloo", 0
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the host")
    return ("nccl" if cards >= n else "gloo"), cards


def _rank_main(rank, n, fn, tmp, device, backend, env, threads):
    os.environ.update(env)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(n))
    if threads:
        torch.set_num_threads(threads)
    import torch.distributed as dist
    from rag_cobweb_tpu_torch.parallel.distributed import initialize
    initialize(device=device, backend=backend, num_processes=n,
               process_id=rank, init_method=f"file://{tmp}/pg")
    with open(Path(tmp) / "payload.pkl", "rb") as f:
        payload = pickle.load(f)
    try:
        out = fn(rank, n, payload, device)
        # a barrier before teardown: no rank leaves while another still
        # waits on a collective
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def spawn(fn, n: int, payload=None, device: str = "cuda",
          timeout: float = 600.0, env=None, threads: int = 0) -> list:
    """Run ``fn(rank, n, payload, device)`` on ``n`` ranks (module
    docstring); returns the ranks' results.  ``env`` is set in every rank
    before its group starts; ``threads`` (0: torch's default) its
    intra-op threads."""
    import torch.multiprocessing as mp
    backend, _ = rank_layout(n, device)
    with tempfile.TemporaryDirectory() as tmp:
        # the payload goes through a file: through the spawn pipe, a large
        # one holds each start until the rank before has imported torch
        with open(Path(tmp) / "payload.pkl", "wb") as f:
            pickle.dump(payload, f)
        ctx = mp.start_processes(
            _rank_main, args=(n, fn, tmp, device, backend,
                              dict(env or {}), threads),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks still running after "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(n):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    return out


def _dryrun_rank(rank: int, n: int, payload, device: str) -> dict:
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.tree import CobwebTree
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.parallel import (CobwebForest,
                                               TPFusedPredictionIndex,
                                               TPPredictionIndex,
                                               forest_mesh, initialize)
    from rag_cobweb_tpu_torch.parallel.mesh_vforest import MeshVForest
    from rag_cobweb_tpu_torch.training.query_train import CobwebQueryTrainer

    dim = 32
    initialize(device=device)      # already started: returns at once
    mesh = forest_mesh(shards_per_host=n)
    assert mesh.size() == n, mesh
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8 * n, dim)).astype(np.float32)

    def finds_itself(ids, what):
        if not all(b in ids[b] for b in range(len(ids))):
            raise AssertionError(f"{what}: a query missed itself: {ids}")

    # 1) sharded insert + the cross-shard query
    forest = CobwebForest(TreeConfig(dim=dim), mesh=mesh,
                          capacity_per_shard=128, seed=0, device=device)
    forest.add(xs)
    _, gids = forest.query_topk(xs[:4], k=5)
    assert gids.shape == (4, 5)
    finds_itself(gids, "sharded forest")

    # 2) one tree's index split over the ranks (stats along D, paths
    #    along S), re-ranked by leaf log-prob
    tree = CobwebTree(TreeConfig(dim=dim), capacity=512, seed=0,
                      device=device)
    leaves = tree.fit(xs)
    tidx = index_mod.build_index(tree, leaves)
    _, tp_ids = TPPredictionIndex(tidx, mesh, device=device).query_topk(
        xs[:4], k=5, rerank=16)
    finds_itself(tp_ids, "TP index")

    # 3) the fused form split along S, bf16, stored rows (kernels 1, 5)
    fidx = index_mod.build_fused_index(tidx, dtype=torch.bfloat16)
    _, tpf_ids = TPFusedPredictionIndex(fidx, mesh, embeddings=xs,
                                        device=device).query_topk(
        xs[:4], k=5, rerank=16)
    finds_itself(tpf_ids, "fused TP index")

    # 4) the composed layout: 2 lanes a rank
    mvf = MeshVForest(TreeConfig(dim=dim), mesh=mesh, lanes_per_shard=2,
                      capacity_per_lane=128, seed=0, device=device)
    mvf.add(xs)
    _, mv_ids = mvf.query_topk(xs[:4], k=5)
    finds_itself(mv_ids, "mesh vforest")

    # 5) data-parallel training of the query trainer
    db = CobwebIndex(corpus_embeddings=xs, config=TreeConfig(dim=dim),
                     device=device)
    trainer = CobwebQueryTrainer(db, in_dim=dim, hidden_dim=32, lr=1e-3,
                                 seed=0)
    rng2 = np.random.default_rng(1)
    gold = rng2.choice(len(xs), size=4 * n, replace=False)
    queries = (xs[gold] + 0.05 * rng2.normal(size=(len(gold), dim))
               ).astype(np.float32)
    losses = trainer.fit_dp(queries, gold, mesh, epochs=2,
                            batch_size=2 * n)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fit_dp: the loss did not fall: {losses}")
    return {"rank": rank, "lanes": mvf.L, "losses": losses,
            "ids": [gids.tolist(), tp_ids.tolist(), tpf_ids.tolist(),
                    mv_ids.tolist()],
            # what the rank loaded of the JAX package or of JAX: nothing
            "jax_modules": sorted(m for m in sys.modules if m.split(".")[0]
                                  in JAX_ROOTS)}


def dryrun_multichip(n: int, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """The five steps on ``n`` ranks; every rank must return the same
    merged ids and losses.  Returns rank 0's record with the layout."""
    backend, cards = rank_layout(n, device)
    recs = spawn(_dryrun_rank, n, device=device, timeout=timeout,
                 threads=1 if device == "cpu" else 0)
    for r in recs[1:]:
        if r["ids"] != recs[0]["ids"] or r["losses"] != recs[0]["losses"]:
            raise AssertionError(f"rank {r['rank']} disagrees with rank 0")
    out = dict(recs[0], ranks=n, backend=backend, cards=cards,
               device=device)
    out.pop("rank")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0)
    a = ap.parse_args(argv)
    cards = torch.cuda.device_count() if a.device != "cpu" else 0
    n = a.ranks or max(2, min(cards, 4))
    rec = dryrun_multichip(n, a.device)
    print(json.dumps({k: v for k, v in rec.items() if k != "ids"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
