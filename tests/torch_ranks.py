"""Rank programs of the port's multi-device tests (``tests/test_torch_*``):
each runs on every gloo rank that ``bench/multichip.spawn`` starts on the
host and returns what its test module compares with the JAX package.
Not a test module (pytest does not collect it), and it imports nothing
of JAX or of the JAX package: the ranks load this module by name.

Every program takes ``(rank, n, payload, device)``; the payload carries
the seeded inputs and the JAX package's states as numpy arrays."""

import os

import numpy as np
import torch

from rag_cobweb_tpu_torch.bench import build_divergence


def _mesh(n):
    from rag_cobweb_tpu_torch.parallel.forest import make_mesh
    return make_mesh(n)


# --------------------------------------------------------------------------
# parallel/distributed.py and the merge
# --------------------------------------------------------------------------

def env_contract_rank(rank, contracts):
    """Start a group from each env contract in turn ((env, name) pairs;
    ``{rank}`` in a value is this rank), check it with an all_reduce and
    tear it down.  Run by ``torch.multiprocessing`` directly: the
    launcher's own start would come first."""
    import torch.distributed as dist
    from rag_cobweb_tpu_torch.parallel.distributed import initialize
    torch.set_num_threads(1)
    for env, _ in contracts:
        saved = dict(os.environ)
        os.environ.update({k: v.format(rank=rank) for k, v in env.items()})
        try:
            assert initialize(device="cpu")
            t = torch.ones(1) * (rank + 1)
            dist.all_reduce(t)
            n = dist.get_world_size()
            assert dist.get_rank() == rank and float(t) == n * (n + 1) / 2
            dist.destroy_process_group()
        finally:
            os.environ.clear()
            os.environ.update(saved)


def mesh_rank(rank, n, payload, device):
    """``forest_mesh`` as posed by ``LOCAL_WORLD_SIZE`` (set by the test),
    then as one host, and the candidate merge on seeded ties."""
    import torch.distributed as dist
    from rag_cobweb_tpu_torch.parallel import collectives
    from rag_cobweb_tpu_torch.parallel.distributed import (
        axis_group, forest_mesh, local_shard_count)
    out = {}
    m = forest_mesh()
    out["hosts"] = (m.mesh_dim_names, tuple(m.shape),
                    local_shard_count(m), m.mesh.tolist(),
                    dist.get_process_group_ranks(m.get_group("shard")))
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    m1 = forest_mesh()
    out["one_host"] = (m1.mesh_dim_names, tuple(m1.shape),
                       local_shard_count(m1))
    m2 = forest_mesh(shards_per_host=n)
    group, shard, K = axis_group(m2, "shard")
    s = torch.as_tensor(payload["scores"][rank])
    i = torch.as_tensor(payload["ids"][rank])
    out["merge"] = [tuple(t.numpy() for t in collectives.merge_topk(
        s, i, k, group)) for k in payload["ks"]]
    out["gather"] = collectives.all_gather(i[:2], group).numpy()
    return out


# --------------------------------------------------------------------------
# parallel/tp.py
# --------------------------------------------------------------------------

def tp_rank(rank, n, p, device):
    """Both TP engines on the JAX package's index, carried across."""
    from rag_cobweb_tpu_torch import interop
    from rag_cobweb_tpu_torch.parallel.tp import (TPFusedPredictionIndex,
                                                  TPPredictionIndex)
    mesh = _mesh(n)
    idx = interop.prediction_index_from_numpy(p["index"], device="cpu")
    out = {}
    tp = TPPredictionIndex(idx, mesh, device="cpu")
    out["path"] = tp.query_topk(p["q"], 5)
    out["path_leaf"] = tp.query_topk(p["q"], 5, rerank=32)
    out["local_shapes"] = tuple(tuple(a.shape) for a in tp.tpidx)
    tpe = TPPredictionIndex(idx, mesh, embeddings=p["xs"], device="cpu")
    out["path_exact"] = tpe.query_topk(p["q2"], 5, rerank=64)
    for dt, (GT, c, valid) in p["fused"].items():
        fidx = interop.fused_index_from_numpy(GT, c, valid, device="cpu")
        if dt == "bf16":
            fidx = fidx._replace(GT=fidx.GT.to(torch.bfloat16))
        out[f"fused_{dt}"] = TPFusedPredictionIndex(
            fidx, mesh, device="cpu").query_topk(p["q"], 5)
        out[f"fused_exact_{dt}"] = TPFusedPredictionIndex(
            fidx, mesh, embeddings=p["xs"], device="cpu").query_topk(
            p["q2"], 5, rerank=64)
    return out


# --------------------------------------------------------------------------
# parallel/forest.py: CobwebForest
# --------------------------------------------------------------------------

def _bookkeeping(f):
    return (list(f.shard_of), list(f.local_sid),
            [list(x) for x in f._leaf_of_local])


def forest_rank(rank, n, p, device):
    """The JAX forest's state carried across and served; the port's own
    build of the same rows in the same two adds."""
    from rag_cobweb_tpu_torch import interop
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.parallel.forest import CobwebForest
    mesh = _mesh(n)
    out = {}
    carried = interop.forest_shard_from_numpy(p["state"], p["meta"], mesh,
                                              device="cpu")
    out["carried"] = carried.query_topk(p["q"], 10)
    data = p["data"]
    f = CobwebForest(TreeConfig(dim=data.shape[1]), mesh,
                     capacity_per_shard=512, seed=0, device="cpu")
    out["gids"] = [f.add(part).tolist() for part in p["parts"]]
    out["signature"] = f.tree.signature()
    out["bookkeeping"] = _bookkeeping(f)
    out["built"] = f.query_topk(p["q"], 10)
    out["incremental"] = f.query_topk(data[300:302], 3)
    return out


# --------------------------------------------------------------------------
# parallel/mesh_vforest.py
# --------------------------------------------------------------------------

def _near_tie_record(trace, lane, sig, want_sig, leaves, want_leaves):
    """A lane against the JAX lane by the North star's rule: equal (the
    signature and every row's leaf), else the first insert whose leaf
    differs and the near ties (``build_divergence.near_ties``) the
    recorded build shows up to it."""
    if sig == want_sig and leaves == want_leaves:
        return {"equal": True}
    first = next((i for i, (a, b) in enumerate(zip(want_leaves, leaves))
                  if a != b), min(len(want_leaves), len(leaves)))
    return {"equal": False, "first": first,
            "near_ties": build_divergence.near_ties(trace, lane, first)}


def mesh_vforest_rank(rank, n, p, device):
    """The JAX composed forest carried across and served; the port's
    build in the same adds; the deep-descent escalation with the budget
    forced down (``_DEEP_STEPS``)."""
    from rag_cobweb_tpu_torch import interop
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.parallel import vforest
    from rag_cobweb_tpu_torch.parallel.mesh_vforest import MeshVForest
    mesh = _mesh(n)
    K = p["lanes"]
    out = {}
    carried = interop.mesh_vforest_from_numpy(p["state"], p["meta"], K,
                                              mesh, device="cpu")
    out["carried"] = carried.query_topk(p["q"], 10)
    data = p["data"]
    m = MeshVForest(TreeConfig(dim=data.shape[1]), mesh, lanes_per_shard=K,
                    capacity_per_lane=256, seed=0, device="cpu")
    out["gids"] = [m.add(part).tolist() for part in p["parts"]]
    out["signatures"] = {m.lane0 + i: m.forest.lane_signature(i)
                         for i in range(K)}
    out["bookkeeping"] = _bookkeeping(m)
    out["built"] = m.query_topk(p["q"], 10)
    out["incremental"] = m.query_topk(data[300:302], 3)
    deep = p["deep"]
    saved = vforest._DEEP_STEPS
    vforest._DEEP_STEPS = 3
    try:
        d = MeshVForest(TreeConfig(dim=deep.shape[1]), mesh,
                        lanes_per_shard=1, capacity_per_lane=512, seed=0,
                        device="cpu")
        with build_divergence._Recorder() as rec:
            d.add(deep)
    finally:
        vforest._DEEP_STEPS = saved
    out["deep_bookkeeping"] = _bookkeeping(d)
    out["deep_query"] = d.query_topk(deep[:4], 4)
    out["deep_lanes"] = {d.lane0: _near_tie_record(
        build_divergence.Trace(d.forest, rec), 0, d.forest.lane_signature(0),
        p["deep_signatures"][d.lane0], d._leaf_of_local[d.lane0],
        p["deep_leaves"][d.lane0])}
    return out


# --------------------------------------------------------------------------
# training: the two fit_dp
# --------------------------------------------------------------------------

def train_rank(rank, n, p, device):
    """Both trainers' ``fit_dp`` from the JAX package's initial
    parameters on its trees (its ``save`` files), and the two
    refusals."""
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.training.flax_layout import load_flax, to_flax
    from rag_cobweb_tpu_torch.training.query_train import CobwebQueryTrainer
    from rag_cobweb_tpu_torch.training.text_encoder import \
        EndToEndQueryTrainer
    mesh = _mesh(n)
    out = {}
    q = p["query"]
    db = CobwebIndex.load(q["db"], device="cpu")
    tr = CobwebQueryTrainer(db, in_dim=q["queries"].shape[1],
                            hidden_dim=q["hidden"], lr=1e-3, seed=0)
    load_flax(tr.head, q["params"])
    out["query"] = (tr.fit_dp(q["queries"], q["gold"], mesh,
                              epochs=q["epochs"], batch_size=q["batch"]),
                    to_flax(tr.head))
    e = p["e2e"]
    edb = CobwebIndex.load(e["db"], device="cpu")
    et = EndToEndQueryTrainer(edb, **e["settings"])
    load_flax(et.encoder, e["enc_params"])
    load_flax(et.head, e["head_params"])
    out["e2e"] = (et.fit_dp(e["texts"], e["gold"], mesh, epochs=e["epochs"],
                            batch_size=e["batch"]),
                  to_flax(et.encoder), to_flax(et.head))
    errors = {}
    for name, call in (
            ("empty", lambda: tr.fit_dp(q["queries"][:0], q["gold"][:0],
                                        mesh, batch_size=2 * n)),
            ("indivisible", lambda: tr.fit_dp(q["queries"], q["gold"], mesh,
                                              batch_size=2 * n + 1)),
            ("e2e_indivisible", lambda: et.fit_dp(
                e["texts"], e["gold"], mesh, batch_size=2 * n + 1))):
        try:
            call()
            errors[name] = None
        except ValueError as err:
            errors[name] = str(err)
    out["errors"] = errors
    out["steps_after_errors"] = (tr.step, et.step)
    return out
