"""The port's process-group layer (``parallel/distributed.py``), its
candidate merge (``parallel/collectives.py``) and the multi-device dry run
(``bench/multichip.py``), on gloo ranks on the host.

``initialize()`` is held to each env contract (the JAX package's, its
SLURM fallback, torchrun's) by starting real two-rank groups over
localhost; ``forest_mesh`` to the JAX layout: ``("replica", "shard")`` of
shape (2, 2) for 4 ranks posing as 2 hosts (``LOCAL_WORLD_SIZE=2``, the
counterpart of ``tests/test_distributed.py``), ``("shard",)`` on one
host.  The merge is held to ``jax.lax.top_k`` over the same gathered
(B, K * kk) layout, on candidates full of ties."""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from rag_cobweb_tpu_torch.bench import multichip
from rag_cobweb_tpu_torch.parallel.distributed import launch_config

torch.set_num_threads(1)

CONTRACT_KEYS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID", "SLURM_NTASKS", "SLURM_PROCID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("env,args,want", [
    ({}, {}, None),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "2"}, {}, ("tcp://h:1", 4, 2)),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "SLURM_NTASKS": "8",
      "SLURM_PROCID": "5"}, {}, ("tcp://h:1", 8, 5)),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4",
      "SLURM_NTASKS": "8", "JAX_PROCESS_ID": "1", "SLURM_PROCID": "5"}, {},
     ("tcp://h:1", 4, 1)),
    ({"MASTER_ADDR": "m", "MASTER_PORT": "7", "WORLD_SIZE": "3",
      "RANK": "0"}, {}, ("tcp://m:7", 3, 0)),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "2"},
     {"coordinator_address": "x:9", "num_processes": 2, "process_id": 1},
     ("tcp://x:9", 2, 1)),
], ids=["none", "jax", "slurm", "jax-over-slurm", "torchrun", "explicit"])
def test_launch_config_reads_each_contract(env, args, want):
    assert launch_config(env=env, **args) == want


def test_launch_config_refuses_a_partial_contract():
    with pytest.raises(ValueError):
        launch_config(env={"JAX_COORDINATOR_ADDRESS": "h:1"})
    with pytest.raises(ValueError):
        launch_config(num_processes=2, env={})


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    import torch.distributed as dist
    from rag_cobweb_tpu_torch.parallel.distributed import initialize
    for k in CONTRACT_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert initialize(device="cpu") is False
    assert not dist.is_initialized()


def test_initialize_starts_a_group_from_each_contract():
    """Two ranks start, check and tear down a group from each contract
    in turn, over localhost ports chosen free just before."""
    import torch.multiprocessing as mp
    p1, p2, p3 = free_port(), free_port(), free_port()
    contracts = [
        ({"JAX_COORDINATOR_ADDRESS": f"localhost:{p1}",
          "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "{rank}"}, "jax"),
        ({"JAX_COORDINATOR_ADDRESS": f"localhost:{p2}",
          "SLURM_NTASKS": "2", "SLURM_PROCID": "{rank}"}, "slurm"),
        ({"MASTER_ADDR": "localhost", "MASTER_PORT": str(p3),
          "WORLD_SIZE": "2", "RANK": "{rank}"}, "torchrun"),
    ]
    ctx = mp.start_processes(torch_ranks.env_contract_rank,
                             args=(contracts,), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in ctx.processes)


@pytest.fixture(scope="module")
def mesh_run():
    rng = np.random.default_rng(0)
    # 4 ranks x (B=6, kk=5) candidates drawn from 3 values: ties
    # everywhere, within and across ranks; ids unique
    scores = rng.integers(0, 3, size=(4, 6, 5)).astype(np.float32)
    scores[1, 0, :] = -np.inf
    ids = np.arange(4 * 6 * 5).reshape(4, 6, 5) * 7 % 1000
    payload = {"scores": scores, "ids": ids.astype(np.int64),
               "ks": [1, 3, 5, 12, 25]}
    out = multichip.spawn(torch_ranks.mesh_rank, 4, payload, device="cpu",
                          timeout=240, env={"LOCAL_WORLD_SIZE": "2"},
                          threads=1)
    return payload, out


def test_forest_mesh_poses_two_hosts(mesh_run):
    _, out = mesh_run
    for r, o in enumerate(out):
        names, shape, shards, grid, members = o["hosts"]
        assert names == ("replica", "shard") and shape == (2, 2)
        assert shards == 2 and grid == [[0, 1], [2, 3]]
        assert members == ([0, 1] if r < 2 else [2, 3])


def test_forest_mesh_on_one_host(mesh_run):
    _, out = mesh_run
    for o in out:
        assert o["one_host"] == (("shard",), (4,), 4)


def test_merge_keeps_the_jax_tie_order(mesh_run):
    """The merged top-k equals ``jax.lax.top_k`` over the (B, K * kk)
    layout of every rank's candidates, ids included, on every rank."""
    payload, out = mesh_run
    s, i = payload["scores"], payload["ids"]
    merged = jnp.asarray(s.transpose(1, 0, 2).reshape(6, 20))
    mids = i.transpose(1, 0, 2).reshape(6, 20)
    for j, k in enumerate(payload["ks"]):
        want_s, pos = jax.lax.top_k(merged, min(k, 20))
        want_i = np.take_along_axis(mids, np.asarray(pos), 1)
        for o in out:
            got_s, got_i = o["merge"][j]
            np.testing.assert_array_equal(got_s, np.asarray(want_s))
            np.testing.assert_array_equal(got_i, want_i)
    for o in out:
        np.testing.assert_array_equal(o["gather"], i[:, :2])


def test_dryrun_multichip_on_two_host_ranks():
    rec = multichip.dryrun_multichip(2, "cpu", timeout=300)
    assert rec["ranks"] == 2 and rec["backend"] == "gloo"
    assert rec["lanes"] == 4
    assert rec["losses"][-1] < rec["losses"][0]
    assert rec["jax_modules"] == []     # spawned from this JAX process


def test_multi_device_entry_points_refuse_the_host_by_default(tmp_path):
    """A one-rank group on the host: each facade without ``device`` asks
    for the card and raises, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import torch.distributed as dist
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.index import FusedIndex
    from rag_cobweb_tpu_torch.parallel import (CobwebForest,
                                               TPFusedPredictionIndex,
                                               make_mesh)
    from rag_cobweb_tpu_torch.parallel.mesh_vforest import MeshVForest
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        fidx = FusedIndex(torch.zeros((4, 2048)), torch.zeros(2048),
                          torch.ones(2048, dtype=torch.bool))
        for make in (lambda: CobwebForest(TreeConfig(dim=2), mesh),
                     lambda: MeshVForest(TreeConfig(dim=2), mesh),
                     lambda: TPFusedPredictionIndex(fidx, mesh)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multichip.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multichip.spawn(torch_ranks.mesh_rank, 2)
    finally:
        dist.destroy_process_group()


def test_phase_3j_rehearsal(tmp_path):
    """``chip_smoke.py``'s phase 3j on 2 gloo host ranks at a small size:
    a 256-row whitener-mode 4-lane forest and single tree (PCA+ICA, as
    phases 3 and 3c build them), their inputs written as the parent
    writes them, then the phase with its checks ((a) and (b) held against
    their plain pipelines, (c) lane for lane against one forest, (d) and
    (f) held against single-process steps, (e) each row found)."""
    import chip_smoke
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = synthetic_retrieval_hard(256, 48, 48, seed=3)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.96, seed=0)
    fdb = CobwebIndex(config=TreeConfig(dim=w.dim_out), n_subtrees=4,
                      whitener=w, device="cpu")
    fdb.add_sentences([None] * len(data.corpus_embs), data.corpus_embs)
    chip_smoke.write_multichip_flagship(fdb, data, tmp_path)
    sdb = CobwebIndex(corpus_embeddings=data.corpus_embs, whitener=w,
                      device="cpu")
    single = chip_smoke.write_multichip_single(sdb, data, tmp_path)
    rec = chip_smoke.multichip_phase(
        0.0, tmp_path, *single, device="cpu", lanes=8, pool=64,
        forest_rows=64, capacity_per_lane=256)
    assert rec["world"] == 2 and rec["backend"] == "gloo"
    assert rec["c"]["lanes_differing"] == []
    assert rec["d"]["hold"]["ok"] and rec["f"]["hold"]["ok"]
    assert rec["a"]["plain"]["queries_differing_from_plain"] == 0
    chip_smoke.log_multichip(rec, "host")
