"""The port's composed layout (``parallel/mesh_vforest.MeshVForest``, K
lanes a rank) on 2 and 4 gloo ranks against the JAX package's on the
same-sized virtual CPU mesh, on the JAX tests' data
(``tests/test_mesh_vforest.py``: 400 rows, 16-d, 4 lanes a rank).

* The JAX forest's state carried to the ranks: the merged ids equal the
  JAX facade's (leaf log-prob keys within 1e-4 of each row's largest, the
  tolerance ``tests/test_tp.py`` gives node log-prob scores; ids equal
  wherever the key is not tied within it).
* The port's build of the same rows in the same two adds: every lane's
  tree (structure and statistics, rounded to 4 decimals) equals the JAX
  lane's and the same lane of a single-process ``VForest(n_subtrees=L)``
  of the port, the bookkeeping is equal, the ids are the JAX forest's,
  and added rows find themselves.
* The deep-descent escalation: with ``_DEEP_STEPS`` forced down to 3 in
  both packages (near-duplicate fringe chains, one lane a rank), every
  cut descent goes to the exact path, every row lands on a leaf and is
  found, and each lane is the JAX lane by the North star's rule: equal
  slot for slot, or else the port's recorded build
  (``bench/build_divergence``) shows a decision within the float32
  rounding bound of its terms (a near tie) at or before the first insert
  whose leaf differs.  Rows 1e-3 apart make such near ties from the
  third insert on, in both packages' arithmetic."""

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.parallel import vforest as jvf
from rag_cobweb_tpu.parallel.forest import make_mesh
from rag_cobweb_tpu.parallel.mesh_vforest import MeshVForest as JMesh
from rag_cobweb_tpu_torch.bench import multichip
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.parallel.vforest import VForest
from test_torch_sharded_forest import jax_lane_signature, jax_meta
from torch_parity import assert_equal_by_tie_group

torch.set_num_threads(1)
KEY_RTOL = 1e-4
K = 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(10, 16))
    xs = np.concatenate(
        [c + 0.2 * rng.normal(size=(40, 16)) for c in centers]
    ).astype(np.float32)
    return xs[rng.permutation(len(xs))]


@pytest.fixture(scope="module")
def deep(data):
    """Near-duplicate fringe chains (the JAX test's rows, 11 of the 16
    columns so that the JAX insert program is traced afresh with the
    forced budget)."""
    xs = np.repeat(data[:4], 24, axis=0).astype(np.float32)
    xs = np.ascontiguousarray(xs[:, :11])
    return xs + 0.001 * np.random.default_rng(2).normal(
        size=xs.shape).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def run(request, data, deep):
    n = request.param
    mesh = make_mesh(n)
    jm = JMesh(JCfg(dim=16), mesh=mesh, lanes_per_shard=K,
               capacity_per_lane=256, seed=0)
    parts = [data[:200], data[200:]]
    jgids = [jm.add(p) for p in parts]
    saved = jvf._DEEP_STEPS
    jvf._DEEP_STEPS = 3
    try:
        jd = JMesh(JCfg(dim=deep.shape[1]), mesh=mesh, lanes_per_shard=1,
                   capacity_per_lane=512, seed=0)
        jd.add(deep)
    finally:
        jvf._DEEP_STEPS = saved
    rng = np.random.default_rng(1)
    q = (data[:50] + 0.05 * rng.normal(size=(50, 16))).astype(np.float32)
    state = {k: np.asarray(v) for k, v in
             jax.device_get(jm.state)._asdict().items()}
    payload = {"state": state, "meta": jax_meta(jm), "lanes": K,
               "data": data, "parts": parts, "q": q, "deep": deep,
               "deep_signatures": [jax_lane_signature(jd.state, lane)
                                   for lane in range(n)],
               "deep_leaves": [list(x) for x in jd._leaf_of_local]}
    out = multichip.spawn(torch_ranks.mesh_vforest_rank, n, payload,
                          device="cpu", timeout=300, threads=1)
    return n, jm, jd, jgids, payload, out


def every_lane(out, key):
    lanes = {}
    for o in out:
        lanes.update(o[key])
    return lanes


def test_carried_state_serves_the_jax_ids(run):
    n, jm, _, _, p, out = run
    want_s, want_i = jm.query_topk(p["q"], k=10)
    for o in out:
        got_s, got_i = o["carried"]
        assert_equal_by_tie_group(want_i, got_i, want_s, got_s,
                                  rtol=KEY_RTOL)


def test_each_lane_is_the_jax_lane(run):
    n, jm, _, jgids, _, out = run
    lanes = every_lane(out, "signatures")
    assert sorted(lanes) == list(range(n * K))
    for lane, sig in lanes.items():
        assert sig == jax_lane_signature(jm.state, lane), lane
    for o in out:
        assert o["gids"] == [g.tolist() for g in jgids]


def test_each_lane_is_the_single_process_forests(run, data):
    """Round-robin over L = N K lanes: lane for lane the tree of one
    ``VForest(n_subtrees=L)`` on the same rows."""
    n, _, _, _, p, out = run
    vf = VForest(TreeConfig(dim=16), n_subtrees=n * K,
                 capacity_per_tree=256, device="cpu")
    for part in p["parts"]:
        vf.add(part)
    for lane, sig in every_lane(out, "signatures").items():
        assert sig == vf.lane_signature(lane), lane
    assert out[0]["bookkeeping"][:2] == (vf.shard_of, vf.local_sid)


def test_bookkeeping_is_the_jax_bookkeeping(run):
    _, jm, _, _, _, out = run
    want = (list(jm.shard_of), list(jm.local_sid),
            [list(x) for x in jm._leaf_of_local])
    for o in out:
        assert o["bookkeeping"] == want


def test_built_forest_serves_the_jax_ids(run):
    _, jm, _, _, p, out = run
    want_s, want_i = jm.query_topk(p["q"], k=10)
    for o in out:
        got_s, got_i = o["built"]
        assert_equal_by_tie_group(want_i, got_i, want_s, got_s,
                                  rtol=KEY_RTOL)
        _, ids = o["incremental"]
        assert 300 in ids[0] and 301 in ids[1]


def test_deep_descents_escalate_as_in_jax(run, deep):
    n, _, jd, _, _, out = run
    lanes = every_lane(out, "deep_lanes")
    assert sorted(lanes) == list(range(n))
    for lane, rec in lanes.items():
        assert rec["equal"] or rec["near_ties"], (lane, rec)
    want = (list(jd.shard_of), list(jd.local_sid))
    for o in out:
        assert o["deep_bookkeeping"][:2] == want
        assert min(min(x) for x in o["deep_bookkeeping"][2]) >= 0
        _, got = o["deep_query"]
        assert (got >= 0).any(axis=1).all()
