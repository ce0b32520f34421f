"""The port's sharded forest (``parallel/forest.CobwebForest``) on 2 and 4
gloo ranks against the JAX package's on the same-sized virtual CPU mesh,
on the JAX tests' data (``tests/test_forest.py``: 400 rows, 16-d).

* The JAX forest's state carried to the ranks (``interop``): the merged
  query ids equal the JAX facade's: the keys (leaf log-probs, the node
  log-prob's products summed in another order) within 1e-4 of each row's
  largest, the tolerance ``tests/test_tp.py`` gives node log-prob scores,
  and the ids equal wherever the key is not tied within it.
* The port's own build of the same rows in the same two adds (the
  second an incremental add): each shard's tree (structure and
  statistics, rounded to 4 decimals) equals the JAX shard's, the
  bookkeeping (``shard_of``, ``local_sid``, ``_leaf_of_local``) is equal,
  the ids are the JAX forest's, and an added row finds itself."""

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.parallel.forest import CobwebForest as JForest
from rag_cobweb_tpu.parallel.forest import make_mesh
from rag_cobweb_tpu_torch.bench import multichip
from rag_cobweb_tpu_torch.core import tree as tree_mod
from torch_parity import assert_equal_by_tie_group

torch.set_num_threads(1)
KEY_RTOL = 1e-4


def jax_lane_signature(state, lane):
    st = jax.device_get(state)
    return tree_mod.structure_signature(
        np.asarray(st.counts[lane]), np.asarray(st.means[lane]),
        np.asarray(st.children[lane]), np.asarray(st.n_children[lane]),
        int(st.root[lane]))


def jax_meta(f):
    return {"cfg": f.cfg.to_json_dict(), "shard_of": list(f.shard_of),
            "local_sid": list(f.local_sid),
            "leaf_of_local": [list(x) for x in f._leaf_of_local]}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(10, 16))
    xs = np.concatenate(
        [c + 0.2 * rng.normal(size=(40, 16)) for c in centers]
    ).astype(np.float32)
    return xs[rng.permutation(len(xs))]


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def run(request, data):
    n = request.param
    jf = JForest(JCfg(dim=16), mesh=make_mesh(n), capacity_per_shard=512,
                 seed=0)
    parts = [data[:200], data[200:]]
    jgids = [jf.add(p) for p in parts]
    rng = np.random.default_rng(1)
    q = (data[:50] + 0.05 * rng.normal(size=(50, 16))).astype(np.float32)
    state = {k: np.asarray(v) for k, v in
             jax.device_get(jf.state)._asdict().items()}
    payload = {"state": state, "meta": jax_meta(jf), "data": data,
               "parts": parts, "q": q}
    out = multichip.spawn(torch_ranks.forest_rank, n, payload,
                          device="cpu", timeout=300, threads=1)
    return n, jf, jgids, payload, out


def test_carried_state_serves_the_jax_ids(run):
    n, jf, _, p, out = run
    want_s, want_i = jf.query_topk(p["q"], k=10)
    for o in out:
        got_s, got_i = o["carried"]
        assert_equal_by_tie_group(want_i, got_i, want_s, got_s,
                                  rtol=KEY_RTOL)


def test_each_shard_is_the_jax_shard(run):
    n, jf, jgids, _, out = run
    for r, o in enumerate(out):
        assert o["signature"] == jax_lane_signature(jf.state, r), r
        assert o["gids"] == [g.tolist() for g in jgids]


def test_bookkeeping_is_the_jax_bookkeeping(run):
    n, jf, _, _, out = run
    want = (list(jf.shard_of), list(jf.local_sid),
            [list(x) for x in jf._leaf_of_local])
    for o in out:
        assert o["bookkeeping"] == want
    counts = np.bincount(np.asarray(out[0]["bookkeeping"][0]), minlength=n)
    assert counts.min() == counts.max() == 400 // n


def test_built_forest_serves_the_jax_ids(run):
    n, jf, _, p, out = run
    want_s, want_i = jf.query_topk(p["q"], k=10)
    for o in out:
        got_s, got_i = o["built"]
        assert_equal_by_tie_group(want_i, got_i, want_s, got_s,
                                  rtol=KEY_RTOL)
    assert (np.diff(out[0]["built"][0], axis=1) <= 1e-5).all()


def test_incremental_add_finds_itself(run):
    _, _, _, _, out = run
    for o in out:
        _, ids = o["incremental"]
        assert 300 in ids[0] and 301 in ids[1]


def test_jax_forest_loses_rows_whose_descent_the_budget_cuts(data):
    """A fault of the JAX package's sharded forest (``ROADMAP.md`` queue
    C), which the port does not copy: ``CobwebForest.add`` inserts through
    ``insert_batch`` at its 48-step budget and records a descent the
    budget cuts as leaf -1, with no retry on the exact path, so the row is
    lost and the next query raises.  Here the budget is forced down to 3
    steps on near-duplicate rows (the fringe chains that reach past 48
    steps at scale).  The port's shards insert through ``CobwebTree.fit``,
    which retries such a descent on the exact path."""
    import functools
    from rag_cobweb_tpu.core import tree as jtree
    deep = np.repeat(data[:4], 24, axis=0)[:, :13].copy()
    deep += 0.001 * np.random.default_rng(2).normal(
        size=deep.shape).astype(np.float32)
    orig = jtree.insert_batch
    jtree.insert_batch = functools.partial(orig, max_steps=3)
    try:
        jf = JForest(JCfg(dim=13), mesh=make_mesh(2),
                     capacity_per_shard=512)
        jf.add(deep)
    finally:
        jtree.insert_batch = orig
    assert sum(v < 0 for lst in jf._leaf_of_local for v in lst) > 0
    with pytest.raises(ValueError, match="dead tree nodes"):
        jf.query_topk(deep[:4], 4)
