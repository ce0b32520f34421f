"""K-lane forest parity of the PyTorch port: on the same rows with the same
K, every lane's tree (structure and statistics, rounded to 4 decimals)
and the global leaf id of every sentence equal the JAX VForest's.  One
case forces the primary budget down to 4 steps, so that most descents are
cut, retried in the deep waves, and the budget ladder moves."""

import jax
import numpy as np
import pytest

from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.parallel.vforest import VForest
import torch

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


def clustered(n, D, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(10, D))
    return (centers[rng.integers(0, 10, n)]
            + 0.5 * rng.normal(size=(n, D))).astype(np.float32)


def jax_lane_signature(vf, lane):
    st = jax.device_get(vf.state)
    return tree_mod.structure_signature(
        np.asarray(st.counts[lane]), np.asarray(st.means[lane]),
        np.asarray(st.children[lane]), np.asarray(st.n_children[lane]),
        int(st.root[lane]))


@pytest.mark.parametrize("n,D,K,budget,parts,cap", [
    (240, 8, 4, None, 3, 64),      # grows the lanes' capacity
    (200, 12, 3, 4, 2, 256),
    (120, 16, 2, None, 1, 256),
], ids=["k4-three-adds", "k3-budget4", "k2-one-add"])
def test_forest_matches_jax(n, D, K, budget, parts, cap):
    xs = clustered(n, D, seed=n + K)
    jf = JForest(JCfg(dim=D), n_subtrees=K, capacity_per_tree=cap, seed=0)
    tf = VForest(TreeConfig(dim=D), n_subtrees=K, capacity_per_tree=cap,
                 device="cpu")
    if budget:
        jf._budget = tf._budget = budget
    for part in np.array_split(xs, parts):
        np.testing.assert_array_equal(jf.add(part), tf.add(part))
    assert tf.state.capacity == jf.state.counts.shape[1]
    assert tf._budget == jf._budget
    for lane in range(K):
        assert tf.lane_signature(lane) == jax_lane_signature(jf, lane), lane
    np.testing.assert_array_equal(tf._leaf_global(), jf._leaf_global())
    assert tf.shard_of == jf.shard_of
    assert tf.local_sid == jf.local_sid
    st = jax.device_get(jf.state)
    got = tree_mod.state_to_numpy(tf.state)
    for f in ("parent", "children", "n_children", "free_stack", "free_top",
              "n_alloc", "root"):
        np.testing.assert_array_equal(np.asarray(getattr(st, f)), got[f],
                                      err_msg=f)


def test_budget_ladder_reaches_the_wave_budget():
    """A non-standard primary budget jumps straight to the wave budget
    once the deep fraction's moving average passes 8%."""
    xs = clustered(160, 6, seed=3)
    tf = VForest(TreeConfig(dim=6), n_subtrees=1, capacity_per_tree=32,
                 device="cpu")
    tf._budget = 4
    tf.add(xs)
    assert tf._budget == 48
    assert tf._deep_frac > 0.08
    assert (tf._leaf_global() >= 0).all()


def test_content_routing_is_not_ported():
    """Content routing, which raised here until it was ported, now builds
    the JAX VForest's lanes and trees from the same rows (the full
    parity checks are in tests/test_torch_routing.py)."""
    xs = clustered(120, 6, seed=4)
    jf = JForest(JCfg(dim=6), n_subtrees=3, capacity_per_tree=64, seed=0,
                 routing="content")
    tf = VForest(TreeConfig(dim=6), n_subtrees=3, capacity_per_tree=64,
                 routing="content", device="cpu")
    for part in np.array_split(xs, 2):
        np.testing.assert_array_equal(tf.add(part), jf.add(part))
    assert tf.cfg.absorb_depth == jf.cfg.absorb_depth == 24
    assert tf.shard_of == jf.shard_of
    assert tf.local_sid == jf.local_sid
    for lane in range(3):
        assert tf.lane_signature(lane) == jax_lane_signature(jf, lane), lane
