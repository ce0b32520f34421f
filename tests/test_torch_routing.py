"""Content routing and forest files of the PyTorch port against the JAX
package: the same rows through both ``VForest(routing="content")`` give
the same lanes, lane rows, centroids (1e-5), load counters and trees;
``select_lanes`` agrees on both routings; and a forest file written by
either package loads in the other with equal state, router included."""

import jax
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.parallel.vforest import VForest

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

K, D = 4, 8


def clustered(n, seed, scale=4.0):
    """Rows around 6 well-separated centres, so that no row's nearest
    centroid is a near-tie."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(6, D))
    return (centers[rng.integers(0, 6, n)]
            + 0.4 * rng.normal(size=(n, D))).astype(np.float32)


def batches(case):
    xs = clustered(240, seed=3)
    skew = (xs[0] + 0.05 * np.random.default_rng(4).normal(
        size=(70, D))).astype(np.float32)
    if case == "skewed":
        # the second add lands on one lane and overflows its load cap, so
        # the spill passes run
        return [xs[:120], skew, xs[120:200]]
    # a first batch smaller than K: centroids drawn from it with
    # replacement plus 1e-3 noise, so each of its rows lies within
    # ~1e-6 D (the noise's squared norm) of two centroids.  That margin
    # must stand clear of float32 rounding of the scores (~1e-7 |x|^2,
    # and the two packages' products round differently), so these rows
    # are scaled to |x|^2 ~ 0.05
    return [0.02 * xs[:2], 0.02 * xs[2:150], 0.02 * skew[:30]]


def jax_lane_signature(vf, lane):
    st = jax.device_get(vf.state)
    return tree_mod.structure_signature(
        np.asarray(st.counts[lane]), np.asarray(st.means[lane]),
        np.asarray(st.children[lane]), np.asarray(st.n_children[lane]),
        int(st.root[lane]))


def assert_forests_equal(jf, tf):
    assert tf.routing == jf.routing
    assert tf.cfg == TreeConfig.from_json_dict(jf.cfg.to_json_dict())
    assert tf.shard_of == [int(s) for s in jf.shard_of]
    assert tf.local_sid == [int(s) for s in jf.local_sid]
    if jf._centroids is None:
        assert tf._centroids is None
    else:
        np.testing.assert_allclose(tf._centroids, jf._centroids, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tf._route_count, jf._route_count)
    np.testing.assert_array_equal(tf._lane_total, jf._lane_total)
    np.testing.assert_array_equal(tf._leaf_global(), jf._leaf_global())
    for lane in range(tf.K):
        assert tf.lane_signature(lane) == jax_lane_signature(jf, lane), lane


@pytest.fixture(scope="module", params=["skewed", "first-below-K"])
def routed(request):
    jf = JForest(JCfg(dim=D), n_subtrees=K, capacity_per_tree=128, seed=0,
                 routing="content")
    tf = VForest(TreeConfig(dim=D), n_subtrees=K, capacity_per_tree=128,
                 routing="content", device="cpu")
    for part in batches(request.param):
        np.testing.assert_array_equal(tf.add(part), jf.add(part))
    return jf, tf


def test_content_routing_matches_jax(routed):
    """Three adds, one skewed or one first batch below K: lanes, lane
    rows, centroids, counters, every lane's tree and leaf ids equal."""
    jf, tf = routed
    assert tf.cfg.absorb_depth == jf.cfg.absorb_depth == 24
    assert len(set(tf.shard_of)) == K
    assert_forests_equal(jf, tf)


def test_absorb_depth_rule():
    """``routing="content"`` turns absorb on (24) unless it is set;
    round-robin leaves it as given."""
    assert VForest(TreeConfig(dim=D), n_subtrees=2, routing="content",
                   device="cpu").cfg.absorb_depth == 24
    assert VForest(TreeConfig(dim=D, absorb_depth=5), n_subtrees=2,
                   routing="content", device="cpu").cfg.absorb_depth == 5
    assert VForest(TreeConfig(dim=D), n_subtrees=2,
                   device="cpu").cfg.absorb_depth == 0
    with pytest.raises(ValueError, match="routing"):
        VForest(TreeConfig(dim=D), n_subtrees=2, routing="hash",
                device="cpu")


@pytest.mark.parametrize("routing", ["round_robin", "content"])
@pytest.mark.parametrize("n_lanes", [1, 3, K])
def test_select_lanes_matches_jax(routing, n_lanes):
    """Router centroids (content) or each lane's root mean (round-robin)
    pick the same lanes in both packages."""
    xs = clustered(160, seed=9)
    jf = JForest(JCfg(dim=D), n_subtrees=K, capacity_per_tree=128, seed=0,
                 routing=routing)
    tf = VForest(TreeConfig(dim=D), n_subtrees=K, capacity_per_tree=128,
                 routing=routing, device="cpu")
    jf.add(xs)
    tf.add(xs)
    q = clustered(24, seed=10)
    want = np.sort(jf.select_lanes(q, n_lanes), axis=1)
    got = np.sort(tf.select_lanes(q, n_lanes), axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("routing", ["round_robin", "content"])
def test_npz_round_trips_across_packages(routing, tmp_path):
    """A file of either package loads in the other with equal state and
    router; both then route and insert the next add alike."""
    xs = clustered(200, seed=12)
    jf = JForest(JCfg(dim=D), n_subtrees=K, capacity_per_tree=128, seed=0,
                 routing=routing)
    tf = VForest(TreeConfig(dim=D), n_subtrees=K, capacity_per_tree=128,
                 routing=routing, device="cpu")
    jf.add(xs[:150])
    tf.add(xs[:150])
    jf.save_npz(str(tmp_path / "jax.npz"), tag=np.arange(3))
    tf.save_npz(str(tmp_path / "port.npz"), tag=np.arange(3))

    t2, extras = VForest.load_npz(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(extras["tag"], np.arange(3))
    j2, jextras = JForest.load_npz(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(jextras["tag"], np.arange(3))
    assert_forests_equal(jf, t2)
    assert_forests_equal(j2, tf)
    # each loaded state is the writer's, bit for bit
    for want, got in ((jax.device_get(jf.state)._asdict(),
                       tree_mod.state_to_numpy(t2.state)),
                      (tree_mod.state_to_numpy(tf.state),
                       jax.device_get(j2.state)._asdict())):
        for f in tree_mod.FIELDS:
            np.testing.assert_array_equal(np.asarray(got[f]),
                                          np.asarray(want[f]), err_msg=f)
    assert interop.load_jax_npz(str(tmp_path / "jax.npz"),
                                device="cpu").routing == routing
    # the next add routes and inserts alike on each loaded pair
    for a, b in ((jf, t2), (j2, tf)):
        np.testing.assert_array_equal(b.add(xs[150:]), a.add(xs[150:]))
        assert_forests_equal(a, b)
