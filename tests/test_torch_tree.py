"""Single-tree parity of the PyTorch port: the same tree (structure and
sufficient statistics, rounded to 4 decimals) as the numpy oracle of the
reference algorithm and as the JAX tree, on tie-free data (the cases of
tests/test_tree.py)."""

import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.tree import CobwebTree as JTree
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree

from reference_oracle import OracleTree

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


def jax_signature(tree: JTree):
    st = tree._host_arrays()
    return tree_mod.structure_signature(st.counts, st.means, st.children,
                                        st.n_children, int(st.root))


def build(xs, **kw):
    tree = CobwebTree(TreeConfig(dim=xs.shape[1], **kw),
                      capacity=4 * len(xs) + 16, device="cpu")
    tree.fit(xs)
    return tree


def oracle(xs, **kw):
    o = OracleTree(xs.shape[1], **kw)
    for x in xs:
        o.ifit(x)
    return o


@pytest.mark.parametrize("n,dim,seed", [(8, 4, 0), (30, 6, 1), (60, 5, 2)])
def test_tree_matches_oracle_random_data(n, dim, seed):
    xs = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    assert build(xs).signature() == oracle(xs).signature()


def test_tree_matches_oracle_clustered_data():
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=3.0, size=(5, 6))
    xs = np.concatenate(
        [c + 0.2 * rng.normal(size=(12, 6)) for c in centers]
    ).astype(np.float32)[rng.permutation(60)]
    assert build(xs).signature() == oracle(xs).signature()


@pytest.mark.parametrize("kw", [dict(use_info=True, use_kl=False),
                                dict(use_info=False),
                                dict(acuity_cutoff=True)],
                         ids=["info", "cu", "acuity"])
def test_tree_matches_oracle_score_variants(kw):
    xs = np.random.default_rng(4).normal(size=(25, 4)).astype(np.float32)
    tree = CobwebTree(TreeConfig(dim=4, **kw), capacity=256, device="cpu")
    tree.fit(xs)
    assert tree.signature() == oracle(xs, **kw).signature()


@pytest.mark.parametrize("n,dim,seed", [(40, 6, 5), (90, 8, 6)])
def test_tree_matches_jax_tree(n, dim, seed):
    """Same rows -> same tree, same slot ids and same leaves as the JAX
    CobwebTree (whose ids the forest's global leaf ids build on)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(4, dim))
    xs = (centers[rng.integers(0, 4, n)]
          + 0.4 * rng.normal(size=(n, dim))).astype(np.float32)
    jt = JTree(JCfg(dim=dim), capacity=16, seed=0)
    j_leaves = jt.fit(xs, batch_size=32)
    tt = CobwebTree(TreeConfig(dim=dim), capacity=16, device="cpu")
    t_leaves = tt.fit(xs, batch_size=32)
    np.testing.assert_array_equal(j_leaves, t_leaves)
    assert tt.signature() == jax_signature(jt)
    assert tt.analyze_structure() == jt.analyze_structure()
    st = jt._host_arrays()
    got = tt.host_arrays()
    for f in ("parent", "children", "n_children", "free_stack", "free_top",
              "n_alloc", "root"):
        np.testing.assert_array_equal(np.asarray(getattr(st, f)), got[f],
                                      err_msg=f)


def test_exact_duplicates_share_a_leaf():
    rng = np.random.default_rng(5)
    base = rng.normal(size=(6, 4)).astype(np.float32)
    tree = CobwebTree(TreeConfig(dim=4), capacity=64, device="cpu")
    first = tree.fit(base)
    again = tree.fit(base)
    np.testing.assert_array_equal(first, again)
    a = tree.host_arrays()
    assert all(a["counts"][leaf] == 2.0 for leaf in first)


def test_truncated_descent_applies_nothing():
    """A descent cut off by its step budget leaves the state untouched."""
    xs = np.random.default_rng(7).normal(size=(20, 5)).astype(np.float32)
    tree = CobwebTree(TreeConfig(dim=5), capacity=128, device="cpu")
    tree.fit(xs)
    before = tree_mod.state_to_numpy(tree.state)
    x = torch.as_tensor(xs[:1] + 0.1)
    on = torch.ones((1,), dtype=torch.bool)
    leaf = tree_mod.descend(tree.state, x, on, tree.cfg, 1, tree._gen)
    assert int(leaf[0]) == -1
    after = tree_mod.state_to_numpy(tree.state)
    for f in tree_mod.FIELDS:
        np.testing.assert_array_equal(before[f], after[f], err_msg=f)


def test_padding_lane_is_a_no_op():
    xs = np.random.default_rng(8).normal(size=(10, 3)).astype(np.float32)
    tree = CobwebTree(TreeConfig(dim=3), capacity=64, device="cpu")
    tree.fit(xs)
    before = tree_mod.state_to_numpy(tree.state)
    off = torch.zeros((1,), dtype=torch.bool)
    leaf = tree_mod.descend(tree.state, torch.as_tensor(xs[:1]), off,
                            tree.cfg, 48, tree._gen)
    assert int(leaf[0]) == -1
    after = tree_mod.state_to_numpy(tree.state)
    for f in tree_mod.FIELDS:
        np.testing.assert_array_equal(before[f], after[f], err_msg=f)


def test_capacity_growth_keeps_the_tree():
    xs = np.random.default_rng(9).normal(size=(50, 4)).astype(np.float32)
    small = CobwebTree(TreeConfig(dim=4), capacity=8, device="cpu")
    small.fit(xs, batch_size=7)
    big = CobwebTree(TreeConfig(dim=4), capacity=1024, device="cpu")
    big.fit(xs, batch_size=7)
    assert small.state.capacity < big.state.capacity
    assert small.signature() == big.signature()
    assert small.analyze_structure()["leaf_count"] == 50


@pytest.mark.parametrize("n", [7, 2047, 2048, 5000])
def test_align_capacity_matches_jax(n):
    from rag_cobweb_tpu.core.tree import align_capacity
    assert tree_mod.align_capacity(n) == align_capacity(n)
