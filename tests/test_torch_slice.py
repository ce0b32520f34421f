"""The whole main-path slice on both packages: a whitener-mode CobwebIndex
with K=4 lanes and ``blocked_threshold=64``, built from the same raw rows
and the same fitted whitener.  With an f32 serving index the served ids
must be equal on every query; with the default bf16 index recall@10 must
be equal (bf16 may reorder near-ties inside the pool, never the exact
re-rank's final order of the rows it keeps)."""

import jax
import numpy as np
import pytest

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.bench.metrics import retrieval_metrics
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import state_to_numpy
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
import torch

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    data = synthetic_retrieval_hard(480, 60, 48, seed=2)
    jw = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9,
                                  ica_max_iter=200, seed=0)
    tw = interop.whitener_from_numpy(dict(
        mean=jw.mean, pca_components=jw.pca_components,
        pca_explained_var=jw.pca_explained_var,
        ica_unmixing=jw.ica_unmixing, eps=jw.eps))
    return data, jw, tw


def build(data, jw, tw, fused_dtype):
    jdb = JIndex(config=JCfg(dim=jw.dim_out), n_subtrees=4, whitener=jw,
                 capacity=4 * len(data.corpus_embs) + 16)
    tdb = CobwebIndex(config=TreeConfig(dim=tw.dim_out), n_subtrees=4,
                      whitener=tw, capacity=4 * len(data.corpus_embs) + 16,
                      device="cpu")
    for db in (jdb, tdb):
        db.blocked_threshold = 64
        db.fused_dtype = fused_dtype
        db.add_sentences([None] * len(data.corpus_embs), data.corpus_embs)
    return jdb, tdb


@pytest.fixture(scope="module")
def built32(setup):
    return build(*setup, "float32")


def test_forests_are_equal(setup, built32):
    """Same structure, slot for slot.  The tree inputs are whitened by
    each package's own float32 product, so statistics agree to rounding
    (rtol=1e-4, atol=1e-5), not bitwise."""
    data = setup[0]
    jdb, tdb = built32
    np.testing.assert_array_equal(tdb.forest._leaf_global(),
                                  jdb.forest._leaf_global())
    st = jax.device_get(jdb.forest.state)
    got = state_to_numpy(tdb.forest.state)
    for f in ("parent", "children", "n_children", "free_stack", "free_top",
              "n_alloc", "root", "counts"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(st, f)),
                                      err_msg=f)
    for f in ("means", "m2s"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(st, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("rerank", [None, 24, 0],
                         ids=["auto-pool", "pool24", "path-order"])
def test_query_ids_equal_with_f32_index(setup, built32, rerank):
    data = setup[0]
    jdb, tdb = built32
    want = np.asarray(jdb.query_ids(data.query_embs, 10, rerank=rerank))
    got = tdb.query_ids(data.query_embs, 10, rerank=rerank).numpy()
    if rerank == 0:     # raw path-score order: ties may permute
        for b in range(len(want)):
            assert set(got[b]) == set(want[b])
    else:
        np.testing.assert_array_equal(got, want)


def test_recall_equal_with_bf16_index(setup):
    data, jw, tw = setup
    jdb, tdb = build(data, jw, tw, "bfloat16")
    assert tdb._fused_index().GT.dtype.is_floating_point
    want = np.asarray(jdb.query_ids(data.query_embs, 10, rerank=24))
    got = tdb.query_ids(data.query_embs, 10, rerank=24).numpy()
    rw = retrieval_metrics(want, data.target_ids, 10)["recall@10"]
    rg = retrieval_metrics(got, data.target_ids, 10)["recall@10"]
    assert rg == rw


def test_add_drops_the_serving_index(setup):
    """An add on top of a serving index keeps it (an add dropped it once,
    hence the name): the 40 new rows wait in the pending tier, the merged
    serve finds each of them first, and its ids equal the JAX wrapper's
    (f32 fused index, as above)."""
    data, jw, tw = setup
    n = len(data.corpus_embs) - 40
    jdb = JIndex(config=JCfg(dim=jw.dim_out), n_subtrees=4, whitener=jw)
    tdb = CobwebIndex(config=TreeConfig(dim=tw.dim_out), n_subtrees=4,
                      whitener=tw, device="cpu")
    for db in (jdb, tdb):
        db.blocked_threshold = 64
        db.fused_dtype = "float32"
        db.add_sentences([None] * n, data.corpus_embs[:n])
        db.query_ids(data.query_embs[:5], 3)
    fused = tdb._fused
    assert fused is not None
    for db in (jdb, tdb):
        db.add_sentences([None] * 40, data.corpus_embs[n:])
    assert tdb._fused is fused
    assert tdb._unindexed_count() == jdb._unindexed_count() == 40
    ids = tdb.query_ids(data.corpus_embs[n:n + 8], 1).numpy()
    np.testing.assert_array_equal(ids[:, 0], np.arange(n, n + 8))
    want = np.asarray(jdb.query_ids(data.query_embs, 10))
    np.testing.assert_array_equal(
        tdb.query_ids(data.query_embs, 10).numpy(), want)
    assert tdb._fused is fused


def test_unported_engines_raise(setup):
    """The engines that raised here before are ported.  The small-forest
    engine (a forest below ``blocked_threshold``) serves the JAX
    wrapper's ids at 100 rows with its auto pool, and the backstop pool
    serves them too (an explicit ``backstop_pool`` with a pool of 8, f32
    fused index)."""
    data, jw, tw = setup
    jdb = JIndex(config=JCfg(dim=jw.dim_out), n_subtrees=4, whitener=jw)
    tdb = CobwebIndex(config=TreeConfig(dim=tw.dim_out), n_subtrees=4,
                      whitener=tw, device="cpu")
    for db in (jdb, tdb):
        db.add_sentences([None] * 100, data.corpus_embs[:100])
    np.testing.assert_array_equal(
        tdb.query_ids(data.query_embs, 3).numpy(),
        np.asarray(jdb.query_ids(data.query_embs, 3)))
    for db in (jdb, tdb):
        db.blocked_threshold = 64
        db.backstop_pool = 16
        db.fused_dtype = "float32"
    assert tdb._backstop_k(8, 100) == jdb._backstop_k(8, 100) == 16
    want = np.asarray(jdb.query_ids(data.query_embs, 3, rerank=8))
    np.testing.assert_array_equal(
        tdb.query_ids(data.query_embs, 3, rerank=8).numpy(), want)
    # the single tree (n_subtrees=1, the default) is ported: it builds
    one = CobwebIndex(config=TreeConfig(dim=4), n_subtrees=1, device="cpu")
    assert one.forest is None and one.tree is not None
