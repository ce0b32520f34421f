"""The port's pending/delta tier against the JAX package: the stale cases
of ``tests/test_fused_state.py`` replayed on the port, the tier functions
on the same inputs through both packages, and sequences of adds that
cross ``stale_pending_limit`` and the rebuild point on both.

Tolerances: ``pending_leaf_lp`` and ``delta_exact_topk`` within rtol=1e-5
(float32 sums in another order; atol 1e-4 for keys near zero), ids equal
(no ties in the data); served ids equal at every step with an f32 fused
index, where both packages pool the same rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tidx
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

PV = 0.125


def _clustered(n, d, seed=0, n_clusters=6, scale=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(n_clusters, d))
    x = centers[rng.integers(0, n_clusters, n)] + scale * rng.normal(
        size=(n, d))
    return x.astype(np.float32)


def _forest(xs):
    db = CobwebIndex([f"s{i}" for i in range(len(xs))], xs, n_subtrees=4,
                     device="cpu")
    db.blocked_threshold = 64  # force the engine path at test scale
    db.rerank_threshold = 64   # auto exact re-rank on at test scale
    return db


def test_pending_leaf_lp_matches_jax():
    """Tier 0 through kernel 5's plain version, the rows taken from a
    store by id, against the JAX broadcast form on those rows."""
    rng = np.random.default_rng(0)
    store = rng.normal(size=(90, 24)).astype(np.float32)
    rows = rng.permutation(90)[:50]
    q = rng.normal(size=(7, 24)).astype(np.float32)
    got = tidx.pending_leaf_lp(torch.as_tensor(q), torch.as_tensor(store),
                               torch.as_tensor(rows), PV).numpy()
    want = np.asarray(jidx.pending_leaf_lp(
        jnp.asarray(q), jnp.asarray(store[rows]), jnp.ones(50, bool),
        jnp.float32(PV)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_delta_exact_topk_matches_jax():
    """Tier 1 (GEMM form, full f32) over a segment whose tail past
    ``n_valid`` is padding."""
    rng = np.random.default_rng(1)
    vecs = np.zeros((64, 24), np.float32)
    vecs[:40] = rng.normal(size=(40, 24))
    q = vecs[[3, 17, 39]] + 0.05 * rng.normal(size=(3, 24)).astype(
        np.float32)
    ts, ti = tidx.delta_exact_topk(torch.as_tensor(q), torch.as_tensor(vecs),
                                   40, PV, 5)
    js, ji = jidx.delta_exact_topk(jnp.asarray(q), jnp.asarray(vecs),
                                   jnp.int32(40), jnp.float32(PV), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    assert (ti.numpy()[:, 0] == [3, 17, 39]).all()


def test_append_rows_writes_in_place():
    buf = torch.zeros((8, 3))
    rows = torch.arange(6.0).view(2, 3)
    out = tidx._append_rows(buf, rows, 5)
    assert out is buf
    np.testing.assert_array_equal(buf[5:7].numpy(), rows.numpy())
    assert not buf[:5].any() and not buf[7:].any()


def test_fused_only_stale_serving():
    """Adds on top of a fused-only serving index must accrue as pending
    (bounded staleness), not invalidate, and the merged serve stays exact
    for the fresh rows."""
    xs = _clustered(512, 16, seed=4)
    db = _forest(xs)
    db.query_ids(xs[:4], k=3)       # builds the stats-free fused index
    assert db._fused is not None and db._flat_cache is None
    fused_before = db._fused
    extra = _clustered(32, 16, seed=5) + 7.0   # well-separated fresh rows
    db.add_sentences([f"x{i}" for i in range(32)], extra)
    assert db._unindexed_count() == 32, "fused-only staleness not retained"
    assert db._fused is fused_before, "add invalidated the serving index"
    ids = db.query_ids(extra, k=1).numpy()
    np.testing.assert_array_equal(ids[:, 0], 512 + np.arange(32))
    # the flat index still was never built
    assert db._flat_cache is None


def test_flat_rebuild_clears_pending_bookkeeping():
    """If an exact-index consumer forces a flat rebuild while fused-only
    pending rows exist, the rebuild covers those rows: their pending
    bookkeeping must clear or the merge would count them twice."""
    xs = _clustered(512, 16, seed=6)
    db = _forest(xs)
    db.query_ids(xs[:4], k=3)
    db.add_sentences(["y0"], _clustered(1, 16, seed=7) + 9.0)
    assert db._unindexed_count() == 1
    idx = db._flat_pred_index()     # forces a fresh snapshot
    assert db._unindexed_count() == 0
    assert idx.num_sentences == 513


def _twins(mode):
    """Both packages' indexes over the same first 360 rows, f32 fused
    index: a forest of 4 lanes, or with a ``tree-`` mode a single tree
    (``tree-loaded``: loaded in both from one JSON dump, so no vector
    store); raw rows (16-d) or whitener mode (32-d raw rows, PCA+ICA to
    12)."""
    whiten = "whitener" in mode
    lanes = 1 if mode.startswith("tree-") else 4
    xs = _clustered(520, 32 if whiten else 16, seed=8, n_clusters=10,
                    scale=0.6)
    jcfg, tcfg, jw = JCfg(dim=16), TreeConfig(dim=16), None
    tw = None
    if whiten:
        jw = PCAICAWhiteningModel.fit(xs, pca_dim=12, ica_max_iter=200,
                                      seed=0)
        tw = interop.whitener_from_numpy(dict(
            mean=jw.mean, pca_components=jw.pca_components,
            pca_explained_var=jw.pca_explained_var,
            ica_unmixing=jw.ica_unmixing, eps=jw.eps))
        jcfg, tcfg = JCfg(dim=jw.dim_out), TreeConfig(dim=jw.dim_out)
    if mode == "tree-loaded":
        src = JIndex([f"s{i}" for i in range(360)], xs[:360])
        blob = src.dump_json()
        jdb = JIndex.load_json(blob)
        tdb = CobwebIndex.load_json(blob, device="cpu")
    else:
        jdb = JIndex(config=jcfg, n_subtrees=lanes, whitener=jw)
        tdb = CobwebIndex(config=tcfg, n_subtrees=lanes, whitener=tw,
                          device="cpu")
    for db in (jdb, tdb):
        db.blocked_threshold = 64
        db.rerank_threshold = 64
        db.fused_dtype = "float32"
        if mode != "tree-loaded":
            db.store_embeddings = not mode.endswith("nostore")
            db.add_sentences([None] * 360, xs[:360])
    return jdb, tdb, xs


# (stale_pending_limit, delta_rebuild_min, add sizes, unindexed rows after
# each add, delta rows after each add): the raw case crosses the pending
# limit twice (tier 0 moves into the delta segment at 30 and at 75 rows)
# and then the rebuild point (105 > 100), also with a backstop pool of 16
# (which must mask the unindexed rows the tiers merge) and without a
# vector store (tier 0 keeps its rows apart; the stale engine re-ranks by
# leaf log-probability, the same key); the whitener case
# crosses the rebuild point only (the JAX package cannot move
# whitener-mode rows into its delta segment: it sizes the segment by the
# tree's width, not the raw rows'), and without a store it rebuilds on
# every add.  The ``tree-`` cases replay them on a single tree, also on one
# loaded from JSON with no store (its first add's rows miss every loaded
# row), and on one whose store is turned off after the first add (tier 0
# then keeps apart the rows the store held).
RAW = (24, 100, [10, 20, 5, 40, 30, 20], [10, 30, 35, 75, 0, 20],
       [0, 30, 30, 75, 0, 0])
WHITENER = (4096, 60, [10, 20, 25, 10, 15], [10, 30, 55, 0, 15],
            [0, 0, 0, 0, 0])
SEQUENCES = {
    "raw": RAW,
    "raw-backstop": RAW,
    "raw-nostore": RAW,
    "whitener": WHITENER,
    "tree-raw": RAW,
    "tree-raw-nostore": RAW,
    "tree-raw-dropped": RAW,
    "tree-loaded": RAW,
    "tree-whitener": WHITENER,
    "tree-whitener-nostore": (4096, 60, [10, 20], [0, 0], [0, 0]),
}


@pytest.mark.parametrize("mode", sorted(SEQUENCES))
def test_adds_cross_the_pending_limit_and_rebuild_point_like_jax(mode):
    """Adds between queries on both packages: after every add the
    unindexed and delta counts agree with the expected tiers, the port
    kept its serving index until the rebuild point, and the served ids
    (pool 16, and the auto pool) equal the JAX wrapper's and name no row
    twice; each add's rows come back first when queried as themselves.
    A ``rerank=0`` query at the end flushes both (path-score order: equal
    id sets)."""
    limit, rebuild_min, sizes, unindexed, delta = SEQUENCES[mode]
    jdb, tdb, xs = _twins(mode)
    q = xs[::37]
    for db in (jdb, tdb):
        db.stale_pending_limit = limit
        db.delta_rebuild_min = rebuild_min
        if mode == "raw-backstop":
            db.backstop_pool = 16
        db.query_ids(q, 5, rerank=16)
    n = 360
    for step, (size, want_un, want_delta) in enumerate(
            zip(sizes, unindexed, delta)):
        fused = tdb._fused
        for db in (jdb, tdb):
            if mode == "tree-raw-dropped" and step == 1:
                db.store_embeddings = False
            db.add_sentences([None] * size, xs[n:n + size])
        assert jdb._unindexed_count() == tdb._unindexed_count() == want_un
        assert jdb._delta_n == tdb._delta_n == want_delta
        assert (tdb._fused is fused) == bool(want_un)
        for rerank in (16, None):
            want = np.asarray(jdb.query_ids(q, 5, rerank=rerank))
            got = tdb.query_ids(q, 5, rerank=rerank).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{n}+{size}")
            assert all(len(set(row)) == len(row) for row in got)
        ids = tdb.query_ids(xs[n:n + size], 1, rerank=16).numpy()
        np.testing.assert_array_equal(ids[:, 0], np.arange(n, n + size))
        n += size
    want = np.asarray(jdb.query_ids(q, 5, rerank=0))
    got = tdb.query_ids(q, 5, rerank=0).numpy()
    assert jdb._unindexed_count() == tdb._unindexed_count() == 0
    for b in range(len(q)):
        assert set(got[b]) == set(want[b])
