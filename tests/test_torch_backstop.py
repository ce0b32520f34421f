"""The proximity backstop pool of the port against the JAX package: the
six cases of ``tests/test_backstop.py`` replayed on the port, and the
same inputs through both packages.

Tolerances: ids equal wherever both pools are exact (the JAX package's
``approx_max_k`` is an exact top-k on the CPU); backstop scores within
rtol=1e-5 (float32 sums of exact bf16 products, taken in another order);
``union_candidates`` equal entry for entry (both sort stably by id).
Served ids equal with an f32 fused index, where the two packages pool
the same rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.core import index as jidx
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tidx
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.ops import fused_topk

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


def _torch_whitener(jw):
    return interop.whitener_from_numpy(dict(
        mean=jw.mean, pca_components=jw.pca_components,
        pca_explained_var=jw.pca_explained_var,
        ica_unmixing=jw.ica_unmixing, eps=jw.eps))


def _gt_store(W: np.ndarray):
    """A bf16 (Dw, Sw) store in kernel 1's GT layout, Sw padded to 2048
    columns of zeros."""
    Sw = -(-len(W) // fused_topk.SLAB) * fused_topk.SLAB
    GT = torch.zeros((W.shape[1], Sw), dtype=torch.bfloat16)
    GT[:, :len(W)] = torch.as_tensor(W).T.to(torch.bfloat16)
    return GT


def _live(cand, cs):
    return [sorted(int(c) for c, s in zip(cr, sr) if np.isfinite(float(s)))
            for cr, sr in zip(np.asarray(cand), np.asarray(cs))]


def test_union_candidates_dedups_and_keeps_both_pools():
    cand_a = [[1, 2, 3], [7, 8, 9]]
    cs_a = [[3.0, 2.0, 1.0], [3.0, 2.0, 1.0]]
    cand_b = [[2, 5, 3], [9, 9, 4]]
    cs_b = [[9.0, 8.0, 7.0], [9.0, -np.inf, 7.0]]
    cand, cs = tidx.union_candidates(
        torch.tensor(cand_a), torch.tensor(cs_a), torch.tensor(cand_b),
        torch.tensor(cs_b))
    live = _live(cand, cs)
    assert live == [[1, 2, 3, 5], [4, 7, 8, 9]]    # no duplicate live ids
    jc, js = jidx.union_candidates(jnp.asarray(cand_a), jnp.asarray(cs_a),
                                   jnp.asarray(cand_b), jnp.asarray(cs_b))
    assert live == _live(jc, js)


def test_union_candidates_invalid_never_collides():
    # an -inf entry whose id matches a live id must not kill the live one
    cand, cs = tidx.union_candidates(
        torch.tensor([[4, 6]]), torch.tensor([[-np.inf, 1.0]]),
        torch.tensor([[4, 5]]), torch.tensor([[2.0, 3.0]]))
    assert _live(cand, cs) == [[4, 5, 6]]


def test_union_candidates_equals_jax_entry_for_entry():
    rng = np.random.default_rng(4)
    ca, cb = rng.integers(0, 40, (2, 6, 24)).astype(np.int32)
    sa, sb = rng.normal(size=(2, 6, 24)).astype(np.float32)
    sa[rng.random(sa.shape) < 0.2] = -np.inf
    sb[rng.random(sb.shape) < 0.2] = -np.inf
    tc, ts = tidx.union_candidates(*map(torch.as_tensor, (ca, sa, cb, sb)))
    jc, js = jidx.union_candidates(*map(jnp.asarray, (ca, sa, cb, sb)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_backstop_topk_masks_and_ranks_by_l2():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(64, 8)).astype(np.float32)
    q = W[:4] + 0.01 * rng.normal(size=(4, 8)).astype(np.float32)
    half = 0.5 * (W * W).sum(1)
    GT = _gt_store(W)
    half_p = torch.zeros(GT.shape[1])
    half_p[:64] = torch.as_tensor(half)
    top, ids = tidx.backstop_topk(GT, half_p, torch.as_tensor(q), 5, 32,
                                  True)
    ids = ids.numpy()
    assert (ids < 32).all()          # masked rows never surface
    assert (ids[:, 0] == np.arange(4)).all()   # nearest row wins
    _, jids = jidx.backstop_topk(
        jnp.asarray(W, jnp.bfloat16), jnp.asarray(half), jnp.asarray(q), 5,
        jnp.asarray(32, jnp.int32), approx=False)
    np.testing.assert_array_equal(ids, np.asarray(jids))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backstop_topk_equals_jax_on_the_same_store(dtype):
    """The same store through both packages: a bf16 whitened store (the
    port's in GT layout through kernel 1's plain version, over two slabs
    with rows masked at ``n_valid``) or the f32 raw store (one product):
    ids equal in order, scores within rtol=1e-5; masked rows -inf in
    both when the pool runs past the valid rows."""
    rng = np.random.default_rng(1)
    W = rng.normal(size=(3000, 16)).astype(np.float32)
    if dtype == "bfloat16":
        W = np.array(jnp.asarray(W, jnp.bfloat16).astype(jnp.float32))
    q = rng.normal(size=(20, 16)).astype(np.float32)
    half = 0.5 * (W * W).sum(1)
    for n_valid, c in ((2900, 64), (40, 48)):
        if dtype == "bfloat16":
            store = _gt_store(W)
            half_p = torch.zeros(store.shape[1])
            half_p[:len(W)] = torch.as_tensor(half)
        else:
            store, half_p = torch.as_tensor(W), torch.as_tensor(half)
        ts, ti = tidx.backstop_topk(store, half_p, torch.as_tensor(q), c,
                                    n_valid, dtype == "bfloat16")
        js, ji = jidx.backstop_topk(
            jnp.asarray(W, getattr(jnp, dtype)), jnp.asarray(half),
            jnp.asarray(q), c, jnp.asarray(n_valid, jnp.int32),
            approx=False)
        js = np.asarray(js)
        fin = np.isfinite(js)
        assert fin.sum(1).tolist() == [min(c, n_valid)] * len(q)
        np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
        np.testing.assert_array_equal(ti.numpy()[fin], np.asarray(ji)[fin])
        np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def raw_db():
    """``tests/test_backstop.py``'s whitener-mode single tree (600 rows,
    32-d, PCA+ICA to 16), built by both packages from the same rows and
    the same fitted whitener."""
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=3.0, size=(12, 32))
    docs = np.concatenate(
        [c + 0.3 * rng.normal(size=(50, 32)) for c in centers]
    ).astype(np.float32)
    wh = PCAICAWhiteningModel.fit(docs, pca_dim=16, ica_max_iter=200,
                                  seed=0)
    jdb = JIndex(corpus=None, corpus_embeddings=docs,
                 config=JCfg(dim=wh.dim_out), whitener=wh)
    tdb = CobwebIndex(corpus=None, corpus_embeddings=docs,
                      config=TreeConfig(dim=wh.dim_out),
                      whitener=_torch_whitener(wh), device="cpu")
    return jdb, tdb, docs


def test_wrapper_backstop_recovers_pool_misses(raw_db):
    """With a tiny fused pool the path score alone misses self-retrieval
    for some rows; the backstop union must recover them, with the JAX
    wrapper's recall, off and on."""
    jdb, db, docs = raw_db
    q = docs[::10][:32]
    gold = np.arange(len(docs))[::10][:32]

    def recall(ids):
        return np.mean([g in row for g, row in zip(gold, ids)])

    got = {}
    for pkg in (jdb, db):
        pkg.blocked_threshold = 64   # force the engine (fused) path
        for bs in (0, 64):
            pkg.backstop_pool = bs
            got[pkg is db, bs] = np.asarray(pkg.query_ids(q, 10, rerank=16))
        pkg.backstop_pool = "auto"   # restore
    ids_off, ids_on = got[True, 0], got[True, 64]
    assert recall(ids_on) >= recall(ids_off)
    assert recall(ids_on) == 1.0, recall(ids_on)
    for row in ids_on:              # union pool never emits duplicates
        live = [i for i in row if i >= 0]
        assert len(live) == len(set(live))
    for bs in (0, 64):
        assert recall(got[True, bs]) == recall(got[False, bs])


def test_wrapper_backstop_auto_gates_on_scale(raw_db):
    _, db, docs = raw_db
    assert db.backstop_pool == "auto"
    # below backstop_threshold auto resolves to 0
    assert db._backstop_k(64, len(docs)) == 0
    db.backstop_threshold = 100
    try:
        assert db._backstop_k(64, len(docs)) == 64
    finally:
        db.backstop_threshold = type(db).backstop_threshold


def test_whitened_store_is_kernel_1s_layout(raw_db):
    """The whitened store: (Dw, Sw) bf16, Sw a multiple of 2048, the
    rows as the JAX package's bf16 copy (within one bf16 rounding: each
    package whitens by its own product), half-norms from the bf16 values
    and 0 on the padding."""
    jdb, db, docs = raw_db
    GT, half = db._wemb_device()
    n = len(docs)
    assert GT.dtype == torch.bfloat16 and GT.shape[1] % 2048 == 0
    jw, jhalf = jdb._wemb_device()
    np.testing.assert_allclose(GT[:, :n].T.float().numpy(),
                               np.asarray(jw[:n], np.float32),
                               rtol=2.0 ** -7, atol=1e-6)
    w = GT[:, :n].float()
    np.testing.assert_allclose(half[:n].numpy(),
                               0.5 * (w * w).sum(0).numpy(), rtol=1e-6)
    assert not GT[:, n:].any() and not half[n:].any()
    np.testing.assert_allclose(half[:n].numpy(), np.asarray(jhalf[:n]),
                               rtol=2e-2)


def test_backstop_without_whitener_uses_store():
    """Non-whitener mode: the backstop keys directly on the f32 re-rank
    store (tree space == store space), no second copy; served ids equal
    the JAX wrapper's."""
    rng = np.random.default_rng(7)
    docs = rng.normal(size=(300, 16)).astype(np.float32)
    jdb = JIndex(corpus=None, corpus_embeddings=docs,
                 config=JCfg(dim=16))
    db = CobwebIndex(corpus=None, corpus_embeddings=docs,
                     config=TreeConfig(dim=16), device="cpu")
    for pkg in (jdb, db):
        pkg.blocked_threshold = 64
        pkg.backstop_pool = 32
    wemb, half = db._wemb_device()
    assert wemb is db._emb_device()          # shared buffer, no copy
    ids = db.query_ids(docs[:16], 5, rerank=8).numpy()
    for b in range(16):
        assert b in ids[b]
        live = [i for i in ids[b] if i >= 0]
        assert len(live) == len(set(live))
    np.testing.assert_array_equal(
        ids, np.asarray(jdb.query_ids(docs[:16], 5, rerank=8)))


@pytest.fixture(scope="module")
def forests():
    """``tests/test_torch_slice.py``'s 4-lane whitener forest (480 hard
    rows), built by both packages, with an f32 fused index."""
    data = synthetic_retrieval_hard(480, 60, 48, seed=2)
    jw = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9,
                                  ica_max_iter=200, seed=0)
    jdb = JIndex(config=JCfg(dim=jw.dim_out), n_subtrees=4, whitener=jw)
    tdb = CobwebIndex(config=TreeConfig(dim=jw.dim_out), n_subtrees=4,
                      whitener=_torch_whitener(jw), device="cpu")
    for db in (jdb, tdb):
        db.blocked_threshold = 64
        db.fused_dtype = "float32"
        db.backstop_threshold = 256      # "auto" turns the backstop on
        db.add_sentences([None] * len(data.corpus_embs), data.corpus_embs)
    return data, jdb, tdb


@pytest.mark.parametrize("rerank", [None, 24, 6],
                         ids=["auto-pool", "pool24", "pool6"])
def test_whitener_forest_serves_jax_ids_with_the_backstop(forests, rerank,
                                                          monkeypatch):
    """``backstop_pool="auto"`` above the lowered threshold: the port's
    served ids equal the JAX wrapper's, and the backstop ran (once, at
    the pool's size, over the indexed rows)."""
    data, jdb, tdb = forests
    calls = []
    orig = tidx.backstop_topk

    def spy(wemb, half, queries, c, n_valid, *layout):
        calls.append((c, n_valid, wemb.dtype))
        return orig(wemb, half, queries, c, n_valid, *layout)

    monkeypatch.setattr(tidx, "backstop_topk", spy)
    want = np.asarray(jdb.query_ids(data.query_embs, 10, rerank=rerank))
    got = tdb.query_ids(data.query_embs, 10, rerank=rerank).numpy()
    np.testing.assert_array_equal(got, want)
    pool = {None: 480, 24: 24, 6: 10}[rerank]
    assert calls == [(pool, 480, torch.bfloat16)]


def test_backstop_chunks_keep_the_served_ids(forests, monkeypatch):
    """A budget that holds only 32 queries' working set (the plain
    versions' (Bc, Sp) and (Bc, Sw) scores on the host) cuts the batch into
    chunks of 32, each with its own sweep and backstop pool: the ids are
    those of the whole batch at once."""
    data, _, tdb = forests
    want = tdb.query_ids(data.query_embs, 10, rerank=24).numpy()
    calls = []
    orig = tidx.backstop_topk

    def spy(wemb, half, queries, c, n_valid, *layout):
        calls.append(len(queries))
        return orig(wemb, half, queries, c, n_valid, *layout)

    monkeypatch.setattr(tidx, "backstop_topk", spy)
    fidx, (GT, _) = tdb._fused_index(), tdb._wemb_device()
    monkeypatch.setattr(tdb, "fused_score_budget",
                        32 * (fidx.num_slots + GT.shape[1]) * 12)
    got = tdb.query_ids(data.query_embs, 10, rerank=24).numpy()
    assert calls == [32, 28]
    np.testing.assert_array_equal(got, want)


def test_plain_check_holds_the_served_ids_before_and_after_adds():
    """``bench/probes.plain_check``, the plain pipeline the card's scale
    slice holds its served ids against, on a 4-lane whitener forest with
    a bf16 fused index and the backstop on (pool 24): no query differs
    from the served ids with every row indexed, nor after adds served from
    the pending and delta tiers; a served row's first and last ids
    swapped fail it, and so does its last id swapped for the query's
    worst row."""
    from rag_cobweb_tpu_torch.bench.probes import plain_check

    data = synthetic_retrieval_hard(540, 60, 48, seed=4)
    corpus = data.corpus_embs
    jw = PCAICAWhiteningModel.fit(corpus[:480], pca_dim=0.9,
                                  ica_max_iter=200, seed=0)
    db = CobwebIndex(config=TreeConfig(dim=jw.dim_out), n_subtrees=4,
                     whitener=_torch_whitener(jw), device="cpu")
    db.blocked_threshold = 64
    db.backstop_threshold = 256
    db.rerank_candidates = 24
    db.stale_pending_limit = 24
    db.add_sentences([None] * 480, corpus[:480])
    q = data.query_embs
    served = db.query_ids(q, 10).numpy()
    rec = plain_check(db, q, served, 10, 24, 24, 32, corpus,
                      data.target_ids)
    assert rec["queries_differing_from_plain"] == 0
    n = 480
    for size in (20, 30, 10):
        db.add_sentences([None] * size, corpus[n:n + size])
        n += size
    assert (db._unindexed_count(), db._delta_n) == (60, 50)
    served = db.query_ids(q, 10).numpy()
    assert db._backstop_k(24, db._indexed_count()) == 24
    assert np.isin(served, np.arange(480, 540)).any()
    rec = plain_check(db, q, served, 10, 24, 24, 32, corpus)
    assert rec["queries_differing_from_plain"] == 0
    swapped = served.copy()
    swapped[1, [0, 9]] = served[1, [9, 0]]
    with pytest.raises(AssertionError, match="query 1: served ids out of"):
        plain_check(db, q, swapped, 10, 24, 24, 32, corpus)
    d2 = np.sum(np.square(corpus - q[0]), axis=1)
    served[0, 9] = int(np.argmax(d2))
    with pytest.raises(AssertionError, match="query 0: served id"):
        plain_check(db, q, served, 10, 24, 24, 32, corpus)
