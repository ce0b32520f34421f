"""The small-forest engine of the PyTorch port against the JAX package: the
stacked per-lane index, its flat merge, the per-lane query merged by leaf
log-prob, the per-global-sentence rank scores, and ``CobwebIndex.query_ids``
below ``blocked_threshold`` on both routings, before and after an add.

Tolerances: integer and bool arrays exactly (the same host numpy work);
float32 statistics within rtol=1e-5 (summation order only); scores within
1e-5 relative.  Leaf log-probs tie wherever rows share a leaf, so ids are
held by tie group (``assert_equal_by_tie_group``): at every place the two
packages' ids carry the same key, and ids are equal wherever that key is
tied with no other key of the row nor with the row's last."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.parallel import forest as jforest
from rag_cobweb_tpu.parallel import vforest as jvf
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.parallel import forest as tforest
from rag_cobweb_tpu_torch.parallel import vforest as tvf

from torch_parity import assert_equal_by_tie_group

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

ROUTINGS = ("round_robin", "content")


def clustered(n, D, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.0, size=(10, D))
    return (centers[rng.integers(0, 10, n)]
            + 0.5 * rng.normal(size=(n, D))).astype(np.float32)


def to_port_stacked(jidx) -> tforest.StackedIndex:
    """The JAX StackedIndex's arrays as a port StackedIndex on the CPU."""
    def t(name):
        a = np.array(getattr(jidx, name))
        return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu"
                               else a)
    return tforest.StackedIndex(**{f: t(f)
                                   for f in tforest.StackedIndex._fields})


def assert_index_equal(want, got, fields):
    for f in fields:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).cpu().numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module", params=ROUTINGS)
def twins(request):
    """The same rows into a JAX and a port VForest (K=3, D=8, 220 rows in
    three adds), one per routing."""
    xs = clustered(220, 8, seed=5)
    jf = jvf.VForest(JCfg(dim=8), n_subtrees=3, capacity_per_tree=64,
                     seed=0, routing=request.param)
    tf = tvf.VForest(TreeConfig(dim=8), n_subtrees=3, capacity_per_tree=64,
                     routing=request.param, device="cpu")
    for part in np.array_split(xs, 3):
        jf.add(part)
        tf.add(part)
    assert tf.shard_of == jf.shard_of
    return jf, tf, xs


def test_build_stacked_index_matches_jax(twins):
    jf, tf, _ = twins
    want, got = jf.build_index(), tf.build_index()
    assert tf.build_index() is got            # cached until an add
    assert_index_equal(want, got, jforest.StackedIndex._fields)
    # a lane's view is that lane's index, padded
    assert_index_equal(want.lane(1), got.lane(1),
                       ("inv_var_T", "paths", "sentence_order", "children"))
    assert tf.max_depth() == jf.max_depth()


def test_merge_stacked_to_flat_matches_jax(twins):
    jf, tf, _ = twins
    want = jforest.merge_stacked_to_flat(jf.build_index())
    got = tforest.merge_stacked_to_flat(tf.build_index())
    assert_index_equal(want, got, (
        "inv_var_T", "mu_over_var_T", "const", "paths", "path_weights",
        "children", "leaf_sentence_start", "leaf_sentence_count",
        "sentence_order"))
    np.testing.assert_array_equal(got.paths_h, np.asarray(want.paths))


@pytest.mark.parametrize("k", [1, 10, 64, 500])
def test_vforest_query_matches_jax(twins, k):
    """The same stacked arrays into both queries: leaf log-probs within
    1e-5 relative, ids equal by tie group (k=500 exceeds every lane, so
    padding rows, -inf and id -1, join the merged pool)."""
    jf, _, xs = twins
    jidx = jf.build_index()
    q = xs[::7] + 0.05
    ws, wi = jvf._vforest_query(jidx, jnp.asarray(q), k)
    gs, gi = tvf._vforest_query(to_port_stacked(jidx), torch.as_tensor(q), k)
    assert gs.shape == ws.shape
    ws, wi = np.asarray(ws), np.asarray(wi)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs.numpy()), fin)
    np.testing.assert_array_equal(gi.numpy()[~fin], -1)
    assert_equal_by_tie_group(wi, gi.numpy(), np.where(fin, ws, -1e30),
                              np.where(fin, gs.numpy(), -1e30))


def test_vforest_query_chunks_by_budget(twins, monkeypatch):
    """A budget that forces one query a chunk serves the same ids."""
    _, tf, xs = twins
    q = torch.as_tensor(xs[:40])
    want = tf.query_topk(q, 10)
    monkeypatch.setattr(tvf, "QUERY_BUDGET", 1)
    assert tvf._query_chunk(tf.build_index(), 40) == 32
    got = tvf._vforest_query(tf.build_index(), q, 10)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_vforest_rank_scores_matches_jax(twins):
    """Within 1e-5 relative on the same stacked arrays, -inf nowhere, and
    a finite gradient in the queries."""
    jf, tf, xs = twins
    jidx = jf.build_index()
    q = xs[:6] + 0.1
    want = np.asarray(jvf.vforest_rank_scores(jidx, jnp.asarray(q),
                                              jf.n_sentences))
    qt = torch.as_tensor(q).requires_grad_(True)
    got = tvf.vforest_rank_scores(to_port_stacked(jidx), qt, tf.n_sentences)
    assert got.shape == (6, tf.n_sentences)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    got.sum().backward()
    assert qt.grad is not None and torch.isfinite(qt.grad).all()
    # the forest's method is the function on its own stacked index (whose
    # statistics agree with the JAX forest's to rtol=1e-5)
    torch.testing.assert_close(
        tf.rank_scores(q),
        tvf.vforest_rank_scores(tf.build_index(), torch.as_tensor(q),
                                tf.n_sentences), rtol=0, atol=0)


@pytest.fixture(scope="module")
def hard():
    data = synthetic_retrieval_hard(300, 40, 16, seed=2)
    jw = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9,
                                  ica_max_iter=200, seed=0)
    tw = interop.whitener_from_numpy(dict(
        mean=jw.mean, pca_components=jw.pca_components,
        pca_explained_var=jw.pca_explained_var,
        ica_unmixing=jw.ica_unmixing, eps=jw.eps))
    return data, jw, tw


def exact_keys(corpus, queries, ids):
    """The re-rank's order: squared L2 to the raw query, in float64
    (negated, so larger is nearer)."""
    x = np.asarray(corpus, np.float64)[ids]
    return -np.sum(np.square(x - np.asarray(queries, np.float64)[:, None]),
                   axis=-1)


def leaf_keys(tdb, queries, ids):
    """Each served id's leaf log-prob in the port's stacked index."""
    idx = tdb.forest.build_index()
    q = tdb.whitener.transform_torch(torch.as_tensor(queries))
    nlp, _ = tvf._lane_node_scores(idx, q)
    lane = np.asarray(tdb.forest.shard_of)[ids]
    row = np.asarray(tdb.forest.local_sid)[ids]
    leaf = idx.leaf_node.numpy()[lane, row]
    b = np.arange(len(ids))[:, None]
    return nlp.numpy()[lane, b, leaf]


@pytest.mark.parametrize("routing", ROUTINGS)
def test_query_ids_below_threshold_matches_jax(hard, routing):
    """A whitener-mode forest of 260 rows (K=4), then 40 more: ``query_ids``
    at rerank None (the auto pool), 8 and 0 (the raw leaf-lp order),
    before and after the add, equal to the JAX wrapper's by tie group;
    ``build_prediction_index`` is the forest's stacked index and
    ``rank_scores`` its per-global scores (within 1e-4: each package
    whitens the tree rows with its own float32 product, so the node
    statistics agree to rounding, as in tests/test_torch_slice.py)."""
    data, jw, tw = hard
    jdb = JIndex(config=JCfg(dim=jw.dim_out), n_subtrees=4, whitener=jw,
                 routing=routing)
    tdb = CobwebIndex(config=TreeConfig(dim=tw.dim_out), n_subtrees=4,
                      whitener=tw, routing=routing, device="cpu")
    assert tdb.cfg.absorb_depth == jdb.cfg.absorb_depth
    qs = data.query_embs
    for lo, hi in ((0, 260), (260, 300)):
        for db in (jdb, tdb):
            db.add_sentences([None] * (hi - lo), data.corpus_embs[lo:hi])
        assert tdb.forest.shard_of == jdb.forest.shard_of
        assert tdb._unindexed_count() == 0
        for rerank in (None, 8, 0):
            want = np.asarray(jdb.query_ids(qs, 10, rerank=rerank))
            got = tdb.query_ids(qs, 10, rerank=rerank).numpy()
            if rerank == 0:
                keys = (leaf_keys(tdb, qs, want), leaf_keys(tdb, qs, got))
            else:
                keys = (exact_keys(data.corpus_embs, qs, want),
                        exact_keys(data.corpus_embs, qs, got))
            assert_equal_by_tie_group(want, got, *keys)
        assert isinstance(tdb.build_prediction_index(), tforest.StackedIndex)
        np.testing.assert_allclose(
            tdb.rank_scores(qs[:4], is_embedding=True).numpy(),
            np.asarray(jdb.rank_scores(qs[:4], is_embedding=True)),
            rtol=1e-4, atol=1e-4)


def test_small_forest_serves_each_row_first_as_itself():
    """Tight near-duplicate groups (absorbed into shared leaves under
    content routing): the auto pool covers each group, so every row comes
    back first as itself, on both routings; ``rerank=0`` keeps the raw
    leaf-lp order (ties allowed)."""
    rng = np.random.default_rng(7)
    groups = rng.normal(scale=4.0, size=(4, 12))
    xs = np.concatenate([g + 0.02 * rng.normal(size=(40, 12))
                         for g in groups]).astype(np.float32)
    for routing in ROUTINGS:
        db = CobwebIndex(corpus_embeddings=xs, config=TreeConfig(dim=12),
                         n_subtrees=4, routing=routing, device="cpu")
        ids = db.query_ids(xs, 1).numpy()
        np.testing.assert_array_equal(ids[:, 0], np.arange(len(xs)))
        assert db.query_ids(xs[:8], 1, rerank=0).shape == (8, 1)


def test_chip_smoke_small_forest_phase_on_the_host(tmp_path):
    """``chip_smoke.py``'s phase 3e rehearsed on the host at a small size
    (c=400, 60 queries, 32-d, the branch's edge at 500 rows): both
    routings serve as ``small_forest``, equal to the plain pipeline, the
    added rows come back first, the edge forest serves below the
    threshold; phase 3f's query API on the content-routed forest (its
    files in ``tmp_path``): a host copy's ``predict`` equal to the
    original's, recall and times recorded."""
    import importlib.util
    from pathlib import Path
    from rag_cobweb_tpu_torch.bench import headline, probes
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.small_forest_slice(
        headline, probes.zero_counters, probes.read_counters, tmp_path,
        device="cpu", corpus_size=400, queries=60, dim=32, threshold=500,
        card=False)
    for routing, sf in out.items():
        assert sf["rec"]["engine"] == "small_forest"
        assert sf["rec"]["routing"] == routing
        assert sf["plain"]["queries_differing_from_plain"] == 0
        assert sf["rec"]["recall@10"] == sf["plain"]["plain_recall@10"]
    assert out["round_robin"]["edge"]["rows"] == 499
    api = out["content"]["api"]
    assert api["host_hold"]["queries_differing"] == 0
    assert api["beam"]["lanes"] == 8
    for name in ("predict", "predict_fast"):
        assert 0 < api[name]["recall@10"] <= 1
        assert api[name]["ms/query"] > 0
