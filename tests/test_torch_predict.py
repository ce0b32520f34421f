"""The query API of the port's ``CobwebIndex`` against the JAX package's:
``predict`` (the packed beam: a single tree's, a forest's lane-fair one,
a content-routed forest's over its nearest lanes), ``predict_fast`` (the
engine dispatch, below and above a lowered ``blocked_threshold``), its
``tie_noise``, the level-weight schedules and ``get_node_path_stats``.

Both packages build the same index from the same rows: a single tree in
raw mode, a round-robin forest in whitener mode and a content-routed
forest (4 lanes each).  Ids are held by tie group on the key each call
ranks by, computed on the port's index: the leaf log-prob for
``predict`` (``probes.hold_beam``: within 1e-5 of its terms, whose
float32 rounding it inherits, a leaf log-prob being a sum of terms up to
~100x larger than itself); the exact squared L2 on the raw rows for a
re-ranked ``predict_fast`` and the path score for the path-score order
and ``tie_noise`` (``torch_parity.assert_equal_by_tie_group``, within
1e-5 of the row's largest |key|)."""

import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.core import wrapper as jwrapper
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.bench import probes
from rag_cobweb_tpu_torch.core import index as tindex
from rag_cobweb_tpu_torch.core import wrapper as twrapper
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex

from torch_parity import assert_equal_by_tie_group

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

CASES = ("tree", "round_robin", "content")


@pytest.fixture(scope="module")
def data():
    d = synthetic_retrieval_hard(260, 30, 16, seed=6)
    jw = PCAICAWhiteningModel.fit(d.corpus_embs, pca_dim=0.9,
                                  ica_max_iter=200, seed=0)
    tw = interop.whitener_from_numpy(dict(
        mean=jw.mean, pca_components=jw.pca_components,
        pca_explained_var=jw.pca_explained_var,
        ica_unmixing=jw.ica_unmixing, eps=jw.eps))
    return d, jw, tw


def make_pair(case, data, n=240):
    """The same ``n`` rows (sentences ``s<i>``) into a JAX and a port
    index: a raw single tree, a whitener-mode round-robin forest or a raw
    content-routed forest."""
    d, jw, tw = data
    xs = d.corpus_embs[:n]
    sents = [f"s{i}" for i in range(n)]
    if case == "tree":
        return (JIndex(sents, xs),
                CobwebIndex(sents, xs, device="cpu"))
    white = case == "round_robin"
    dim = jw.dim_out if white else xs.shape[1]
    jdb = JIndex(config=JCfg(dim=dim), n_subtrees=4, routing=case,
                 whitener=jw if white else None)
    tdb = CobwebIndex(config=TreeConfig(dim=dim), n_subtrees=4,
                      routing=case, whitener=tw if white else None,
                      device="cpu")
    for db in (jdb, tdb):
        db.add_sentences(sents, xs)
    assert tdb.forest.shard_of == jdb.forest.shard_of
    return jdb, tdb


@pytest.fixture(scope="module", params=CASES)
def pair(request, data):
    jdb, tdb = make_pair(request.param, data)
    return request.param, jdb, tdb


def tree_space(tdb, q):
    q = torch.as_tensor(np.atleast_2d(q))
    return tdb.whitener.transform_torch(q) if tdb.whitener else q


def flat_index(tdb):
    return (tdb.forest.flat_index() if tdb.forest is not None
            else tdb.build_prediction_index())


def as_array(rows, fill=-1):
    width = max(len(r) for r in rows)
    return np.asarray([list(r) + [fill] * (width - len(r)) for r in rows])


def exact_keys(xs, q, ids):
    x = np.asarray(xs, np.float64)[ids]
    return -np.sum(np.square(x - np.asarray(q, np.float64)[:, None]), -1)


def path_keys(tdb, q, ids):
    s = tindex.rank_scores(flat_index(tdb), tree_space(tdb, q)).numpy()
    return np.take_along_axis(s, ids, 1)


@pytest.mark.parametrize("width", [4, 16])
def test_predict_matches_jax(pair, data, width):
    """``predict`` (beam width 4 and 16; a content-routed forest descends
    its 2 nearest lanes a query, then the auto 4 of 4) equal to the JAX
    package's by tie group.  The JAX single tree's index is built first:
    its ``predict`` reads ``max_depth`` before building, so a first call
    on a new index descends 4 levels; the port's builds first."""
    case, jdb, tdb = pair
    q = data[0].query_embs
    if case == "tree":
        jdb.build_prediction_index()
    lanes = (2, None) if case == "content" else (None,)
    for lpq in lanes:
        want = jdb.predict(q, k=10, return_ids=True, is_embedding=True,
                           beam_width=width, beam_lanes=lpq)
        got = tdb.predict(q, k=10, return_ids=True, is_embedding=True,
                          beam_width=width, beam_lanes=lpq)
        probes.hold_beam(tdb, q, want, got)
    if case == "tree":
        assert tdb.max_depth == jdb.max_depth > 0


@pytest.mark.parametrize("pair", ["round_robin", "content"], indirect=True)
@pytest.mark.parametrize("kw", [dict(lane_fair=False),
                                dict(max_depth=4, lanes_per_query=3)],
                         ids=["global-beam", "cut-depth"])
def test_forest_beam_topk_matches_jax(pair, data, kw):
    """``VForest.beam_topk`` off ``predict``'s defaults: one global beam
    over the lane roots, and a depth cut to 4 levels over each query's 3
    nearest lanes (by centroid, or by root mean on a round-robin forest),
    equal to the JAX forest's by tie group."""
    _, jdb, tdb = pair
    q = data[0].query_embs
    qt = tree_space(tdb, q)
    want = np.asarray(jdb.forest.beam_topk(qt.numpy(), 10, beam_width=8,
                                           **kw))
    got = tdb.forest.beam_topk(qt, 10, beam_width=8, **kw).numpy()
    probes.hold_beam(tdb, q, want.tolist(), got.tolist())


def test_predict_input_forms(pair, data):
    """One 1-D query gives the batch's first row; ``return_ids=False``
    gives the sentences; text goes through ``encode_func``, as in the JAX
    package."""
    case, jdb, tdb = pair
    q = data[0].query_embs[:5]
    ids = tdb.predict(q, k=5, return_ids=True, is_embedding=True)
    assert tdb.predict(q[0], k=5, return_ids=True, is_embedding=True) \
        == ids[0]
    assert tdb.predict(q, k=5, is_embedding=True) == [
        [f"s{i}" for i in row] for row in ids]
    texts = {f"t{i}": q[i] for i in range(len(q))}

    def encode(batch):
        return np.stack([texts[t] for t in batch])

    for db in (jdb, tdb):
        db.encode_func = encode
    if case == "tree":
        jdb.build_prediction_index()
    assert tdb.predict("t1", k=5) == jdb.predict("t1", k=5)
    assert tdb.predict_fast(list(texts), k=5) == jdb.predict_fast(
        list(texts), k=5)
    assert tdb.predict_fast("t2", k=5, return_ids=True) == \
        tdb.predict_fast(q[2], k=5, return_ids=True, is_embedding=True)


@pytest.mark.parametrize("threshold", [8192, 64],
                         ids=["below-threshold", "fused"])
@pytest.mark.parametrize("rerank", [None, 0], ids=["auto", "path-order"])
def test_predict_fast_matches_jax(pair, data, threshold, rerank):
    """``predict_fast`` below ``blocked_threshold`` (the single tree's
    path scores, the small-forest engine) and above it (the fused engine,
    threshold lowered on both objects; f32 serving index), at the auto
    pool and at ``rerank=0``: equal by tie group on the key of the
    branch, and equal to ``query_ids``."""
    case, jdb, tdb = pair
    d = data[0]
    q = d.query_embs
    for db in (jdb, tdb):
        db.blocked_threshold = threshold
        db.fused_dtype = "float32"
        db._fused = db._fused_f32 = None
    want = as_array(jdb.predict_fast(q, k=10, return_ids=True,
                                     is_embedding=True, rerank=rerank))
    got = as_array(tdb.predict_fast(q, k=10, return_ids=True,
                                    is_embedding=True, rerank=rerank))
    np.testing.assert_array_equal(got, tdb.query_ids(q, 10, rerank=rerank))
    small_forest = case != "tree" and threshold > len(tdb)
    if rerank == 0 and not small_forest:
        keys = path_keys(tdb, q, want), path_keys(tdb, q, got)
    elif rerank == 0:
        keys = (probes.leaf_keys(tdb, q, want)[0],
                probes.leaf_keys(tdb, q, got)[0])
    elif case == "tree":
        # raw mode below rerank_threshold: the auto pool is off
        keys = path_keys(tdb, q, want), path_keys(tdb, q, got)
    else:
        xs = d.corpus_embs[:len(tdb)]
        keys = exact_keys(xs, q, want), exact_keys(xs, q, got)
    assert_equal_by_tie_group(want, got, *keys)


def test_tie_noise_matches_jax(pair, data):
    """``tie_noise``: the flat index's path scores plus 1e-6 noise seeded
    from the sentence count (threshold lowered, so a forest takes the
    flat index too), equal to the JAX package's by tie group on the path
    score (the two packages draw different noise), the same ids on a
    second call."""
    case, jdb, tdb = pair
    q = data[0].query_embs
    for db in (jdb, tdb):
        db.blocked_threshold = 64
    want = np.asarray(jdb.predict_fast(q, k=10, return_ids=True,
                                       is_embedding=True, tie_noise=True))
    got = np.asarray(tdb.predict_fast(q, k=10, return_ids=True,
                                      is_embedding=True, tie_noise=True))
    assert_equal_by_tie_group(want, got, path_keys(tdb, q, want),
                              path_keys(tdb, q, got))
    np.testing.assert_array_equal(
        tdb.predict_fast(q, k=10, return_ids=True, is_embedding=True,
                         tie_noise=True), got)


@pytest.mark.parametrize("kind,depth,kw,want", [
    ("constant", 4, {}, [1.0] * 4),
    ("linear", 3, dict(start=0.0, end=1.0), [0.0, 0.5, 1.0]),
    ("linear", 3, dict(start=0.0, end=1.0, direction="decrease"),
     [1.0, 0.5, 0.0]),
    ("quadratic", 3, {}, [1.0, 0.25, 1 / 9]),
    ("exponential", 3, dict(base=0.5), [1.0, 0.5, 0.25]),
    ("bogus", 3, {}, ValueError)],
    ids=["constant", "linear", "linear-decrease", "quadratic",
         "exponential", "unknown"])
def test_generate_weight_schedule(kind, depth, kw, want):
    """Every case of the JAX package's ``test_weight_schedules``, on both
    packages' ``_generate_weight_schedule``."""
    if want is ValueError:
        for gen in (twrapper._generate_weight_schedule,
                    jwrapper._generate_weight_schedule):
            with pytest.raises(ValueError):
                gen(kind, depth, **kw)
        return
    got = twrapper._generate_weight_schedule(kind, depth, **kw)
    assert got == want
    assert got == jwrapper._generate_weight_schedule(kind, depth, **kw)


def test_weight_schedule_then_predict_fast(data):
    """A single tree: ``set_weight_schedule`` takes the built index's depth
    and reaches the path scores (``predict_fast`` equal to the JAX
    package's, ``get_level_weights`` and ``get_weight_schedule_info``
    equal); ``set_level_weights`` of the defaults restores the first ids;
    ``get_node_path_stats`` within 1e-5; a forest ignores the weights."""
    jdb, tdb = make_pair("tree", data)
    q = data[0].query_embs
    assert tdb.get_level_weights() == jdb.get_level_weights() == [1.0] * 4
    base = tdb.predict_fast(q, k=10, return_ids=True, is_embedding=True)
    assert base == jdb.predict_fast(q, k=10, return_ids=True,
                                    is_embedding=True)
    for kind, kw in (("exponential", dict(base=0.5)),
                     ("linear", dict(start=1.0, end=0.25))):
        for db in (jdb, tdb):
            db.set_weight_schedule(kind, **kw)
        assert tdb.get_level_weights() == jdb.get_level_weights()
        assert len(tdb.get_level_weights()) == tdb.max_depth
        assert tdb.get_weight_schedule_info() == \
            jdb.get_weight_schedule_info()
        want = np.asarray(jdb.predict_fast(q, k=10, return_ids=True,
                                           is_embedding=True))
        got = np.asarray(tdb.predict_fast(q, k=10, return_ids=True,
                                          is_embedding=True))
        assert_equal_by_tie_group(want, got, path_keys(tdb, q, want),
                                  path_keys(tdb, q, got))
        assert not np.array_equal(got, base)
    tdb.set_level_weights(list(tindex.DEFAULT_LEVEL_WEIGHTS))
    assert tdb.get_weight_schedule_info()["schedule_type"] is None
    assert tdb.predict_fast(q, k=10, return_ids=True,
                            is_embedding=True) == base
    for sid in (0, 7, 239):
        wm, wv = jdb.get_node_path_stats(sid)
        tm, tv = tdb.get_node_path_stats(sid)
        np.testing.assert_allclose(tm, wm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tv, wv, rtol=1e-5, atol=1e-6)
    assert tdb.get_node_path_stats(240) == (None, None)
    forest = make_pair("content", data)[1]
    before = forest.predict_fast(q, k=10, return_ids=True, is_embedding=True)
    forest.set_weight_schedule("exponential", base=0.5)
    assert forest.predict_fast(q, k=10, return_ids=True,
                               is_embedding=True) == before
    with pytest.raises(ValueError, match="single-tree"):
        forest.get_node_path_stats(0)


@pytest.mark.parametrize("case", CASES)
def test_predict_flushes_pending_rows(data, case):
    """Rows added on top of a serving index wait in the pending tier;
    ``predict`` flushes them (the beam needs the exact index) and serves
    the ids of the JAX package, whose single tree is flushed and rebuilt
    first (its ``predict`` would descend the old index's depth)."""
    d = data[0]
    jdb, tdb = make_pair(case, data, n=200)
    for db in (jdb, tdb):
        db.blocked_threshold = 64
        db.query_ids(d.query_embs[:4], 5)
        db.add_sentences([f"n{i}" for i in range(20)],
                         d.corpus_embs[200:220])
    assert tdb._unindexed_count() == 20
    q = d.corpus_embs[200:220]
    if case == "tree":
        jdb._flush_pending()
        jdb.build_prediction_index()
    want = jdb.predict(q, k=3, return_ids=True, is_embedding=True)
    got = tdb.predict(q, k=3, return_ids=True, is_embedding=True)
    assert tdb._unindexed_count() == 0
    probes.hold_beam(tdb, q, want, got)
