"""The single tree of the PyTorch port against the JAX package, on the host
(``device="cpu"``): the ``CobwebTree`` facade (``fit``, ``ifit``,
``categorize``, JSON and npz files), the prediction index
(``build_index``, ``rank_scores``, ``query_topk``, ``query_topk_rerank``,
``build_fused_index``) and the single-tree ``CobwebIndex`` (``query_ids``
on every engine branch, ``rank_scores``, JSON).  Inputs come from numpy
seeds and are tie-free (the packages draw tie noise from different
generators); tolerances are stated where floats are compared."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.bench.metrics import retrieval_metrics
from rag_cobweb_tpu.core import index as jindex
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.tree import CobwebTree as JTree
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import index as tindex
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex

from reference_oracle import OracleTree

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

STRUCT = ("parent", "children", "n_children", "free_stack", "free_top",
          "n_alloc", "root", "counts")


def jax_arrays(tree: JTree) -> dict:
    st = tree._host_arrays()
    return {f: np.asarray(getattr(st, f)) for f in tree_mod.FIELDS}


def assert_same_tree(got: dict, want: dict, stats_rtol=1e-5, n=None):
    """Slot for slot: structure and counts equal, means/m2s within
    ``stats_rtol`` (float32 sums of the two packages; atol 1e-5).  ``n``
    limits the per-node arrays to the first n slots (capacities may
    differ)."""
    for f in STRUCT:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if n is not None and a.ndim:
            a, b = a[:n], b[:n]
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("means", "m2s"):
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if n is not None:
            a, b = a[:n], b[:n]
        np.testing.assert_allclose(a, b, rtol=stats_rtol, atol=1e-5,
                                   err_msg=f)


def clustered(n, dim, seed, k=4, scale=2.0, noise=0.4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(k, dim))
    return (centers[rng.integers(0, k, n)]
            + noise * rng.normal(size=(n, dim))).astype(np.float32)


def port_tree(xs, mode, cfg=None, capacity=None, **kw):
    cfg = cfg or TreeConfig(dim=xs.shape[1])
    tree = CobwebTree(cfg, capacity=capacity or 4 * len(xs) + 16,
                      device="cpu", **kw)
    if mode == "fit":
        leaves = tree.fit(xs, batch_size=32)
    else:
        leaves = np.asarray([tree.ifit(x) for x in xs])
    return tree, leaves


def jax_tree(xs, mode, cfg=None, capacity=None):
    cfg = cfg or JCfg(dim=xs.shape[1])
    tree = JTree(cfg, capacity=capacity or 4 * len(xs) + 16, seed=0)
    if mode == "fit":
        leaves = tree.fit(xs, batch_size=32)
    else:
        leaves = np.asarray([tree.ifit(x) for x in xs])
    return tree, leaves


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def _oracle_cases():
    out = []
    for n, dim, seed in [(8, 4, 0), (30, 6, 1), (60, 5, 2)]:
        out.append((f"random-{n}", np.random.default_rng(seed).normal(
            size=(n, dim)).astype(np.float32), {}))
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=3.0, size=(5, 6))
    xs = np.concatenate([c + 0.2 * rng.normal(size=(12, 6))
                         for c in centers]).astype(np.float32)
    out.append(("clustered", xs[rng.permutation(len(xs))], {}))
    xs = np.random.default_rng(4).normal(size=(25, 4)).astype(np.float32)
    for name, kw in (("info", dict(use_info=True, use_kl=False)),
                     ("cu", dict(use_info=False)),
                     ("acuity", dict(acuity_cutoff=True))):
        out.append((name, xs, kw))
    return out


ORACLE_CASES = _oracle_cases()


@pytest.mark.parametrize("mode", ["fit", "ifit"])
@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in
                                                    ORACLE_CASES])
def test_tree_matches_oracle(case, mode):
    """The cases of tests/test_tree.py: the same signature (structure and
    statistics to 4 decimals) as the reference algorithm's numpy oracle,
    built by ``fit`` and by a sequence of ``ifit``."""
    _, xs, kw = case
    tree, _ = port_tree(xs, mode, TreeConfig(dim=xs.shape[1], **kw))
    oracle = OracleTree(xs.shape[1], **kw)
    for x in xs:
        oracle.ifit(x)
    assert tree.signature() == oracle.signature()


@pytest.mark.parametrize("mode", ["fit", "ifit"])
@pytest.mark.parametrize("n,dim,seed,absorb", [(40, 6, 5, 0), (90, 8, 6, 0),
                                               (70, 5, 7, 3)])
def test_tree_equals_jax_slot_for_slot(n, dim, seed, absorb, mode):
    """Same rows -> the JAX CobwebTree's tree slot for slot (counts,
    means, m2s, parent, children, the free stack) and the same leaves,
    from a small capacity that grows; ``absorb_depth`` 3 included."""
    xs = clustered(n, dim, seed)
    jt, jl = jax_tree(xs, mode, JCfg(dim=dim, absorb_depth=absorb), 16)
    tt, tl = port_tree(xs, mode, TreeConfig(dim=dim, absorb_depth=absorb),
                       16)
    np.testing.assert_array_equal(tl, jl)
    assert_same_tree(tt.host_arrays(), jax_arrays(jt))
    assert tt.n_inserted == jt.n_inserted == n
    assert tt.analyze_structure() == jt.analyze_structure()


@pytest.mark.parametrize("n,dim,seed", [(20, 4, 7), (64, 6, 8)])
def test_ifit_sequence_equals_fit(n, dim, seed):
    """A sequence of ``ifit`` gives batched ``fit``'s tree and leaves (the
    JAX package's test_batched_equals_sequential_ifit)."""
    xs = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    t1, l1 = port_tree(xs, "fit")
    t2, l2 = port_tree(xs, "ifit")
    np.testing.assert_array_equal(l1, l2)
    assert t1.signature() == t2.signature()
    a, b = t1.host_arrays(), t2.host_arrays()
    for f in tree_mod.FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("iterations,randomize", [(2, False), (1, True),
                                                  (3, True)])
def test_fit_passes_equal_jax(iterations, randomize):
    """``iterations`` and ``randomize_first``: the same final-pass leaves
    and tree as the JAX package."""
    xs = clustered(36, 5, 9)
    jt = JTree(JCfg(dim=5), capacity=256)
    jl = jt.fit(xs, iterations=iterations, randomize_first=randomize, seed=3)
    tt = CobwebTree(TreeConfig(dim=5), capacity=256, device="cpu")
    tl = tt.fit(xs, iterations=iterations, randomize_first=randomize, seed=3)
    np.testing.assert_array_equal(tl, jl)
    assert_same_tree(tt.host_arrays(), jax_arrays(jt))


@pytest.fixture(scope="module")
def twin_trees():
    xs = clustered(80, 6, 11)
    jt, jl = jax_tree(xs, "fit")
    tt, tl = port_tree(xs, "fit")
    return xs, jt, tt, jl


@pytest.mark.parametrize("kw", [
    {}, dict(retrieve_k=1), dict(retrieve_k=5), dict(retrieve_k=200),
    dict(greedy=True), dict(greedy=True, retrieve_k=3),
    dict(max_nodes=7), dict(retrieve_k=4, odd_leaves=True)],
    ids=["best", "k1", "k5", "k-all", "greedy", "greedy-k3", "max-nodes",
         "leaf-predicate"])
def test_categorize_equals_jax(twin_trees, kw):
    """Best-first search: the same best node or retrieved leaves (in visit
    order) as the JAX tree, on the same tree."""
    xs, jt, tt, _ = twin_trees
    kw = dict(kw)
    if kw.pop("odd_leaves", False):
        kw["leaf_has_sentences"] = lambda n: n % 2 == 1
    for i in (0, 17, 55):
        q = xs[i] + 0.05
        want = jt.categorize(q, rng=np.random.default_rng(i), **kw)
        got = tt.categorize(q, rng=np.random.default_rng(i), **kw)
        assert got == want


def _json_close(a, b):
    """Two nested-schema dicts: same keys, sentence ids and shape; floats
    within float32 rounding of the two packages' sums."""
    assert a.keys() == b.keys()
    for k in a:
        if k == "children":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                _json_close(x, y)
        elif k == "root":
            _json_close(a[k], b[k])
        elif isinstance(a[k], list) and a[k] and isinstance(a[k][0], float):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)
        else:
            assert a[k] == b[k], k


def test_dump_json_equals_jax(twin_trees):
    xs, jt, tt, leaves = twin_trees
    sids = {}
    for i, leaf in enumerate(leaves):
        sids.setdefault(int(leaf), []).append(i)
    _json_close(json.loads(tt.dump_json(sids)), json.loads(jt.dump_json(sids)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_cross_loads(twin_trees, writer):
    """A file of either package loads in both, slot for slot the same
    (children numbered in the JAX package's pop order), with the same
    leaf sentence ids; the loaded trees keep inserting alike."""
    xs, jt, tt, leaves = twin_trees
    sids = {int(leaf): [i] for i, leaf in enumerate(leaves)}
    blob = (jt if writer == "jax" else tt).dump_json(sids)
    jl, jsids = JTree.load_json(blob)
    tl, tsids = CobwebTree.load_json(blob, device="cpu")
    assert tsids == jsids
    want = jax_arrays(jl)
    cap = len(want["counts"])
    assert tl.state.capacity >= cap
    assert_same_tree(tl.host_arrays(), want, stats_rtol=0, n=cap)
    assert tl.signature() == tt.signature()
    assert tl.n_inserted == jl.n_inserted
    more = clustered(12, 6, 12)
    np.testing.assert_array_equal(tl.fit(more), jl.fit(more))
    assert_same_tree(tl.host_arrays(), jax_arrays(jl),
                     n=len(jax_arrays(jl)["counts"]))


@pytest.mark.parametrize("writer", ["jax", "port", "jax-from-json"])
def test_npz_cross_loads(twin_trees, tmp_path, writer):
    """npz checkpoints in the JAX layout (scalar root, n_alloc, free_top):
    the JAX package's load in the port and the port's in the JAX package,
    extras included; an unaligned JAX capacity (from ``load_json``) keeps
    its slot ids."""
    xs, jt, tt, _ = twin_trees
    src = jt
    if writer == "jax-from-json":
        src, _ = JTree.load_json(jt.dump_json())
    path = str(tmp_path / "tree.npz")
    if writer == "port":
        tt.save_npz(path, extra=np.arange(5))
    else:
        src.save_npz(path, extra=np.arange(5))
    jl, jx = JTree.load_npz(path)
    tl, tx = CobwebTree.load_npz(path, device="cpu")
    np.testing.assert_array_equal(tx["extra"], np.arange(5))
    np.testing.assert_array_equal(jx["extra"], np.arange(5))
    want = jax_arrays(jl)
    cap = len(want["counts"])
    assert_same_tree(tl.host_arrays(), want, stats_rtol=0, n=cap)
    assert tl.n_inserted == jl.n_inserted
    with np.load(path) as data:
        assert data["root"].shape == () and data["free_top"].shape == ()
        assert data["counts"].shape == (cap,)
    more = clustered(16, 6, 13)
    np.testing.assert_array_equal(tl.fit(more), jl.fit(more))


def test_tree_from_jax_state(twin_trees):
    """``interop.tree_from_numpy`` over ``jax.device_get(tree.state)``."""
    xs, jt, tt, _ = twin_trees
    arrays = jax.device_get(jt.state)._asdict()
    t = interop.tree_from_numpy(arrays, jt.cfg.to_json_dict(), device="cpu",
                                n_inserted=jt.n_inserted)
    assert_same_tree(t.host_arrays(), jax_arrays(jt), stats_rtol=0)
    assert t.signature() == tt.signature()


# ---------------------------------------------------------------------------
# the prediction index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twin_index(twin_trees):
    xs, jt, tt, leaves = twin_trees
    return xs, jindex.build_index(jt, leaves), tindex.build_index(tt, leaves)


INDEX_INT = ("paths", "children", "leaf_sentence_start",
             "leaf_sentence_count", "sentence_order")


@pytest.mark.parametrize("lw,pad", [(None, 4), ((1.0, 0.5, 2.0), 4),
                                    (None, 3)],
                         ids=["default", "level-weights", "pad3"])
def test_build_index_arrays_equal(twin_trees, lw, pad):
    """Every array of the JAX ``build_index``: structure exactly, the
    path weights exactly, the GEMM terms within 1e-5 relative (float32
    sums in another order)."""
    xs, jt, tt, leaves = twin_trees
    kw = {} if lw is None else dict(level_weights=lw)
    want = jindex.build_index(jt, leaves, pad_depth_to=pad, **kw)
    got = tindex.build_index(tt, leaves, pad_depth_to=pad, **kw)
    for f in INDEX_INT + ("path_weights",):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("inv_var_T", "mu_over_var_T", "const"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert got.num_nodes == want.num_nodes
    assert got.num_sentences == want.num_sentences


@pytest.mark.parametrize("B", [1, 7])
def test_rank_scores_equal_jax(twin_index, B):
    xs, ji, ti = twin_index
    q = xs[:B] + 0.1
    want = np.asarray(jindex.rank_scores(ji, jnp.asarray(q)))
    got = tindex.rank_scores(ti, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_rank_scores_gradient_equals_jax(twin_index):
    """Plain autograd through ``rank_scores``: the gradient of a weighted
    sum of the scores in the queries equals JAX's (1e-4 relative)."""
    xs, ji, ti = twin_index
    q = xs[:3] + 0.1
    w = np.random.default_rng(0).normal(
        size=(3, ti.num_sentences)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        jindex.rank_scores(ji, x) * w))(jnp.asarray(q)))
    qt = torch.as_tensor(q).requires_grad_(True)
    torch.sum(tindex.rank_scores(ti, qt) * torch.as_tensor(w)).backward()
    np.testing.assert_allclose(qt.grad.numpy(), want, rtol=1e-4, atol=1e-3)
    assert float(np.abs(want).sum()) > 0


@pytest.mark.parametrize("k", [1, 5, 80, 200])
def test_query_topk_ids_equal_jax(twin_index, k):
    xs, ji, ti = twin_index
    q = xs[::9] + 0.05
    ws, wi = jindex.query_topk(ji, jnp.asarray(q), k)
    gs, gi = tindex.query_topk(ti, torch.as_tensor(q), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-4)


def test_query_topk_tie_noise_is_seeded(twin_index):
    """``generator`` (the JAX ``noise_key``) adds 1e-6 noise: a seed fixes
    the ids, and with a tie-free corpus they are the noiseless ids."""
    xs, ji, ti = twin_index
    q = torch.as_tensor(xs[:4] + 0.05)
    plain = tindex.query_topk(ti, q, 5)[1]
    a = tindex.query_topk(ti, q, 5, torch.Generator().manual_seed(1))[1]
    b = tindex.query_topk(ti, q, 5, torch.Generator().manual_seed(1))[1]
    assert torch.equal(a, b) and torch.equal(a, plain)


@pytest.mark.parametrize("k,rerank", [(1, 8), (5, 24), (10, 200)])
def test_query_topk_rerank_ids_equal_jax(twin_index, k, rerank):
    xs, ji, ti = twin_index
    q = xs[::7] + 0.05
    ws, wi = jindex.query_topk_rerank(ji, jnp.asarray(q), k, rerank)
    gs, gi = tindex.query_topk_rerank(ti, torch.as_tensor(q), k, rerank)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_fused_index_equals_jax(twin_index, dtype):
    """GT within the serving dtype's tolerance (f32: 1e-5 relative; bf16:
    one rounding step, 2^-8 relative), c within 1e-5, the same padding."""
    xs, ji, ti = twin_index
    want = jindex.build_fused_index(ji, dtype=jnp.dtype(dtype))
    got = tindex.build_fused_index(ti, dtype=getattr(torch, dtype))
    assert str(got.GT.dtype) == f"torch.{dtype}"
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.GT.float().numpy(),
                               np.asarray(want.GT, np.float32), rtol=rtol,
                               atol=1e-5)
    np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


# ---------------------------------------------------------------------------
# the single-tree CobwebIndex
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    data = synthetic_retrieval_hard(240, 40, 32, seed=3)
    jw = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9,
                                  ica_max_iter=200, seed=0)
    tw = interop.whitener_from_numpy(dict(
        mean=jw.mean, pca_components=jw.pca_components,
        pca_explained_var=jw.pca_explained_var,
        ica_unmixing=jw.ica_unmixing, eps=jw.eps))
    return data, jw, tw


@pytest.fixture(scope="module", params=["raw", "whitener"])
def twin_db(request, corpus):
    data, jw, tw = corpus
    white = request.param == "whitener"
    jdb = JIndex(corpus_embeddings=data.corpus_embs,
                 whitener=jw if white else None)
    tdb = CobwebIndex(corpus_embeddings=data.corpus_embs,
                      whitener=tw if white else None, device="cpu")
    return data, jdb, tdb


def _serve(db, data, threshold, rerank, fused_dtype="float32"):
    db.blocked_threshold = threshold
    if db.fused_dtype != fused_dtype:
        db.fused_dtype = fused_dtype
        db._fused = db._fused_f32 = None
    return np.asarray(db.query_ids(data.query_embs, 10, rerank=rerank))


def test_single_tree_builds_like_jax(twin_db):
    data, jdb, tdb = twin_db
    assert tdb.tree is not None and tdb.forest is None
    np.testing.assert_array_equal(tdb.leaf_of_sentence, jdb.leaf_of_sentence)
    assert tdb.tree.analyze_structure() == jdb.tree.analyze_structure()


@pytest.mark.parametrize("rerank", [None, 24, 0],
                         ids=["auto", "pool24", "path-order"])
@pytest.mark.parametrize("threshold", [8192, 64],
                         ids=["query_topk", "fused"])
def test_query_ids_equal_jax(twin_db, threshold, rerank):
    """Served ids equal the JAX package's on every query: below
    ``blocked_threshold`` (path scores of the prediction index, then the
    exact or leaf-lp re-rank) and on the fused branch (threshold lowered
    on both objects; an f32 serving index)."""
    data, jdb, tdb = twin_db
    want = _serve(jdb, data, threshold, rerank)
    got = _serve(tdb, data, threshold, rerank)
    np.testing.assert_array_equal(got, want)


def test_fused_bf16_recall_equals_jax(twin_db):
    """With the default bf16 fused index recall@10 is equal (bf16 may
    reorder near-ties inside the pool, never the exact re-rank)."""
    data, jdb, tdb = twin_db
    want = _serve(jdb, data, 64, 24, "bfloat16")
    got = _serve(tdb, data, 64, 24, "bfloat16")
    rw = retrieval_metrics(want, data.target_ids, 10)["recall@10"]
    assert retrieval_metrics(got, data.target_ids, 10)["recall@10"] == rw


def test_wrapper_rank_scores_and_info_equal_jax(twin_db):
    data, jdb, tdb = twin_db
    want = np.asarray(jdb.rank_scores(data.query_embs[:4], is_embedding=True))
    got = tdb.rank_scores(data.query_embs[:4], is_embedding=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    one = tdb.rank_scores(data.query_embs[0], is_embedding=True)
    assert one.shape == (len(data.corpus_embs),)
    assert tdb.get_prediction_index_info() == jdb.get_prediction_index_info()
    tdb.force_rebuild_index()
    assert tdb.get_prediction_index_info()["index_valid"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wrapper_json_cross_loads(corpus, writer):
    """The reference-parity JSON (no whitener): each package loads the
    other's file, keeps the sentences and serves the same ids (leaf-lp
    re-rank, no vector store)."""
    data, _, _ = corpus
    sents = [f"s{i}" for i in range(len(data.corpus_embs))]
    src = (JIndex(corpus=sents, corpus_embeddings=data.corpus_embs)
           if writer == "jax" else
           CobwebIndex(corpus=sents, corpus_embeddings=data.corpus_embs,
                       device="cpu"))
    blob = src.dump_json()
    jl = JIndex.load_json(blob)
    tl = CobwebIndex.load_json(blob, device="cpu")
    assert tl.sentences == jl.sentences == sents
    assert tl.leaf_of_sentence == jl.leaf_of_sentence
    for thr, rr in ((8192, None), (8192, 16), (64, 16)):
        want = _serve(jl, data, thr, rr)
        got = _serve(tl, data, thr, rr)
        np.testing.assert_array_equal(got, want)


def test_forest_mode_keeps_its_json_guard():
    db = CobwebIndex(config=TreeConfig(dim=4), n_subtrees=2, device="cpu")
    with pytest.raises(ValueError, match="single-tree"):
        db.dump_json()
