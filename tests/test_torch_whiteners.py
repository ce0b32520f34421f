"""The PCA+ZCA and ZCA whitening models of the PyTorch port against the JAX
package, and whitener-mode indexes built on them.

Tolerances: the fits are the same host float64 code in both packages, so
the fitted matrices agree within 1e-9 relative; the transforms (host
numpy, the port's float64-accumulated ``transform_torch`` and the JAX
``transform_jit``, a float32 product) within 1e-5 of the largest
|output|.  Pickles (``save`` and the index file's ``whitener_pickle``)
load in both packages with their arrays unchanged.  Index files written
by either package load in the other and serve the writer's ids.  A small
whitener-mode forest and single tree built by both packages from the same
raw rows have the same structure slot for slot (statistics within
rtol=1e-4, atol=1e-5: each package whitens with its own product), and
their served ids are equal by tie group of the exact re-rank key
(``torch_parity.assert_equal_by_tie_group``)."""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import models as jmodels
from rag_cobweb_tpu_torch import files, interop
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.whitening import models as tmodels

from torch_parity import assert_equal_by_tie_group

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

KINDS = ("zca", "pcazca")
FIELDS = {"zca": ("mean", "whitening_matrix"),
          "pcazca": ("mean", "pca_components", "pca_explained_var")}
N = 160


@pytest.fixture(scope="module")
def data():
    return synthetic_retrieval_hard(N, 24, 20, seed=6)


@pytest.fixture(scope="module", params=KINDS)
def pair(request, data):
    """(kind, JAX model, port model) fitted on the same rows."""
    kind = request.param
    if kind == "zca":
        j = jmodels.ZCAWhiteningModel.fit(data.corpus_embs)
        t = tmodels.ZCAWhiteningModel.fit(data.corpus_embs)
    else:
        j = jmodels.PCAZCAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9)
        t = tmodels.PCAZCAWhiteningModel.fit(data.corpus_embs, pca_dim=0.9)
    return kind, j, t


def test_fits_match_jax(pair, data):
    kind, j, t = pair
    for f in FIELDS[kind]:
        a, b = getattr(t, f), getattr(j, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max(), err_msg=f)
    assert t.eps == j.eps
    # PCA+ZCA keeps every input column at rank k; ZCA is full rank
    assert t.dim_out == data.corpus_embs.shape[1]
    if kind == "pcazca":
        assert t.pca_components.shape[0] < t.dim_out


def test_transforms_agree(pair, data):
    _, j, t = pair
    x = data.query_embs
    want = j.transform(x)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(t.transform(x), want, rtol=0, atol=tol)
    got = t.transform_torch(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, np.asarray(j.transform_jit(
        jnp.asarray(x))), rtol=0, atol=tol)
    # one row in, one row out
    np.testing.assert_allclose(t.transform(x[0]), want[0], rtol=0, atol=tol)
    M, b = t.affine()
    np.testing.assert_allclose(x @ M + b, want, rtol=0, atol=10 * tol)


def test_pickles_load_in_both_packages(pair, data, tmp_path):
    """``save``/``load`` both ways, and the index file's
    ``whitener_pickle``: the port's stream unpickles in the JAX package as
    the JAX class of that name (``_jax_cache`` empty), the JAX package's
    (``_jax_cache`` filled by a transform) in the port as the port's."""
    kind, j, t = pair
    x = data.query_embs[:6]
    j.save(str(tmp_path / "j.pkl"))
    t.save(str(tmp_path / "t.pkl"))
    from_j = type(t).load(str(tmp_path / "j.pkl"))
    from_t = type(j).load(str(tmp_path / "t.pkl"))
    for f in FIELDS[kind]:
        np.testing.assert_array_equal(getattr(from_j, f), getattr(j, f))
        np.testing.assert_array_equal(getattr(from_t, f), getattr(t, f))
    np.testing.assert_array_equal(from_t.transform(x), t.transform(x))
    j.transform_jit(jnp.asarray(x))
    assert j._jax_cache is not None
    got = files.whitener_from_pickle(pickle.dumps(j))
    assert type(got) is type(t) and not hasattr(got, "_jax_cache")
    for f in FIELDS[kind]:
        np.testing.assert_array_equal(getattr(got, f), getattr(j, f))
    back = pickle.loads(files.whitener_pickle(t))
    assert type(back) is type(j) and back._jax_cache is None
    np.testing.assert_array_equal(np.asarray(back.transform_jit(x)),
                                  np.asarray(j.transform_jit(x)))
    assert type(interop.whitener_from_numpy(
        {f: getattr(j, f) for f in FIELDS[kind] + ("eps",)})) is type(t)


def build(package, mode, pair, data, n=N):
    _, j, t = pair
    lanes = 4 if mode == "forest" else 1
    if package == "jax":
        db = JIndex(config=JCfg(dim=t.dim_out), n_subtrees=lanes,
                    whitener=j, capacity=4 * n + 16)
    else:
        db = CobwebIndex(config=TreeConfig(dim=t.dim_out), n_subtrees=lanes,
                         whitener=t, capacity=4 * n + 16, device="cpu")
    db.fused_dtype = "float32"
    db.add_sentences([f"s{i}" for i in range(n)], data.corpus_embs[:n])
    return db


def serve(db, q, threshold):
    db.blocked_threshold = threshold
    db._fused = db._fused_f32 = None
    return np.asarray(db.predict_fast(q, k=10, return_ids=True,
                                      is_embedding=True))


def keys(data, q, ids, pv):
    """The exact re-rank key of each served id, in float64."""
    raw = data.corpus_embs.astype(np.float64)
    d2 = np.sum(np.square(q[:, None, :].astype(np.float64) - raw[ids]), -1)
    return -0.5 * (d2 / pv + q.shape[1] * math.log(pv))


@pytest.mark.parametrize("mode", ["tree", "forest"])
def test_whitener_mode_index_matches_jax(pair, data, mode):
    """The same raw rows into both packages: the same structure slot for
    slot, and the same served ids by tie group, below
    ``blocked_threshold`` (single tree: path scores and the re-rank;
    forest: the small-forest engine) and on the fused engine."""
    jdb, tdb = build("jax", mode, pair, data), build("port", mode, pair,
                                                     data)
    if mode == "forest":
        want = jax.device_get(jdb.forest.state)
        want = {f: np.asarray(getattr(want, f)) for f in tree_mod.FIELDS}
        got = tree_mod.state_to_numpy(tdb.forest.state)
    else:
        st = jdb.tree._host_arrays()
        want = {f: np.asarray(getattr(st, f)) for f in tree_mod.FIELDS}
        got = tdb.tree.host_arrays()
        assert tdb.leaf_of_sentence == jdb.leaf_of_sentence
    for f in tree_mod.FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if mode == "tree" and a.ndim:
            a = a[:len(b)]
        if f in ("means", "m2s"):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    q = data.query_embs
    pv = float(tdb.cfg.prior_var)
    for threshold in (8192, 64):
        w, g = serve(jdb, q, threshold), serve(tdb, q, threshold)
        assert_equal_by_tie_group(w, g, keys(data, q, w, pv),
                                  keys(data, q, g, pv))


@pytest.mark.parametrize("rerank", [24, 6])
def test_backstop_serves_jax_ids_on_the_whitened_store(pair, data, rerank):
    """The backstop pool over the whitened bf16 store, as wide as the raw
    rows (``backstop_threshold`` lowered so ``"auto"`` turns it on): the
    store in kernel 1's layout, and the same served ids as the JAX
    wrapper's, by tie group of the exact re-rank key."""
    _, j, t = pair
    dbs = []
    for package in ("jax", "port"):
        if package == "jax":
            db = JIndex(config=JCfg(dim=t.dim_out), n_subtrees=4, whitener=j)
        else:
            db = CobwebIndex(config=TreeConfig(dim=t.dim_out), n_subtrees=4,
                             whitener=t, device="cpu")
        db.blocked_threshold = 64
        db.fused_dtype = "float32"
        db.backstop_threshold = 64
        db.add_sentences([None] * N, data.corpus_embs)
        dbs.append(db)
    jdb, tdb = dbs
    wemb, half = tdb._wemb_device()
    assert wemb.dtype == torch.bfloat16
    assert wemb.shape[0] == data.corpus_embs.shape[1]
    assert tdb._backstop_k(rerank, N) > 0
    q = data.query_embs
    pv = float(tdb.cfg.prior_var)
    w = np.asarray(jdb.query_ids(q, 10, rerank=rerank))
    g = tdb.query_ids(q, 10, rerank=rerank).numpy()
    assert_equal_by_tie_group(w, g, keys(data, q, w, pv), keys(data, q, g, pv))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["tree", "forest"])
def test_index_files_cross_load(pair, data, tmp_path, mode, writer):
    """An index saved by either package with a ZCA or PCA+ZCA whitener
    loads in both: the whitener is of the writer's class (under the JAX
    name in the file), its arrays equal, and both loads serve the ids the
    writer serves, below ``blocked_threshold`` and on the fused engine."""
    kind, j, t = pair
    src = build(writer, mode, pair, data)
    path = str(tmp_path / "index.npz")
    src.save(path)
    with np.load(path) as f:
        stream = bytes(f["whitener_pickle"])
    # the JAX module and class name (a GLOBAL from the port, a
    # STACK_GLOBAL of two strings from the JAX package's pickle.dumps)
    assert b"rag_cobweb_tpu.whitening.models" in stream
    assert type(j).__name__.encode() in stream
    jl = JIndex.load(path)
    tl = CobwebIndex.load(path, device="cpu")
    assert type(jl.whitener) is type(j) and type(tl.whitener) is type(t)
    for f in FIELDS[kind]:
        np.testing.assert_array_equal(getattr(tl.whitener, f),
                                      getattr(jl.whitener, f))
    q = data.query_embs
    for threshold in (8192, 64):
        want = serve(src, q, threshold)
        for db in (jl, tl):
            db.fused_dtype = "float32"
            np.testing.assert_array_equal(serve(db, q, threshold), want,
                                          err_msg=f"threshold {threshold}")


@pytest.mark.parametrize("kind", ["pcaica", "pcazca", "zca"])
def test_encode_and_whiten_helpers_match_jax(data, kind):
    """Texts through an encoder, or embeddings as they are, then the
    host transform: the same rows in both packages."""
    X = data.corpus_embs
    if kind == "pcaica":
        j = jmodels.PCAICAWhiteningModel.fit(X, pca_dim=0.9,
                                             ica_max_iter=200, seed=0)
        t = interop.whitener_from_numpy({f: getattr(j, f) for f in (
            "mean", "pca_components", "pca_explained_var", "ica_unmixing",
            "eps")})
    elif kind == "pcazca":
        j = jmodels.PCAZCAWhiteningModel.fit(X, pca_dim=0.9)
        t = tmodels.PCAZCAWhiteningModel.fit(X, pca_dim=0.9)
    else:
        j = jmodels.ZCAWhiteningModel.fit(X)
        t = tmodels.ZCAWhiteningModel.fit(X)
    jfn = getattr(jmodels, f"encode_and_whiten_{kind}")
    tfn = getattr(tmodels, f"encode_and_whiten_{kind}")

    def encode(texts):
        return X[[int(s[1:]) for s in texts]]

    texts = [f"s{i}" for i in range(0, N, 9)]
    np.testing.assert_array_equal(tfn(texts, encode, t),
                                  jfn(texts, encode, j))
    np.testing.assert_array_equal(tfn(X[:7], None, t), jfn(X[:7], None, j))
    if kind == "pcaica":
        np.testing.assert_array_equal(tfn(X[:7], None, t, is_ica=False),
                                      jfn(X[:7], None, j, is_ica=False))
    with pytest.raises(ValueError, match="encode_func"):
        tfn(texts, None, t)


def test_chip_smoke_whitener_phase_on_the_host(tmp_path):
    """``chip_smoke.py``'s phase 3h (a) and the blocked part of (c)
    rehearsed on the host at a small size (c=300, 40 queries, 32-d, pool
    64, ``blocked_threshold`` lowered so the fused engine serves): both
    whitener-mode forests as wide as the rows, equal to their plain
    pipelines, saved and loaded back with the same ids, the ZCA forest's
    ``vforest_beam_topk`` equal to its host copy's; then
    ``blocked_rerank_hold`` on a forest's blocked engine."""
    import importlib.util
    from pathlib import Path
    from rag_cobweb_tpu_torch.bench import headline, probes
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.whitener_forests(
        headline, probes.zero_counters, probes.read_counters, tmp_path,
        device="cpu", corpus_size=300, queries=40, dim=32, pool=64,
        threshold=64, card=False)
    for kind, wf in out.items():
        assert wf["rec"]["whitener"] == kind and wf["rec"]["tree_dim"] == 32
        assert wf["fused_shape"][0] == 64            # 2D = 2 x 32
        assert wf["plain"]["queries_differing_from_plain"] == 0
        assert wf["rec"]["recall@10"] == wf["plain"]["plain_recall@10"]
        assert (tmp_path / f"{kind}_forest.npz").exists()
    assert out["zca"]["beam"]["queries_differing_from_host"] == 0

    hold = {}

    def hook(event, engine, db, data):
        if event == "start":
            db.blocked_threshold = 64
            return
        hold.update(smoke.blocked_rerank_hold(
            db, db.whitener.transform_torch(torch.as_tensor(
                data.query_embs)), rerank=64, n_host=16, reps=0))

    headline.run(corpus_size=300, queries=40, dim=32, n_lanes=4, rerank=64,
                 device="cpu", engines=("blocked",), hook=hook)
    assert hold["tied_ids_differing_from_host"] == 0
    assert hold["B"] == 40 and hold["ms"] is None
