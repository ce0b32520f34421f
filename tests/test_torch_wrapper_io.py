"""The wrapper's npz files across the two packages: ``CobwebIndex.save``
and ``CobwebIndex.load`` of the port against the JAX package's, in both
modes (single tree, 4-lane forest), raw and in whitener mode, with rows
pending at save time and embedding-only rows (``None`` sentences).  Each
package writes, the other loads: the state arrays and the router equal
the writer's exactly, the sentences and the whitener too, and
``predict_fast`` serves the ids the writer's package serves from the same
file (below ``blocked_threshold`` and, lowered, on the fused engine).

The whitener travels as a pickle (``files.py``): the JAX package's
unpickles in the port with no JAX object built, the port's in the JAX
package as its own class.  One case loads a JAX-written whitener-mode
file in a fresh interpreter and shows that neither ``jax`` nor the JAX
package was imported."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel as JWhitener
from rag_cobweb_tpu_torch import files, interop
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N0, N_PENDING = 150, 12
WHITENER_FIELDS = ("mean", "pca_components", "pca_explained_var",
                   "ica_unmixing", "eps")


@pytest.fixture(scope="module")
def data():
    d = synthetic_retrieval_hard(N0 + N_PENDING, 24, 16, seed=8)
    jw = JWhitener.fit(d.corpus_embs, pca_dim=0.9, ica_max_iter=200, seed=0)
    tw = interop.whitener_from_numpy(
        {f: getattr(jw, f) for f in WHITENER_FIELDS})
    return d, jw, tw


def sentences(lo, hi):
    return [None if i % 5 == 0 else f"s{i}" for i in range(lo, hi)]


def build(package, mode, white, data):
    """An index of ``package`` over the first N0 rows, served once, then
    N_PENDING rows added on top of the serving index (they wait in the
    pending tier)."""
    d, jw, tw = data
    lanes = 4 if mode == "forest" else 1
    if package == "jax":
        w = jw if white else None
        dim = jw.dim_out if white else d.corpus_embs.shape[1]
        db = JIndex(config=JCfg(dim=dim), n_subtrees=lanes, whitener=w)
    else:
        w = tw if white else None
        dim = tw.dim_out if white else d.corpus_embs.shape[1]
        db = CobwebIndex(config=TreeConfig(dim=dim), n_subtrees=lanes,
                         whitener=w, device="cpu")
    db.blocked_threshold = 64
    db.add_sentences(sentences(0, N0), d.corpus_embs[:N0])
    db.query_ids(d.query_embs[:4], 5, rerank=16)
    db.add_sentences(sentences(N0, N0 + N_PENDING),
                     d.corpus_embs[N0:N0 + N_PENDING])
    assert db._unindexed_count() == N_PENDING
    return db


def state_arrays(db) -> dict:
    """The tree's or forest's state arrays in the JAX layout."""
    if isinstance(db, CobwebIndex):
        if db.forest is not None:
            return tree_mod.state_to_numpy(db.forest.state)
        return db.tree.host_arrays()
    if db.forest is not None:
        st = jax.device_get(db.forest.state)
    else:
        st = db.tree._host_arrays()
    return {f: np.asarray(getattr(st, f)) for f in tree_mod.FIELDS}


def serve(db, q, threshold):
    db.blocked_threshold = threshold
    db.fused_dtype = "float32"
    db._fused = db._fused_f32 = None
    return np.asarray(db.predict_fast(q, k=10, return_ids=True,
                                      is_embedding=True))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("white", [False, True], ids=["raw", "whitener"])
@pytest.mark.parametrize("mode", ["tree", "forest"])
def test_save_load_across_packages(data, tmp_path, mode, white, writer):
    d = data[0]
    src = build(writer, mode, white, data)
    path = str(tmp_path / "index.npz")
    src.save(path)
    jl = JIndex.load(path)
    tl = CobwebIndex.load(path, device="cpu")
    want, got = state_arrays(jl), state_arrays(tl)
    n = len(want["counts"]) if mode == "tree" else None
    for f in tree_mod.FIELDS:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        if n is not None and a.ndim:
            a = a[:n]
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(state_arrays(src)["counts"][:n],
                                  want["counts"][:n])
    assert tl.sentences == jl.sentences == src.sentences
    assert tl.sentences[0] is None and tl.sentences[1] == "s1"
    assert (tl.n_subtrees, tl.cfg.to_json_dict()) == (
        jl.n_subtrees, jl.cfg.to_json_dict())
    if mode == "tree":
        assert tl.leaf_of_sentence == jl.leaf_of_sentence
    else:
        assert tl.forest.shard_of == jl.forest.shard_of
        assert tl.forest.local_sid == jl.forest.local_sid
    assert (tl.whitener is None) == (not white) == (jl.whitener is None)
    if white:
        for f in WHITENER_FIELDS:
            np.testing.assert_array_equal(getattr(tl.whitener, f),
                                          getattr(jl.whitener, f))
    # the device store holds every row of the file
    emb = tl._emb_device()
    assert emb is not None and tl._store_n == N0 + N_PENDING
    np.testing.assert_array_equal(emb[:N0 + N_PENDING].numpy(),
                                  d.corpus_embs[:N0 + N_PENDING])
    for threshold in (8192, 64):
        np.testing.assert_array_equal(serve(tl, d.query_embs, threshold),
                                      serve(jl, d.query_embs, threshold),
                                      err_msg=f"threshold {threshold}")


@pytest.mark.parametrize("mode", ["tree", "forest"])
def test_loaded_index_serves_like_the_saved_one(data, tmp_path, mode):
    """A port file loaded in the port: every serving attribute set (the
    shared initializer), the whitened bf16 store and its half-norms
    rebuilt from the raw rows as the saved index built them, the same
    ``predict_fast`` and ``predict`` ids once both are flushed, and an
    add on the loaded index served from the pending tier."""
    d = data[0]
    src = build("port", mode, True, data)
    path = str(tmp_path / "index.npz")
    src.save(path)
    tl = CobwebIndex.load(path, device="cpu")
    missing = set(vars(src)) - set(vars(tl))
    assert not missing, missing
    for a, b in zip(tl._wemb_device(), src._wemb_device()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    src._flush_pending()
    for threshold in (8192, 64):
        np.testing.assert_array_equal(serve(tl, d.query_embs, threshold),
                                      serve(src, d.query_embs, threshold))
    assert tl.predict(d.query_embs, k=10, is_embedding=True) == \
        src.predict(d.query_embs, k=10, is_embedding=True)
    extra = d.query_embs[:3] + 0.01
    tl.blocked_threshold = 64
    tl.add_sentences(["x0", "x1", "x2"], extra)
    assert tl._unindexed_count() == 3
    got = tl.predict_fast(extra, k=1, is_embedding=True)
    assert got == [["x0"], ["x1"], ["x2"]]


def test_whitener_pickle_both_ways(data):
    """The JAX whitener's pickle, ``_jax_cache`` filled by a served query,
    loads in the port as its own class with the same arrays and no JAX
    value; the port's pickle loads in the JAX package as the JAX class,
    ``_jax_cache`` empty, and transforms alike; any other name is
    refused."""
    d, jw, tw = data
    jw.transform_jit(d.query_embs[:2])
    assert jw._jax_cache is not None
    got = files.whitener_from_pickle(pickle.dumps(jw))
    assert type(got) is PCAICAWhiteningModel
    assert not hasattr(got, "_jax_cache")
    for f in WHITENER_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(jw, f))
    back = pickle.loads(files.whitener_pickle(tw))
    assert type(back) is JWhitener and back._jax_cache is None
    np.testing.assert_allclose(np.asarray(back.transform_jit(d.query_embs)),
                               np.asarray(jw.transform_jit(d.query_embs)),
                               rtol=0, atol=0)
    assert files.whitener_from_pickle(files.whitener_pickle(tw)).eps == tw.eps
    for bad in (pickle.dumps(print), pickle.dumps(np.load)):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            files.restricted_loads(bad)


def test_jax_whitener_file_loads_without_jax(data, tmp_path):
    """A fresh interpreter loads a whitener-mode forest file the JAX
    package wrote after its whitener served a query, serves it, and has
    imported neither ``jax`` nor ``rag_cobweb_tpu``; its ids are the JAX
    package's from the same file."""
    d = data[0]
    src = build("jax", "forest", True, data)
    assert src.whitener._jax_cache is not None
    path = tmp_path / "jax_whitener.npz"
    src.save(str(path))
    np.save(tmp_path / "q.npy", d.query_embs)
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex\n"
        f"db = CobwebIndex.load({str(path)!r}, device='cpu')\n"
        f"q = np.load({str(tmp_path / 'q.npy')!r})\n"
        "ids = db.predict_fast(q, k=10, return_ids=True, is_embedding=True)\n"
        "mods = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rag_cobweb_tpu')]\n"
        "print(json.dumps({'ids': ids, 'mods': mods}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mods"] == []
    want = JIndex.load(str(path)).predict_fast(d.query_embs, k=10,
                                               return_ids=True,
                                               is_embedding=True)
    assert res["ids"] == want


@pytest.mark.parametrize("lanes", [4, 1], ids=["forest", "tree"])
def test_chip_smoke_query_api_phase_on_the_host(tmp_path, lanes):
    """``chip_smoke.py``'s phase 3f rehearsed on the host at a small size
    (``bench/headline.py`` at c=300, 40 queries, 32-d, whitener mode,
    ``blocked_threshold`` lowered so the fused engine serves, as on the
    card's flagship and single tree): ``query_api`` on a 4-lane forest,
    and on a single tree with tie noise and both schedules
    (``single_tree_api``, pool 64): the loaded copies serve the original's
    ids, the host copy's beam the same ids, the noisy ids the plain
    path-score order, and the restored weights the first serving's."""
    import importlib.util
    from rag_cobweb_tpu_torch.bench import headline, probes
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    zero, read = probes.zero_counters, probes.read_counters
    out = {}

    def hook(event, engine, db, data):
        if event == "start":
            db.blocked_threshold = 64
            return
        q = data.query_embs
        out["fused"] = db._fused is not None    # the fused engine served
        if lanes > 1:
            out["api"] = smoke.query_api(db, data, zero, read, "forest",
                                         tmp_path, card=False)
            return
        qw = db.whitener.transform_torch(torch.as_tensor(q))
        ids0 = to_host(db.query_ids(q, 10, rerank=0))
        served = to_host(db.query_ids(q, 10, rerank=64))
        out.update(smoke.single_tree_api(db, data, qw, ids0, served, zero,
                                         read, tmp_path, pool=64,
                                         card=False))

    headline.run(corpus_size=300, queries=40, dim=32, n_lanes=lanes,
                 rerank=64, device="cpu", hook=hook)
    assert out["fused"]
    api = out["api"]
    assert api["host_hold"]["queries_differing"] == 0
    assert api["beam"]["lanes"] == lanes and api["beam"]["levels"] % 4 == 0
    for name in ("predict", "predict_fast"):
        assert 0 < api[name]["recall@10"] <= 1
    if lanes == 1:
        assert out["tie_noise"]["queries_differing_from_plain"] == 0
        for kind in ("exponential", "linear"):
            r = out[f"schedule {kind}"]
            assert 0 <= r["golds_outside_pool"] <= 40
            assert 0 < r["recall@10"] <= 1
            assert len(r["weights"]) > 1
