"""Whitening, datasets, metrics and the exact baseline of the PyTorch port
against the JAX package.  The whitener fit is the same host float64 code
in both packages (identical models); the device transforms agree within
1e-5 (float32 products).  Dataset generators must be byte-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.bench import baselines as jbase
from rag_cobweb_tpu.bench import datasets as jdata
from rag_cobweb_tpu.bench import metrics as jmet
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel as JWhite
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.bench import baselines as tbase
from rag_cobweb_tpu_torch.bench import datasets as tdata
from rag_cobweb_tpu_torch.bench import metrics as tmet
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel as TWhite

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    return jdata.synthetic_retrieval_hard(600, 40, 48, seed=1)


@pytest.fixture(scope="module")
def whiteners(corpus):
    kw = dict(pca_dim=0.9, ica_max_iter=200, seed=0)
    return (JWhite.fit(corpus.corpus_embs, **kw),
            TWhite.fit(corpus.corpus_embs, **kw))


def test_whitener_fit_is_identical(whiteners):
    j, t = whiteners
    assert j.dim_out == t.dim_out
    for f in ("mean", "pca_components", "pca_explained_var", "ica_unmixing"):
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f))


def test_whitener_transforms_agree(whiteners, corpus):
    j, t = whiteners
    x = corpus.query_embs
    np.testing.assert_array_equal(j.transform(x), t.transform(x))
    want = np.asarray(j.transform_jit(jnp.asarray(x)))
    got = t.transform_torch(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, t.transform(x), rtol=1e-5, atol=1e-5)


def test_whitener_pickles_cross_load(whiteners, corpus, tmp_path):
    j, t = whiteners
    x = corpus.query_embs[:5]
    j.save(str(tmp_path / "j.pkl"))
    t.save(str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(
        TWhite.load(str(tmp_path / "j.pkl")).transform(x), j.transform(x))
    np.testing.assert_array_equal(
        JWhite.load(str(tmp_path / "t.pkl")).transform(x), t.transform(x))
    w = interop.whitener_from_numpy(dict(
        mean=j.mean, pca_components=j.pca_components,
        pca_explained_var=j.pca_explained_var, ica_unmixing=j.ica_unmixing,
        eps=j.eps))
    np.testing.assert_array_equal(w.transform(x), j.transform(x))


@pytest.mark.parametrize("gen,args", [
    ("synthetic_retrieval_hard", (500, 30, 24)),
    ("synthetic_retrieval_hard", (300, 300, 16)),   # dup rows > free rows
    ("synthetic_retrieval", (400, 20, 32)),
])
def test_datasets_are_byte_identical(gen, args):
    a = getattr(jdata, gen)(*args, seed=3)
    b = getattr(tdata, gen)(*args, seed=3)
    assert a.name == b.name
    for f in ("corpus_embs", "query_embs", "target_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_retrieval_metrics_match():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 30, size=(200, 20))
    targets = rng.integers(0, 30, size=200)
    assert tmet.retrieval_metrics(ids, targets, 20) == \
        jmet.retrieval_metrics(ids, targets, 20)


def test_evaluate_retrieval_and_flat_index_match(corpus):
    j = jbase.FlatIndex(corpus.corpus_embs, metric="l2")
    t = tbase.FlatIndex(corpus.corpus_embs, metric="l2", device="cpu")
    np.testing.assert_array_equal(t.search(corpus.query_embs, 10),
                                  j.search(corpus.query_embs, 10))
    res = tmet.evaluate_retrieval("flat", t.search_device, corpus.query_embs,
                                  corpus.target_ids, 10, batch_size=16)
    want = jmet.evaluate_retrieval("flat", j.search, corpus.query_embs,
                                   corpus.target_ids, 10, batch_size=16)
    for k in (2, 3, 5, 10):
        assert res[f"recall@{k}"] == want[f"recall@{k}"]
        assert res[f"mrr@{k}"] == pytest.approx(want[f"mrr@{k}"])
    assert res["num_queries"] == len(corpus.query_embs)
    assert res["avg_latency_ms"] > 0 and res["qps"] > 0


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_flat_index_metrics(corpus, metric):
    j = jbase.FlatIndex(corpus.corpus_embs, metric=metric)
    t = tbase.FlatIndex(corpus.corpus_embs, metric=metric, device="cpu")
    np.testing.assert_array_equal(t.search(corpus.query_embs[:8], 5),
                                  j.search(corpus.query_embs[:8], 5))
