"""The labeled classifier of the PyTorch port (``core/classifier.py``) and
``ops/gaussian.node_log_prob_terms`` against the JAX package.

Tolerances: ``node_log_prob_terms`` within 1e-6 relative (the same float32
operations); ``predict_probs`` within 1e-5 absolute on the JAX tree
carried across (``interop.tree_from_numpy``; the two float32 products sum
in another order), with and without the ``max_nodes`` cut, and the same
``predict`` labels.  A classifier built from scratch in both packages has
the same tree slot for slot and the same labels; JSON files load both
ways.  The port also passes the JAX test file's own checks
(``tests/test_classifier.py``): accuracy at least 0.9 on held-out blobs,
rows of ``predict_probs`` summing to 1, ``partial_fit`` and a label added
on the fly."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core.classifier import CobwebClassifier as JClf
from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.ops import gaussian as jgauss
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.classifier import CobwebClassifier
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.ops import gaussian as tgauss

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def blobs():
    """The JAX test's recipe: 4 classes of 30 rows at 12-d, centres at
    scale 4, noise 0.4, shuffled."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(4, 12))
    X, y = [], []
    for ci, c in enumerate(centers):
        X.append(c + 0.4 * rng.normal(size=(30, 12)))
        y += [f"class_{ci}"] * 30
    X = np.concatenate(X).astype(np.float32)
    order = rng.permutation(len(X))
    return X[order], [y[i] for i in order]


@pytest.fixture(scope="module")
def twins(blobs):
    """The same 100 rows fitted by both packages."""
    X, y = blobs
    j = JClf(JCfg(dim=12), capacity=1024, seed=0).fit(X[:100], y[:100])
    t = CobwebClassifier(TreeConfig(dim=12), capacity=1024, seed=0,
                         device="cpu").fit(X[:100], y[:100])
    return j, t


def carried(j: JClf) -> CobwebClassifier:
    """A port classifier over the JAX classifier's tree and labels."""
    st = j.tree._host_arrays()
    tree = interop.tree_from_numpy(
        {f: np.asarray(getattr(st, f)) for f in tree_mod.FIELDS},
        j.cfg.to_json_dict(), device="cpu")
    t = CobwebClassifier.__new__(CobwebClassifier)
    t._setup(tree, j.alpha, j.reverse_labels, j.sentence_labels,
             j.leaf_of_sentence)
    return t


def test_node_log_prob_terms_match_jax():
    rng = np.random.default_rng(2)
    mean = rng.normal(scale=3.0, size=(40, 16)).astype(np.float32)
    var = rng.uniform(0.05, 4.0, size=(40, 16)).astype(np.float32)
    want = jgauss.node_log_prob_terms(jnp.asarray(mean), jnp.asarray(var))
    got = tgauss.node_log_prob_terms(torch.as_tensor(mean),
                                     torch.as_tensor(var))
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("max_nodes", [None, 20, 1])
def test_predict_probs_on_the_carried_tree(twins, blobs, max_nodes):
    X, _ = blobs
    j = twins[0]
    t = carried(j)
    want = j.predict_probs(X[100:], max_nodes)
    got = t.predict_probs(X[100:], max_nodes)
    assert got.shape == want.shape == (20, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert t.predict(X[100:], max_nodes) == j.predict(X[100:], max_nodes)


def test_built_from_scratch_matches_jax(twins, blobs):
    """Same shuffle, same tree slot for slot, same labels."""
    X, _ = blobs
    j, t = twins
    st = j.tree._host_arrays()
    got = t.tree.host_arrays()
    for f in tree_mod.FIELDS:
        a, b = np.asarray(got[f]), np.asarray(getattr(st, f))
        if a.ndim:
            a = a[:len(b)]
        if f in ("means", "m2s"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.leaf_of_sentence == j.leaf_of_sentence
    assert t.sentence_labels == j.sentence_labels
    assert t.reverse_labels == j.reverse_labels
    assert t.predict(X[100:]) == j.predict(X[100:])
    np.testing.assert_allclose(t.predict_probs(X[100:]),
                               j.predict_probs(X[100:]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_loads_both_ways(twins, blobs, writer):
    X, _ = blobs
    j, t = twins
    src = j if writer == "jax" else t
    blob = src.dump_json()
    jl = JClf.load_json(blob)
    tl = CobwebClassifier.load_json(blob, device="cpu")
    assert json.loads(tl.dump_json()) == json.loads(jl.dump_json())
    assert tl.reverse_labels == jl.reverse_labels == src.reverse_labels
    assert tl.leaf_of_sentence == jl.leaf_of_sentence
    assert tl.alpha == jl.alpha == src.alpha
    want = jl.predict_probs(X[100:])
    np.testing.assert_allclose(tl.predict_probs(X[100:]), want, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(src.predict_probs(X[100:]), want, rtol=0,
                               atol=1e-5)
    assert tl.predict(X[100:]) == jl.predict(X[100:])


def test_learns_blobs_and_probs_are_a_simplex(twins, blobs):
    X, y = blobs
    t = twins[1]
    assert t.score(X[100:], y[100:]) >= 0.9
    p = t.predict_probs(X[80:90])
    assert p.shape == (10, 4)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-4)
    assert (p >= 0).all()
    full = t.predict(X[80:100])
    budget = t.predict(X[80:100], max_nodes=20)
    assert np.mean([a == b for a, b in zip(full, budget)]) > 0.8


def test_partial_fit_and_new_labels(blobs):
    X, y = blobs
    clf = CobwebClassifier(TreeConfig(dim=12), capacity=1024, seed=0,
                           device="cpu")
    clf.partial_fit(X[:50], y[:50])
    clf.partial_fit(X[50:100], y[50:100])
    assert clf.score(X[100:], y[100:]) >= 0.9
    assert clf.n_labels == 4
    rng = np.random.default_rng(1)
    X1 = rng.normal(size=(20, 6)).astype(np.float32) + 3
    X2 = rng.normal(size=(20, 6)).astype(np.float32) - 3
    clf = CobwebClassifier(TreeConfig(dim=6), capacity=512, seed=0,
                           device="cpu")
    clf.partial_fit(X1, ["a"] * 20)
    assert clf.n_labels == 1
    clf.partial_fit(X2, ["b"] * 20)
    assert clf.n_labels == 2
    assert clf.predict(X2[:3]) == ["b"] * 3


def test_default_device_is_the_card():
    """Like every entry point of the port, the classifier runs on the card
    unless the caller asks for the host."""
    if torch.cuda.is_available():
        assert CobwebClassifier(TreeConfig(dim=4)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CobwebClassifier(TreeConfig(dim=4))


def test_chip_smoke_classifier_phase_on_the_host():
    """``chip_smoke.py``'s phase 3h (b) rehearsed on the host at a small
    size (4 classes at 12-d, 100 rows fitted, 20 held out): the host copy
    gives the same probabilities and the accuracy clears 0.9."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rec = smoke.classifier_slice(device="cpu", n_classes=4, dim=12,
                                 n_fit=100, n_test=20, max_nodes=20,
                                 card=False)
    assert rec["max_abs_err max_nodes=None"] == 0.0
    assert rec["max_abs_err max_nodes=20"] == 0.0
    assert rec["accuracy max_nodes=None"] >= 0.9
    assert rec["rows"] == 100 and rec["nodes"] > 100
