"""The port's query trainers against the JAX package's, on the host
(``device="cpu"``): the projection head and ``CobwebQueryTrainer``, and the
end-to-end text encoder (``hash_tokenize``, its layers, ``TinyTextEncoder``,
``EndToEndQueryTrainer``).

The flax parameters are carried into the port's modules, then both
packages take the same batches.  Tolerances: losses 1e-5 relative a step
and parameters ``atol=1e-5, rtol=1e-4`` after five steps.  Both run the
same float32 arithmetic in another order (XLA's sums and products
against torch's), ~1e-7 relative a value; the losses are sums over a
few hundred terms of that, and Adam's steps of lr x m / sqrt(v) carry
the gradients' relative rounding into each update, so the parameters
part at ~lr x 1e-5 after five steps, well inside the tolerance.  Sizes
are small: a 16-d, 80-row single tree; a 1-layer, 16-wide encoder."""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex
from rag_cobweb_tpu.training import query_train as jqt
from rag_cobweb_tpu.training import text_encoder as jte
from rag_cobweb_tpu_torch import interop
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.training import flax_layout
from rag_cobweb_tpu_torch.training.query_train import (CobwebQueryTrainer,
                                                       epoch_order)
from rag_cobweb_tpu_torch.training.text_encoder import (EndToEndQueryTrainer,
                                                        hash_tokenize)

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
KEY_BIAS = "['key']['bias']"


def assert_same_params(port_tree, jax_tree, skip=(), **tol):
    """Two flax parameter trees leaf for leaf (same keys, shapes, values
    within ``tol``), but the leaves whose path ends in one of ``skip``."""
    tol = tol or PARAM_TOL
    a = jax.tree_util.tree_leaves_with_path(port_tree)
    b = jax.tree_util.tree_leaves_with_path(jax.device_get(jax_tree))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        name = jax.tree_util.keystr(path)
        if not name.endswith(tuple(skip)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       err_msg=name, **tol)


@pytest.fixture(scope="module")
def corpus():
    """The JAX package's training fixture: 80 rows in 8 clusters, 16-d,
    queries in a rotated space, one single tree in each package."""
    rng = np.random.default_rng(4)
    centers = rng.normal(scale=3.0, size=(8, 16))
    docs = np.concatenate(
        [c + 0.2 * rng.normal(size=(10, 16)) for c in centers]
    ).astype(np.float32)
    jdb = JIndex(corpus=None, corpus_embeddings=docs, config=JCfg(dim=16))
    tdb = CobwebIndex(corpus_embeddings=docs, config=TreeConfig(dim=16),
                      device="cpu")
    rng = np.random.default_rng(5)
    R = np.linalg.qr(rng.normal(size=(16, 16)))[0].astype(np.float32)
    gold = rng.choice(len(docs), size=48, replace=False)
    queries = (docs[gold] @ R + 0.05 * rng.normal(size=(48, 16))).astype(
        np.float32)
    return jdb, tdb, queries, gold


def carried_trainers(corpus, hidden=64, lr=1e-3):
    jdb, tdb, _, _ = corpus
    jtr = jqt.CobwebQueryTrainer(jdb, in_dim=16, hidden_dim=hidden, lr=lr,
                                 seed=0)
    ttr = CobwebQueryTrainer(tdb, in_dim=16, hidden_dim=hidden, lr=lr,
                             seed=0)
    flax_layout.load_flax(ttr.head, jax.device_get(jtr.state.params))
    return jtr, ttr


def test_rank_scores_index_matches(corpus):
    """The trainers' logits: both packages' rank scores of the same
    queries within 1e-5 of their magnitude (the two single trees are the
    same tree, ``tests/test_torch_single_tree.py``)."""
    jdb, tdb, queries, _ = corpus
    from rag_cobweb_tpu.core import index as jindex
    from rag_cobweb_tpu_torch.core import index as tindex
    want = np.asarray(jindex.rank_scores(jdb.build_prediction_index(),
                                         jnp.asarray(queries)))
    got = tindex.rank_scores(tdb.build_prediction_index(),
                             torch.as_tensor(queries)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_projection_head_forward_on_carried_weights():
    head = jqt.ProjectionHead(out_dim=12, hidden_dim=32)
    params = head.init(jax.random.PRNGKey(3), jnp.zeros((1, 20)))
    x = np.random.default_rng(0).normal(size=(7, 20)).astype(np.float32)
    want = np.asarray(head.apply(params, jnp.asarray(x)))
    port = interop.projection_head_from_flax(jax.device_get(params),
                                             device="cpu")
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_query_trainer_steps_match_jax(corpus):
    """Five AdamW steps (lr 1e-3) on the same batches: the losses within
    1e-5 relative at each step, the head's parameters after them within
    atol 1e-5, rtol 1e-4."""
    _, _, queries, gold = corpus
    jtr, ttr = carried_trainers(corpus)
    rng = np.random.default_rng(0)
    order = np.concatenate([epoch_order(rng, len(queries), 16)
                            for _ in range(2)])
    for s in range(5):
        sel = order[16 * s:16 * s + 16]
        jtr.state, jl = jtr.train_step(jtr.state, jnp.asarray(queries[sel]),
                                       jnp.asarray(gold[sel]))
        tl = float(ttr.train_step(queries[sel], gold[sel]))
        np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {s}")
    assert_same_params(flax_layout.to_flax(ttr.head), jtr.state.params)


def test_query_trainer_fit_and_evaluate_match_jax(corpus):
    """``fit`` draws the JAX package's batches (``np.resize`` of a
    permutation): three epochs of per-epoch losses within 1e-5; then
    ``evaluate`` (an ``np.argsort`` of the host scores) gives the same
    ranks."""
    _, _, queries, gold = corpus
    jtr, ttr = carried_trainers(corpus)
    want = jtr.fit(queries[:40], gold[:40], epochs=3, batch_size=16, seed=7)
    got = ttr.fit(queries[:40], gold[:40], epochs=3, batch_size=16, seed=7)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_same_params(flax_layout.to_flax(ttr.head), jtr.state.params)
    assert ttr.evaluate(queries, gold) == jtr.evaluate(queries, gold)
    np.testing.assert_allclose(ttr.project(queries), jtr.project(queries),
                               rtol=1e-4, atol=1e-5)


def test_query_trainer_pickles_cross_load(corpus, tmp_path):
    """The port writes the JAX pickle layout and reads the JAX package's;
    each package's ``load_params`` reads the other's file."""
    jdb, tdb, queries, _ = corpus
    jtr = jqt.CobwebQueryTrainer(jdb, in_dim=16, hidden_dim=32, seed=1)
    ttr = CobwebQueryTrainer(tdb, in_dim=16, hidden_dim=32, seed=2)
    jtr.save(str(tmp_path / "jax.pkl"))
    ttr.save(str(tmp_path / "port.pkl"))
    jtr2 = jqt.CobwebQueryTrainer(jdb, in_dim=16, hidden_dim=32, seed=3)
    jtr2.load_params(str(tmp_path / "port.pkl"))
    np.testing.assert_allclose(jtr2.project(queries), ttr.project(queries),
                               rtol=1e-5, atol=1e-6)
    ttr.load_params(str(tmp_path / "jax.pkl"))
    np.testing.assert_allclose(ttr.project(queries), jtr.project(queries),
                               rtol=1e-5, atol=1e-6)


def test_jax_pickle_loads_without_jax(corpus, tmp_path):
    """A JAX-written trainer pickle loads in a fresh interpreter that
    never imports ``jax`` or the JAX package."""
    jdb, _, _, _ = corpus
    jtr = jqt.CobwebQueryTrainer(jdb, in_dim=16, hidden_dim=32, seed=1)
    path = tmp_path / "jax.pkl"
    jtr.save(str(path))
    code = (
        "import sys\n"
        "from rag_cobweb_tpu_torch import interop\n"
        "from rag_cobweb_tpu_torch.files import read_pickle\n"
        f"blob = read_pickle({str(path)!r})\n"
        "head = interop.projection_head_from_flax(blob['params'], 'cpu')\n"
        "assert head.Dense_0.weight.shape == (32, 16)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'rag_cobweb_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_empty_query_set_raises_in_the_port(corpus):
    """Reference fault: the JAX ``fit`` raises ``IndexError`` on an empty
    query set; the port raises ``ValueError`` before any step."""
    jdb, tdb, _, _ = corpus
    empty_q, empty_g = np.zeros((0, 16), np.float32), np.zeros(0, np.int64)
    jtr = jqt.CobwebQueryTrainer(jdb, in_dim=16, hidden_dim=32)
    with pytest.raises(IndexError):
        jtr.fit(empty_q, empty_g, epochs=1)
    ttr = CobwebQueryTrainer(tdb, in_dim=16, hidden_dim=32)
    with pytest.raises(ValueError, match="empty"):
        ttr.fit(empty_q, empty_g, epochs=1)
    assert ttr.step == 0


def test_trainers_refuse_a_forest_index():
    """Reference fault: given a forest (``n_subtrees > 1``), the JAX
    trainers build a stacked index that ``rank_scores`` cannot take and
    fail inside the first step (``ValueError: Incompatible shapes``); the
    port's refuse the forest when they are made."""
    rng = np.random.default_rng(9)
    docs = rng.normal(size=(64, 8)).astype(np.float32)
    jdb = JIndex(corpus=None, corpus_embeddings=docs, config=JCfg(dim=8),
                 n_subtrees=4)
    jtr = jqt.CobwebQueryTrainer(jdb, in_dim=8, hidden_dim=16)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jtr.train_step(jtr.state, jnp.asarray(docs[:4]),
                       jnp.arange(4, dtype=jnp.int32))
    tdb = CobwebIndex(corpus_embeddings=docs, config=TreeConfig(dim=8),
                      n_subtrees=4, device="cpu")
    with pytest.raises(ValueError, match="single-tree"):
        CobwebQueryTrainer(tdb, in_dim=8, hidden_dim=16)
    with pytest.raises(ValueError, match="single-tree"):
        EndToEndQueryTrainer(tdb, vocab_size=64, d_model=8, n_layers=1,
                             max_len=4, hidden_dim=16)


# ---------------------------------------------------------------------------
# the text encoder
# ---------------------------------------------------------------------------

TEXTS = ["find cluster3 item5", "", "The QUICK brown fox  jumps",
         " ".join(f"w{i}" for i in range(40)), "cluster0 item0 corpus entry",
         "   "]


def test_hash_tokenize_ids_equal():
    for vocab, L in ((8192, 32), (64, 5)):
        got = hash_tokenize(TEXTS, vocab, L)
        want = jte.hash_tokenize(TEXTS, vocab, L)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_layer_norm_epsilon_is_flax():
    """flax ``LayerNorm`` divides by sqrt(var + 1e-6) (torch's default is
    1e-5): on rows of variance ~1e-5 the two part by ~40%."""
    x = (1e-3 * np.random.default_rng(1).normal(size=(5, 16))).astype(
        np.float32)
    ln = fnn.LayerNorm()
    want = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0), x), x))
    with torch.no_grad():
        got = flax_layout.layer_norm(16)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = flax_layout.gelu(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_attention_matches_flax_with_an_empty_row():
    """The attention against flax ``MultiHeadDotProductAttention`` on
    carried weights, a row with no key unmasked among the batch: flax
    attends uniformly there (no NaN), and so does the port."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 6, 16)).astype(np.float32)
    mask = np.ones((3, 6), np.float32)
    mask[1] = 0.0
    mask[2, 4:] = 0.0
    mha = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=16)
    m = jnp.asarray(mask)[:, None, None, :] > 0
    params = mha.init(jax.random.PRNGKey(0), x, x, mask=m)
    want = np.asarray(mha.apply(params, x, x, mask=m))
    att = flax_layout.Attention(16, 4, torch.Generator().manual_seed(0))
    flax_layout.load_flax(att, jax.device_get(params))
    with torch.no_grad():
        got = att(torch.as_tensor(x), torch.as_tensor(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert_same_params(flax_layout.to_flax(att), params, atol=0, rtol=0)


def test_text_encoder_forward_on_carried_weights():
    """``TinyTextEncoder`` (2 layers) on the JAX encoder's weights, an
    empty text among the texts: the pooled embeddings within 1e-5."""
    enc = jte.TinyTextEncoder(vocab_size=256, d_model=16, n_layers=2,
                              max_len=8)
    ids, mask = jte.hash_tokenize(TEXTS, 256, 8)
    params = enc.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                      jnp.asarray(mask))
    want = np.asarray(enc.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    port = interop.text_encoder_from_flax(jax.device_get(params),
                                          device="cpu")
    with torch.no_grad():
        got = port(torch.as_tensor(ids, dtype=torch.int64),
                   torch.as_tensor(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert_same_params(flax_layout.to_flax(port), params, atol=0, rtol=0)


@pytest.fixture(scope="module")
def text_corpus():
    """The JAX package's end-to-end fixture: 64 rows in 8 clusters, each
    row's text naming its cluster and item; some query texts empty."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(8, 16))
    xs = np.concatenate(
        [c + 0.15 * rng.normal(size=(8, 16)) for c in centers]
    ).astype(np.float32)
    texts = [f"cluster{r // 8} item{r % 8} corpus entry"
             for r in range(len(xs))]
    q_texts = [f"find cluster{r // 8} item{r % 8}" if r % 9 else ""
               for r in range(len(xs))]
    jdb = JIndex(corpus=texts, corpus_embeddings=xs)
    tdb = CobwebIndex(corpus=texts, corpus_embeddings=xs, device="cpu")
    return jdb, tdb, q_texts, np.arange(len(xs))


E2E = dict(vocab_size=256, d_model=16, n_layers=1, max_len=8,
           hidden_dim=32, lr=2e-3, seed=0)


def carried_e2e(text_corpus):
    jdb, tdb, _, _ = text_corpus
    jtr = jte.EndToEndQueryTrainer(jdb, **E2E)
    ttr = EndToEndQueryTrainer(tdb, **E2E)
    flax_layout.load_flax(ttr.encoder, jax.device_get(jtr.state.enc_params))
    flax_layout.load_flax(ttr.head, jax.device_get(jtr.state.head_params))
    return jtr, ttr


def test_e2e_trainer_steps_match_jax(text_corpus):
    """Five steps through encoder, head and rank scores on the same token
    batches: loss and the encoder's global gradient norm within 1e-5
    relative at each step, every parameter within atol 1e-5, rtol 1e-4
    after them, but the attention's key bias.  Its gradient is 0 in exact
    arithmetic (a bias on every key adds one constant to a query's logits,
    which the softmax cancels), so both packages' gradients there are
    rounding noise that Adam scales up to steps of ~lr: that bias is held
    instead to its gradient being noise against the query bias's and to
    having moved less than lr a step."""
    _, _, q_texts, gold = text_corpus
    jtr, ttr = carried_e2e(text_corpus)
    jtr0 = jax.device_get(jtr.state.enc_params)
    ids, mask = hash_tokenize(q_texts, 256, 8)
    order = epoch_order(np.random.default_rng(0), len(gold), 16)
    order = np.concatenate([order, order[::-1]])
    for s in range(5):
        sel = order[16 * s:16 * s + 16]
        jtr.state, jl, jg = jtr.train_step(
            jtr.state, jnp.asarray(ids[sel]), jnp.asarray(mask[sel]),
            jnp.asarray(gold[sel].astype(np.int32)))
        tl, tg = ttr.train_step(ids[sel], mask[sel], gold[sel])
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"loss, step {s}")
        np.testing.assert_allclose(float(tg), float(jg), rtol=LOSS_RTOL,
                                   err_msg=f"grad norm, step {s}")
        assert float(tg) > 0
        att = ttr.encoder.EncoderBlock_0.MultiHeadDotProductAttention_0
        assert (att.key.bias.grad.abs().max()
                <= 1e-5 * att.query.bias.grad.abs().max())
    assert_same_params(flax_layout.to_flax(ttr.encoder), jtr.state.enc_params,
                       skip=(KEY_BIAS,))
    kb0 = jax.device_get(jtr0["params"]["EncoderBlock_0"][
        "MultiHeadDotProductAttention_0"]["key"]["bias"])
    for tree in (flax_layout.to_flax(ttr.encoder), jtr.state.enc_params):
        kb = np.asarray(tree["params"]["EncoderBlock_0"][
            "MultiHeadDotProductAttention_0"]["key"]["bias"])
        assert np.abs(kb - kb0).max() <= 5 * E2E["lr"] * 1.01
    assert_same_params(flax_layout.to_flax(ttr.head), jtr.state.head_params)


def test_e2e_trainer_fit_and_evaluate_match_jax(text_corpus):
    """``fit``'s per-epoch losses and gradient norms over the JAX
    package's batches within 1e-5 relative; ``encode`` within 1e-4
    and ``evaluate`` the same ranks after them."""
    _, _, q_texts, gold = text_corpus
    jtr, ttr = carried_e2e(text_corpus)
    want = jtr.fit(q_texts, gold, epochs=2, batch_size=16, seed=3)
    got = ttr.fit(q_texts, gold, epochs=2, batch_size=16, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ttr.encode(q_texts), jtr.encode(q_texts),
                               rtol=1e-4, atol=1e-5)
    assert ttr.evaluate(q_texts, gold) == jtr.evaluate(q_texts, gold)


def test_e2e_pickles_cross_load(text_corpus, tmp_path):
    """The port's ``save`` writes the JAX package's keys and flax trees
    (the JAX trainer has no loader: its tree structure and shapes are
    held), and the port's ``load_params`` reads a JAX-written file."""
    import pickle
    jdb, tdb, q_texts, _ = text_corpus
    jtr = jte.EndToEndQueryTrainer(jdb, **E2E)
    ttr = EndToEndQueryTrainer(tdb, **dict(E2E, seed=5))
    jtr.save(str(tmp_path / "jax.pkl"))
    ttr.save(str(tmp_path / "port.pkl"))
    with open(tmp_path / "jax.pkl", "rb") as f:
        jblob = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        tblob = pickle.load(f)
    assert tblob.keys() == jblob.keys()
    assert tblob["temperature"] == jblob["temperature"]
    for key in ("enc_params", "head_params"):
        assert (jax.tree.map(np.shape, tblob[key])
                == jax.tree.map(np.shape, jblob[key]))
    ttr.load_params(str(tmp_path / "jax.pkl"))
    np.testing.assert_allclose(ttr.encode(q_texts), jtr.encode(q_texts),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# fresh parameters: flax's initialisers' distributions
# ---------------------------------------------------------------------------

def test_fresh_parameters_follow_flax_initialisers():
    """The port's fresh encoder against flax's own init of the same
    shapes: Dense kernels a normal truncated at 2 standard deviations of
    variance 1/fan_in (std within 5%, nothing past the truncation), zero
    biases, ``Embed`` N(0, 1/d), ``pos`` N(0, 0.02^2), LayerNorm ones and
    zeros.  The same distributions, not the same values."""
    from rag_cobweb_tpu_torch.training.text_encoder import TinyTextEncoder
    d, V, L = 64, 2048, 32
    enc = jte.TinyTextEncoder(vocab_size=V, d_model=d, n_layers=1,
                              max_len=L)
    jp = jax.device_get(enc.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, L), jnp.int32),
                                 jnp.ones((1, L))))
    tp = flax_layout.to_flax(TinyTextEncoder(
        V, d, 1, L, gen=torch.Generator().manual_seed(0)))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tp))
    for path, w in jax.tree_util.tree_leaves_with_path(jp):
        t, name = flat_t[path], jax.tree_util.keystr(path)
        assert t.shape == w.shape, name
        if name.endswith("['bias']") or name.endswith("['scale']"):
            np.testing.assert_array_equal(t, w, err_msg=name)
            continue
        assert not np.array_equal(t, w), name
        np.testing.assert_allclose(t.std(), w.std(), rtol=0.05, err_msg=name)
        assert abs(t.mean()) < 4 * w.std() / np.sqrt(t.size), name
        if name.endswith("['kernel']"):
            # the attention's out kernel is (heads, head_dim, d)
            fan_in = w.shape[0] * (w.shape[1] if "['out']" in name else 1)
            bound = 2.0 / math.sqrt(fan_in) / 0.87962566103423978
            np.testing.assert_allclose(w.std(), 1 / math.sqrt(fan_in),
                                       rtol=0.05, err_msg=name)
            assert np.abs(t).max() <= bound * (1 + 1e-6), name
    np.testing.assert_allclose(tp["params"]["pos"].std(), 0.02, rtol=0.05)
    np.testing.assert_allclose(tp["params"]["Embed_0"]["embedding"].std(),
                               1 / math.sqrt(d), rtol=0.05)


@pytest.mark.parametrize("kind", ["query", "e2e"])
def test_train_steps_hold_a_host_copy(kind, corpus, text_corpus):
    """``bench/train_steps.hold``, the card-versus-host check of phase 3i,
    on two host trainers in lockstep: a copy passes, every metric,
    gradient and parameter equal; a copy whose steps run on a head weight
    moved by 1e-3 fails on its metrics."""
    from rag_cobweb_tpu_torch.bench import train_steps
    if kind == "query":
        _, tdb, queries, gold = corpus
        a = CobwebQueryTrainer(tdb, in_dim=16, hidden_dim=32, lr=1e-3)
        steps = train_steps.query_steps(queries, gold, n=5)
    else:
        _, tdb, q_texts, gold = text_corpus
        a = EndToEndQueryTrainer(tdb, **E2E)
        steps = train_steps.e2e_steps(q_texts, gold, 256, 8, n=5)
    rec = train_steps.hold(a, train_steps.host_copy(a, tdb), steps)
    assert rec["ok"] and rec["worst_metric_rel"] == 0.0, rec["fails"]
    assert rec["worst_grad_rel"] == 0.0 and rec["worst_param_excess"] <= 0
    assert rec["unsettled"] < rec["entries"]

    class Perturbed(type(a)):
        """Its steps run on a head weight moved by 1e-3."""

        def train_step(self, *args):
            with torch.no_grad():
                self.head.Dense_0.weight[0, 0] += 1e-3
            return super().train_step(*args)

    b = train_steps.host_copy(a, tdb)
    b.__class__ = Perturbed
    bad = train_steps.hold(a, b, steps)
    assert not bad["ok"]
    assert "metric" in {f[0] for f in bad["fails"]}


def test_phase_3i_rehearsal(tmp_path):
    """``chip_smoke.py``'s phase 3i on the host at a small size: a
    whitener-mode single tree of 400 rows (PCA+ICA, as phase 3c's), its
    queries and gold rows; all four trainers held against their host
    copies over 5 steps, then trained, with the phase's checks (the
    whiteners at their defaults on 4000 768-d rows of their own: 15 steps
    an epoch)."""
    import chip_smoke
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    data = synthetic_retrieval_hard(400, 120, 48, seed=3)
    w = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.96, seed=0)
    db = CobwebIndex(corpus_embeddings=data.corpus_embs, whitener=w,
                     device="cpu")
    rows = synthetic_retrieval_hard(4000, 10, 768, seed=4).corpus_embs
    rec = chip_smoke.training_slice(db, data, tmp_path / "train", "host",
                                    device="cpu", reps=2, rows=rows)
    for name in ("query", "e2e", "vicreg", "factorvae"):
        assert rec[name]["hold"]["ok"] and rec[name]["ms_per_step"] > 0
        assert rec[name]["hold"]["worst_metric_rel"] == 0.0
    assert rec["e2e"]["empty_texts"] == 12
    texts = chip_smoke.query_texts(db, data.target_ids)
    assert texts == chip_smoke.query_texts(db, data.target_ids)
    assert f"row{data.target_ids[0]}" in texts[0].split()
    chip_smoke.log_training(rec)
