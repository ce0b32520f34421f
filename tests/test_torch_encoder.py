"""The port's BERT encoder (``bench/torch_encoder.py``) against the JAX
package's flax encoder (``bench/flax_encoder.py``) on the CPU.

A randomly initialised ``FlaxBertModel`` (hidden 48, 2 layers, 4 heads)
is carried into ``BertEncoderModel`` by ``interop.bert_encoder_from_flax``;
both encoders then embed the same texts with the hash tokenizer.
Tolerance: rtol 1e-4 / atol 1e-5 (float32 forward passes of 2 layers; the
port cuts each batch to its longest text, the JAX package pads to 32-token
buckets and to its batch size, which moves only the order of float32
sums).  Whitened embeddings likewise, the whitening fused on the device
or applied after; the Cobweb trees built from them serve the same
``predict`` answers as the JAX package's."""

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from rag_cobweb_tpu.bench import flax_encoder as jenc  # noqa: E402
from rag_cobweb_tpu.bench.datasets import load_sample_corpuses  # noqa: E402
from rag_cobweb_tpu.core.config import TreeConfig as JCfg  # noqa: E402
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex  # noqa: E402
from rag_cobweb_tpu.whitening import models as jmodels  # noqa: E402
from rag_cobweb_tpu_torch import interop  # noqa: E402
from rag_cobweb_tpu_torch.bench import torch_encoder as tenc  # noqa: E402
from rag_cobweb_tpu_torch.core import index as index_mod  # noqa: E402
from rag_cobweb_tpu_torch.core.config import TreeConfig  # noqa: E402
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex  # noqa: E402
from rag_cobweb_tpu_torch.whitening import models as tmodels  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
VOCAB, MAXLEN, H = 512, 40, 48


def texts():
    c = load_sample_corpuses()
    out = [t for v in c.values() for t in v]
    # a long text (cut at MAXLEN words) and an empty one
    return out + [" ".join(out[:6]), ""]


@pytest.fixture(scope="module")
def models():
    if not jenc.flax_transformers_available():
        pytest.skip("flax transformers unavailable")
    fe = jenc.make_random_flax_encoder(hidden_size=H, n_layers=2, n_heads=4,
                                       vocab_size=VOCAB, max_length=MAXLEN,
                                       batch_size=16)
    params = jax.tree_util.tree_map(np.asarray, fe.model.params)
    return fe, interop.bert_encoder_from_flax(params, fe.model.config,
                                              device="cpu")


def port(model, family="bert", batch_size=16, whitening=None):
    return tenc.TorchEncoder(model, None, family=family, max_length=MAXLEN,
                             batch_size=batch_size, vocab_size=VOCAB,
                             whitening=whitening, device="cpu")


@pytest.mark.parametrize("family", ["bert", "mean", "t5"])
@pytest.mark.parametrize("batch_size", [128, 16, 3])
def test_embeddings_equal_the_flax_encoder(models, family, batch_size):
    """CLS pooling ("bert"), masked mean pooling (any other family; T5
    with its prefix), in one batch and in several with padding."""
    fe, model = models
    want = jenc.FlaxEncoder(fe.model, None, family=family,
                            max_length=MAXLEN, batch_size=16,
                            vocab_size=VOCAB)(texts())
    got = port(model, family, batch_size)(texts())
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["pcaica", "zca"])
def test_fused_whitening_equals_whitening_after(models, kind):
    fe, model = models
    raw = port(model)(texts())
    # fitted on the embeddings plus noise of their own scale, so that no
    # direction's variance is small and the whitening's gain stays ~1
    # (a tolerance in the raw space then holds in the whitened one)
    fit = np.concatenate([raw, raw + raw.std() * np.random.default_rng(0)
                          .standard_normal(raw.shape).astype(np.float32)])
    if kind == "zca":
        tw, jw = tmodels.ZCAWhiteningModel.fit(fit), \
            jmodels.ZCAWhiteningModel.fit(fit)
    else:
        tw = tmodels.PCAICAWhiteningModel.fit(fit, pca_dim=16, seed=0)
        jw = jmodels.PCAICAWhiteningModel.fit(fit, pca_dim=16, seed=0)
    fused = port(model, whitening=tw, batch_size=7)(texts())
    after = tw.transform(raw)
    scale = np.abs(after).max()
    np.testing.assert_allclose(fused, after, rtol=RTOL, atol=ATOL * scale)
    want = jenc.FlaxEncoder(fe.model, None, max_length=MAXLEN,
                            batch_size=16, vocab_size=VOCAB,
                            whitening=jw)(texts())
    np.testing.assert_allclose(fused, want, rtol=RTOL, atol=ATOL * scale)


def test_encode_whiten_insert_then_predict_equals_the_jax_package(models):
    fe, model = models
    enc = port(model)
    T = texts()[:-1]
    jdb = JIndex(config=JCfg(dim=H), encode_func=fe)
    jenc.encode_whiten_insert(fe, jdb, T)
    db = CobwebIndex(config=TreeConfig(dim=H), encode_func=enc,
                     device="cpu")
    leaves = tenc.encode_whiten_insert(enc, db, T)
    assert len(leaves) == len(T) and db.sentences == T
    assert db.tree.signature() is not None
    for t in T:
        assert db.predict(t, k=1) == jdb.predict(t, k=1) == [t]
    # top 3: equal wherever the port's beam keys of places 1-4 hold no
    # near tie (within 1e-5 of the largest: a random BERT embeds every
    # text alike, so leaf log-probs ~68 part by ~1e-4; a third of the
    # texts have such a tie)
    e = torch.as_tensor(enc(T))
    bidx = db._beam_index()
    keys, _ = index_mod.beam_pack_topk(
        bidx, e, 4, beam_width=64,
        max_depth=-(-max(db.max_depth, 1) // 4) * 4)
    k4 = keys[:, :4].numpy()
    tied = (np.abs(np.diff(k4, axis=1))
            <= 1e-5 * np.abs(k4).max(1, keepdims=True)).any(1)
    assert (~tied).sum() >= len(T) // 2
    for i in np.nonzero(~tied)[0]:
        assert db.predict(T[i], k=3) == jdb.predict(T[i], k=3), i


def test_random_encoder_is_seeded_and_refuses_the_host_by_default():
    kw = dict(hidden_size=32, n_layers=1, n_heads=2, vocab_size=VOCAB,
              max_length=MAXLEN)
    a = tenc.make_random_encoder(**kw, seed=3, device="cpu")
    b = tenc.make_random_encoder(**kw, seed=3, device="cpu")
    c = tenc.make_random_encoder(**kw, seed=4, device="cpu")
    x = a(texts()[:5])
    np.testing.assert_array_equal(x, b(texts()[:5]))
    assert not np.allclose(x, c(texts()[:5]))
    assert a.model.config.intermediate_size == 128
    assert a.model.config.max_position_embeddings == 64
    dev = tenc.make_random_encoder(**kw, seed=3, device="cpu")
    assert dev.encode_device(texts()[:2]).shape == (2, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tenc.make_random_encoder(**kw)


def _hf_checkpoint(tmp_path, name="bert"):
    """A random torch BERT checkpoint and a word-piece vocabulary saved to
    ``tmp_path / name``: a locally cached model, nothing fetched."""
    import transformers as tf
    words = sorted({w for t in texts() for w in t.lower().replace(
        ".", " ").replace(",", " ").split()})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","] + words
    d = tmp_path / name
    d.mkdir(parents=True)
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    kw = dict(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64)
    torch.manual_seed(0)
    model = tf.BertModel(tf.BertConfig(**kw))
    tf.BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    model.save_pretrained(str(d))
    return str(d), model


def test_local_hf_checkpoint_equals_transformers(tmp_path):
    path, hf = _hf_checkpoint(tmp_path)
    enc = tenc.make_local_hf_encoder(path, max_length=MAXLEN, batch_size=5,
                                     device="cpu")
    T = texts()[:12]
    got = enc(T)
    tok = enc.tokenizer(T, padding=True, truncation=True, max_length=MAXLEN,
                        return_tensors="pt")
    with torch.no_grad():
        want = hf.eval()(**tok).last_hidden_state[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sentence_transformer_checkpoint_is_mean_pooled_as_flax_pools_it(
        tmp_path):
    """A BERT checkpoint under a ``sentence-transformers/...`` path, a name
    the model table does not hold, pools as ``make_flax_hf_encoder`` pools
    it (``infer_model_type``: masked mean), not by the architecture's CLS:
    the port's embeddings equal ``FlaxEncoder``'s on the same flax
    weights and tokenizer."""
    import transformers as tf
    from rag_cobweb_tpu.bench.encoders import infer_model_type
    path, hf = _hf_checkpoint(tmp_path,
                              "sentence-transformers/all-MiniLM-L6-v2")
    enc = tenc.make_local_hf_encoder(path, max_length=MAXLEN, batch_size=5,
                                     device="cpu")
    family = infer_model_type(path)
    assert enc.family == family == "sentence_transformer"
    T = texts()[:12]
    got = enc(T)
    flax = tf.FlaxBertModel.from_pretrained(path, from_pt=True)
    want = jenc.FlaxEncoder(flax, enc.tokenizer, family=family,
                            max_length=MAXLEN, batch_size=5)(T)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    tok = enc.tokenizer(T, padding=True, truncation=True, max_length=MAXLEN,
                        return_tensors="pt")
    with torch.no_grad():
        cls = hf.eval()(**tok).last_hidden_state[:, 0].numpy()
    assert not np.allclose(got, cls, rtol=RTOL, atol=ATOL)


def test_other_architectures_are_refused_by_name(tmp_path):
    """BERT, RoBERTa, GPT-2 and T5 are ported; a checkpoint of any other
    architecture (here MPNet) is refused by name before its weights are
    read."""
    import transformers as tf
    d = tmp_path / "mpnet"
    tf.MPNetConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=2,
                   intermediate_size=64).save_pretrained(str(d))
    with pytest.raises(NotImplementedError, match="mpnet"):
        tenc.make_local_hf_encoder(str(d), device="cpu")
