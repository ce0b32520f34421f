"""The port's RoBERTa, GPT-2 and T5 encoders (``bench/torch_encoder.py``)
against HF's flax and torch models on the CPU.

Randomly initialised flax models (2 layers, 32 wide, 4 heads) are carried
into the port by ``interop.encoder_from_flax``; both then embed the same
texts with the hash tokenizer.  The reference is each flax model called
through its own ``__call__`` (which numbers positions by the
architecture's rule), tokenized, bucketed and pooled as the JAX package's
``FlaxEncoder`` does; for T5 it is ``FlaxEncoder`` itself.  Tolerance:
rtol 1e-4 / atol 1e-5, as for BERT (``tests/test_torch_encoder.py``):
float32 forward passes of 2 layers, summed in another order.

Two faults of ``FlaxEncoder`` (``rag_cobweb_tpu/bench/flax_encoder.py:
69-72``, ``model.module.apply`` without ``position_ids``) are shown: its
GPT-2 raises ``TypeError``, and its RoBERTa numbers positions 0..L-1
where RoBERTa's rule numbers them from the pad id + 1; the port computes
the models' own result."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import transformers as tf  # noqa: E402

from rag_cobweb_tpu.bench import flax_encoder as jenc  # noqa: E402
from rag_cobweb_tpu.core.config import TreeConfig as JCfg  # noqa: E402
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex  # noqa: E402
from rag_cobweb_tpu.whitening import models as jmodels  # noqa: E402
from rag_cobweb_tpu_torch import interop  # noqa: E402
from rag_cobweb_tpu_torch.bench import torch_encoder as tenc  # noqa: E402
from rag_cobweb_tpu_torch.core import index as index_mod  # noqa: E402
from rag_cobweb_tpu_torch.core.config import TreeConfig  # noqa: E402
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex  # noqa: E402
from rag_cobweb_tpu_torch.whitening import models as tmodels  # noqa: E402

from test_torch_encoder import texts  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
VOCAB, MAXLEN, H = 512, 40, 32
ARCHS = ["roberta", "gpt2", "t5-relu", "t5-gated"]


def flax_config(arch):
    """A small HF config of ``arch``; RoBERTa's positions reach
    MAXLEN + pad + 1."""
    if arch == "roberta":
        return tf.RobertaConfig(
            vocab_size=VOCAB, hidden_size=H, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=MAXLEN + 2, type_vocab_size=1,
            layer_norm_eps=1e-5)
    if arch == "gpt2":
        return tf.GPT2Config(vocab_size=VOCAB, n_embd=H, n_layer=2,
                             n_head=4, n_positions=64)
    return tf.T5Config(vocab_size=VOCAB, d_model=H, d_kv=8, d_ff=64,
                       num_layers=2, num_heads=4,
                       feed_forward_proj=("gated-gelu" if arch == "t5-gated"
                                          else "relu"))


FAMILY = {"roberta": "bert", "gpt2": "gpt2", "t5-relu": "t5",
          "t5-gated": "t5"}


def flax_model(arch):
    cfg = flax_config(arch)
    cls = {"roberta": tf.FlaxRobertaModel, "gpt2": tf.FlaxGPT2Model}.get(
        arch, tf.FlaxT5EncoderModel)
    return cls(cfg, seed=0)


def reference(model, family, whitening=None, batch_size=16):
    """``FlaxEncoder`` with its forward through the model's ``__call__``:
    its tokenizing, length buckets, batch padding and pooling, the
    model's own positions (T5: ``FlaxEncoder`` as it is)."""
    fe = jenc.FlaxEncoder(model, None, family=family, max_length=MAXLEN,
                          batch_size=batch_size, vocab_size=VOCAB,
                          whitening=whitening)
    if model.config.model_type == "t5":
        return fe

    def fwd(params, ids, mask):
        h = model(input_ids=ids, attention_mask=mask,
                  params=params).last_hidden_state
        if family == "bert":
            emb = h[:, 0]
        else:
            m = mask[..., None].astype(h.dtype)
            emb = (h * m).sum(1) / jnp.maximum(m.sum(1), 1.0)
        emb = emb.astype(jnp.float32)
        return emb if whitening is None else whitening.transform_jit(emb)

    fe._fwd = jax.jit(fwd)
    return fe


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    arch = request.param
    model = flax_model(arch)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    port = interop.encoder_from_flax(params, model.config, device="cpu")
    return arch, model, port


def port(model, family, batch_size=16, whitening=None):
    return tenc.TorchEncoder(model, None, family=family, max_length=MAXLEN,
                             batch_size=batch_size, vocab_size=VOCAB,
                             whitening=whitening, device="cpu")


@pytest.mark.parametrize("batch_size", [128, 3])
def test_embeddings_equal_the_flax_model(carried, batch_size):
    """The pooled embeddings of every family (RoBERTa CLS, GPT-2 and T5
    masked means) in one batch and in several, with a long and an empty
    text."""
    arch, model, pmodel = carried
    family = FAMILY[arch]
    want = reference(model, family)(texts())
    got = port(pmodel, family, batch_size)(texts())
    assert got.dtype == np.float32 and got.shape == want.shape == \
        (len(texts()), H)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("kind", ["pcaica", "zca"])
def test_fused_whitening_equals_whitening_after(carried, kind):
    arch, model, pmodel = carried
    family = FAMILY[arch]
    raw = port(pmodel, family)(texts())
    fit = np.concatenate([raw, raw + raw.std() * np.random.default_rng(0)
                          .standard_normal(raw.shape).astype(np.float32)])
    if kind == "zca":
        tw, jw = tmodels.ZCAWhiteningModel.fit(fit), \
            jmodels.ZCAWhiteningModel.fit(fit)
    else:
        tw = tmodels.PCAICAWhiteningModel.fit(fit, pca_dim=12, seed=0)
        jw = jmodels.PCAICAWhiteningModel.fit(fit, pca_dim=12, seed=0)
    fused = port(pmodel, family, batch_size=7, whitening=tw)(texts())
    after = tw.transform(raw)
    scale = np.abs(after).max()
    np.testing.assert_allclose(fused, after, rtol=RTOL, atol=ATOL * scale)
    want = reference(model, family, whitening=jw)(texts())
    np.testing.assert_allclose(fused, want, rtol=RTOL, atol=ATOL * scale)


class _Encoded:
    """The ``encode_device`` contract over precomputed embeddings."""

    def __init__(self, fe):
        self.fe = fe

    def encode_device(self, T):
        return self.fe(T)

    def __call__(self, T):
        return self.fe(T)


def test_encode_whiten_insert_then_predict_equals_the_jax_package(carried):
    """Both packages' single trees over each family's embeddings: the JAX
    package's on the flax model's, the port's through its own
    ``encode_whiten_insert``.  Every text finds itself first in both; the
    top 3 are equal wherever the port's beam keys of places 1-4 hold no
    near tie (a random model embeds texts alike)."""
    arch, model, pmodel = carried
    family = FAMILY[arch]
    T = texts()[:-1]
    fe = reference(model, family)
    jdb = JIndex(config=JCfg(dim=H), encode_func=fe)
    jenc.encode_whiten_insert(_Encoded(fe), jdb, T)
    enc = port(pmodel, family)
    db = CobwebIndex(config=TreeConfig(dim=H), encode_func=enc,
                     device="cpu")
    leaves = tenc.encode_whiten_insert(enc, db, T)
    assert len(leaves) == len(T) and db.sentences == T
    for t in T:
        assert db.predict(t, k=1) == jdb.predict(t, k=1) == [t]
    e = torch.as_tensor(enc(T))
    keys, _ = index_mod.beam_pack_topk(
        db._beam_index(), e, 4, beam_width=64,
        max_depth=-(-max(db.max_depth, 1) // 4) * 4)
    k4 = keys[:, :4].numpy()
    tied = (np.abs(np.diff(k4, axis=1))
            <= 1e-5 * np.abs(k4).max(1, keepdims=True)).any(1)
    assert (~tied).sum() >= len(T) // 3
    for i in np.nonzero(~tied)[0]:
        assert db.predict(T[i], k=3) == jdb.predict(T[i], k=3), i


# ------------------------------------------------- the reference's faults

def test_flax_encoder_gpt2_raises_where_the_port_encodes():
    """``FlaxEncoder`` calls ``module.apply`` without ``position_ids``,
    which ``FlaxGPT2Module`` requires."""
    model = flax_model("gpt2")
    with pytest.raises(TypeError, match="position_ids"):
        jenc.FlaxEncoder(model, None, family="gpt2", max_length=MAXLEN,
                         batch_size=16, vocab_size=VOCAB)(texts()[:4])
    pmodel = interop.encoder_from_flax(
        jax.tree_util.tree_map(np.asarray, model.params), model.config,
        device="cpu")
    got = port(pmodel, "gpt2")(texts()[:4])
    assert np.isfinite(got).all() and got.shape == (4, H)


def test_flax_encoder_roberta_positions_differ_from_the_model():
    """Through ``module.apply`` RoBERTa falls back to positions 0..L-1;
    ``FlaxRobertaModel.__call__`` (and HF's torch ``RobertaModel``) number
    them from the pad id + 1.  The port equals the latter."""
    model = flax_model("roberta")
    pmodel = interop.encoder_from_flax(
        jax.tree_util.tree_map(np.asarray, model.params), model.config,
        device="cpu")
    T = texts()[:12]
    faulty = jenc.FlaxEncoder(model, None, family="bert", max_length=MAXLEN,
                              batch_size=16, vocab_size=VOCAB)(T)
    right = reference(model, "bert")(T)
    got = port(pmodel, "bert")(T)
    assert np.abs(faulty - right).max() > 1e-2
    np.testing.assert_allclose(got, right, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- the weight layouts

def test_weight_layouts_of_each_carry():
    """A flax ``Dense`` kernel (in, out) lands transposed in the port's
    ``nn.Linear`` (out, in); GPT-2's ``FlaxConv1D`` kernel (out, in) as it
    is; HF's torch ``Conv1D`` weight (in, out) transposed
    (``state_dict_from_hf``)."""
    rob, gpt = flax_model("roberta"), flax_model("gpt2")
    t5 = flax_model("t5-relu")
    as_np = lambda m: jax.tree_util.tree_map(np.asarray, m.params)  # noqa
    r = interop.encoder_from_flax(as_np(rob), rob.config, device="cpu")
    k = rob.params["encoder"]["layer"]["0"]["intermediate"]["dense"]["kernel"]
    assert k.shape == (H, 64)
    np.testing.assert_array_equal(
        r.encoder.layer[0].intermediate.dense.weight.detach().numpy(), np.asarray(k).T)
    g = interop.encoder_from_flax(as_np(gpt), gpt.config, device="cpu")
    k = gpt.params["h"]["0"]["mlp"]["c_fc"]["kernel"]
    assert k.shape == (4 * H, H)
    np.testing.assert_array_equal(g.h[0].mlp.c_fc.weight.detach().numpy(),
                                  np.asarray(k))
    t = interop.encoder_from_flax(as_np(t5), t5.config, device="cpu")
    k = t5.params["encoder"]["block"]["0"]["layer"]["1"]["DenseReluDense"][
        "wi"]["kernel"]
    np.testing.assert_array_equal(
        t.encoder.block[0].layer[1].DenseReluDense.wi.weight.detach().numpy(),
        np.asarray(k).T)
    torch.manual_seed(0)
    hf = tf.GPT2Model(flax_config("gpt2"))
    w = hf.h[0].mlp.c_fc.weight
    assert tuple(w.shape) == (H, 4 * H)
    sd = tenc.state_dict_from_hf(g, hf.state_dict())
    assert torch.equal(sd["h.0.mlp.c_fc.weight"], w.t())
    assert torch.equal(sd["h.0.attn.c_attn.weight"],
                       hf.h[0].attn.c_attn.weight.t())


# ------------------------------------------------- HF torch checkpoints

def _bpe_files(d, specials):
    """A byte-level BPE vocabulary of single bytes (no merges)."""
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode
    vocab = {s: i for i, s in enumerate(specials)}
    for ch in bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return len(vocab)


def _checkpoint(tmp_path, arch):
    """A random HF torch model of ``arch`` saved with its tokenizer (T5:
    none; its test serves it with the hash tokenizer)."""
    d = tmp_path / arch
    d.mkdir()
    torch.manual_seed(0)
    if arch == "roberta":
        n = _bpe_files(d, ["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
        tf.RobertaTokenizer(str(d / "vocab.json"), str(d / "merges.txt")) \
            .save_pretrained(str(d))
        cfg = flax_config("roberta")
        cfg.vocab_size = n
        model = tf.RobertaModel(cfg, add_pooling_layer=False)
    elif arch == "gpt2":
        n = _bpe_files(d, ["<|endoftext|>"])
        tf.GPT2Tokenizer(str(d / "vocab.json"), str(d / "merges.txt")) \
            .save_pretrained(str(d))
        cfg = flax_config("gpt2")
        cfg.vocab_size = n
        model = tf.GPT2Model(cfg)
    else:
        model = tf.T5EncoderModel(flax_config(arch))
    model.save_pretrained(str(d))
    return str(d), model.eval()


@pytest.mark.parametrize("arch", ARCHS)
def test_local_hf_checkpoint_equals_transformers(tmp_path, arch,
                                                 monkeypatch):
    """``save_pretrained`` -> ``make_local_hf_encoder``: the port's pooled
    embeddings equal HF's torch model's on the same tokens (GPT-2's
    ``Conv1D`` weights transposed; its tokenizer padded with its eos
    token; RoBERTa's pads numbered by its rule).  T5 has no sentencepiece
    file here: its tokenizer is None, so the hash tokenizer serves it."""
    path, hf = _checkpoint(tmp_path, arch)
    if arch.startswith("t5"):
        monkeypatch.setattr(tf.AutoTokenizer, "from_pretrained",
                            lambda *a, **k: None)
    enc = tenc.make_local_hf_encoder(path, max_length=MAXLEN, batch_size=5,
                                     device="cpu")
    assert enc.family == FAMILY[arch]
    T = texts()[:12]
    got = enc(T)
    ids, mask = enc.tokenize(T)
    if arch == "gpt2":
        assert enc.tokenizer.pad_token == enc.tokenizer.eos_token
    with torch.no_grad():
        h = hf(input_ids=torch.as_tensor(ids),
               attention_mask=torch.as_tensor(mask)).last_hidden_state
    if FAMILY[arch] == "bert":
        want = h[:, 0].numpy()
    else:
        m = torch.as_tensor(mask)[..., None]
        want = ((h * m).sum(1) / m.sum(1).clamp(min=1)).numpy()
    # the batches of 5 are cut to their own longest text
    for s in range(0, len(T), 5):
        part = enc(T[s:s + 5])
        np.testing.assert_allclose(part, got[s:s + 5], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tenc.make_local_hf_encoder(path)


def test_published_base_widths():
    """``PUBLISHED``: the HF ``config.json`` widths of roberta-base, gpt2
    and t5-base (and bert-base-uncased) under each architecture's names."""
    cfg = {n: tenc.random_config(**{k: v for k, v in kw.items()})
           for n, kw in tenc.PUBLISHED.items()}
    r = cfg["roberta-base"]
    assert (r.vocab_size, r.hidden_size, r.num_hidden_layers,
            r.num_attention_heads, r.intermediate_size,
            r.max_position_embeddings, r.type_vocab_size, r.layer_norm_eps,
            r.pad_token_id, r.model_type) == (
        50265, 768, 12, 12, 3072, 514, 1, 1e-5, 1, "roberta")
    g = cfg["gpt2"]
    assert (g.vocab_size, g.n_embd, g.n_layer, g.n_head, g.n_positions,
            g.n_inner or 4 * g.n_embd, g.layer_norm_epsilon) == (
        50257, 768, 12, 12, 1024, 3072, 1e-5)
    t = cfg["t5-base"]
    assert (t.vocab_size, t.d_model, t.d_kv, t.d_ff, t.num_layers,
            t.num_heads, t.feed_forward_proj,
            t.relative_attention_num_buckets,
            t.relative_attention_max_distance, t.layer_norm_epsilon) == (
        32128, 768, 64, 3072, 12, 12, "relu", 32, 128, 1e-6)
    b = cfg["bert-base-uncased"]
    assert (b.vocab_size, b.max_position_embeddings, b.model_type) == (
        30522, 512, "bert")
    with pytest.raises(NotImplementedError, match="xlnet"):
        tenc.random_config("xlnet")


@pytest.mark.parametrize("arch", ["roberta", "gpt2", "t5"])
def test_random_encoders_are_seeded_and_refuse_the_host_by_default(arch):
    kw = dict(hidden_size=32, n_layers=1, n_heads=2, vocab_size=VOCAB,
              max_length=MAXLEN, arch=arch)
    a = tenc.make_random_encoder(**kw, seed=3, device="cpu")
    b = tenc.make_random_encoder(**kw, seed=3, device="cpu")
    c = tenc.make_random_encoder(**kw, seed=4, device="cpu")
    assert a.family == tenc.ARCH_FAMILY[arch]
    assert a.model.config.model_type == arch
    x = a(texts()[:5])
    np.testing.assert_array_equal(x, b(texts()[:5]))
    assert not np.allclose(x, c(texts()[:5]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tenc.make_random_encoder(**kw)


def test_phase_3l_families_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 3l (a) on the host at small widths (2
    layers, 32 wide) and sizes: each family into a 4-lane forest served by
    the fused engine (the thresholds lowered here, as at the card's 10000
    rows), its gates and ``probes.plain_check``."""
    import importlib.util
    from pathlib import Path

    from rag_cobweb_tpu_torch.bench import probes
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent /
        "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    setup = CobwebIndex._setup

    def small_setup(self, *a, **k):
        setup(self, *a, **k)
        self.blocked_threshold = 0

    monkeypatch.setattr(CobwebIndex, "_setup", small_setup)
    monkeypatch.setattr(CobwebIndex, "rerank_threshold", 0)
    small = {name: dict(kw, hidden_size=32, n_layers=2, n_heads=2,
                        intermediate_size=64, vocab_size=4096,
                        max_position_embeddings=None)
             for name, kw in tenc.PUBLISHED.items()}
    fams = cs.families_phase(probes.zero_counters, probes.read_counters,
                             "host", tmp_path, device="cpu", widths=small,
                             n_corpus=500, n_queries=40, max_length=32,
                             n_hold=8, n_lanes=4)
    assert list(fams) == ["roberta-base", "gpt2", "t5-base"]
    for name, e in fams.items():
        assert e["widths"]["arch"] == tenc.PUBLISHED[name]["arch"]
        assert e["plain"]["queries_differing_from_plain"] == 0
        assert e["hold_max_abs_err"] == 0.0       # host against host
