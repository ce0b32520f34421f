"""BERT encoder on the card (counterpart of
``rag_cobweb_tpu/bench/flax_encoder.py``): the reference's encoder stage
(benchmark_utils.py:218-346, the per-family tokenize and pool
conventions) as a PyTorch forward pass on the device, with the whitening
applied there too, so encode -> whiten -> insert touches the host only
to tokenize.

``BertEncoderModel`` is the BERT architecture that ``FlaxBertModel`` (and
HF's torch ``BertModel``) computes, written here in plain PyTorch because
the card's machine has no ``transformers``: word, position and token-type
embeddings, then post-LayerNorm blocks of self-attention with an additive
mask, the output dense, LayerNorm, the intermediate dense with exact
(erf) GELU, the output dense and LayerNorm.  Its submodules carry HF's
names, so a torch BERT checkpoint's state dict loads into it as it is
(``make_local_hf_encoder``) and a flax one through
``interop.bert_encoder_from_flax``.

Nothing is downloaded: tests and the card's runs build a randomly
initialised model at given widths (``make_random_encoder``) with the
vocabulary-free hash tokenizer of ``training/text_encoder.py``; a model
by name needs a locally cached BERT checkpoint and ``transformers``.
Other families (RoBERTa, T5, GPT-2) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rag_cobweb_tpu_torch.bench.encoders import infer_model_type
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.training.text_encoder import hash_tokenize


@dataclasses.dataclass
class BertConfig:
    """The widths of a BERT model, under HF ``BertConfig``'s names (the
    defaults are ``bert-base-uncased``'s ``config.json``)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def of(cls, cfg) -> "BertConfig":
        """From any object (an HF ``BertConfig``) or dict with these
        names."""
        get = cfg.get if isinstance(cfg, dict) else \
            (lambda k, d: getattr(cfg, k, d))
        return cls(**{f.name: get(f.name, f.default)
                      for f in dataclasses.fields(cls)})


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.word_embeddings(ids) + self.position_embeddings(pos) \
            + self.token_type_embeddings.weight[0]
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        d = c.hidden_size
        self.n_heads = c.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, d = x.shape
        h = self.n_heads

        def heads(t):
            return t.view(B, L, h, d // h).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(d // h)
        scores = torch.matmul(q, heads(self.key(x)).transpose(2, 3)) + bias
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, heads(self.value(x)))
        return ctx.transpose(1, 2).reshape(B, L, d)


class _DenseNorm(nn.Module):
    """Dense, then LayerNorm of its output plus the residual (HF's
    ``BertSelfOutput`` and ``BertOutput``)."""

    def __init__(self, n_in: int, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(n_in, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor):
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseNorm(c.hidden_size, c)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))      # exact (erf) GELU


class _Layer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Intermediate(c)
        self.output = _DenseNorm(c.intermediate_size, c)

    def forward(self, x, bias):
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            [_Layer(c) for _ in range(c.num_hidden_layers)])


class BertEncoderModel(nn.Module):
    """BERT's ``last_hidden_state`` (no pooler, no dropout: inference)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids and 0/1 mask -> (B, L, H).  Masked keys get
        the dtype's most negative value as their bias, as flax's BERT
        gives them, so a row with no tokens attends uniformly."""
        x = self.embeddings(input_ids)
        neg = torch.finfo(x.dtype).min
        bias = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.zeros((), dtype=x.dtype, device=x.device),
                           torch.full((), neg, dtype=x.dtype,
                                      device=x.device))
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


def random_bert(config: BertConfig, seed: int = 0) -> BertEncoderModel:
    """A BERT with HF's initialisation (Linear and Embedding weights
    N(0, 0.02), biases 0, LayerNorm 1 and 0), drawn on the host from a
    ``torch.Generator`` seeded with ``seed``: the same weights on every
    device."""
    model = BertEncoderModel(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=gen)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
    return model


class TorchEncoder:
    """Sentence encoder on ``device`` with the reference's per-family
    pooling: "bert" pools the CLS token (reference benchmark_utils
    :266-279); every other family mean-pools the last hidden state over
    the real tokens (:281-309), T5 after a "Summarize :" prefix (:311).

    ``tokenizer``: an HF tokenizer; None hashes whitespace words into
    ``vocab_size`` buckets (``hash_tokenize``).  ``whitening``: a fitted
    whitening model whose ``transform_torch`` runs on the pooled
    embeddings on the device.  Each batch is cut to its longest text, so
    padding costs nothing: masked keys weigh exactly 0, so the embeddings
    are those of the JAX package's longer length buckets (but for a text
    with no tokens, see ``tokenize``)."""

    def __init__(self, model: BertEncoderModel, tokenizer=None,
                 family: str = "bert", max_length: int = 128,
                 batch_size: int = 256, vocab_size: Optional[int] = None,
                 whitening=None, device="cuda"):
        self.device = resolve_device(device)
        full_f32_matmul()
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.family = family
        self.max_length = max_length
        self.batch_size = batch_size
        self.whitening = whitening
        self.vocab_size = vocab_size or model.config.vocab_size

    def tokenize(self, texts):
        """(ids int64, mask float32) numpy, each row cut to the batch's
        longest text."""
        texts = [str(t) for t in texts]
        if self.family == "t5":
            texts = ["Summarize :" + t for t in texts]
        if self.tokenizer is not None:
            enc = self.tokenizer(texts, padding=True, truncation=True,
                                 max_length=self.max_length,
                                 return_tensors="np")
            ids = enc["input_ids"].astype(np.int64)
            mask = enc["attention_mask"].astype(np.float32)
        else:
            ids, mask = hash_tokenize(texts, vocab_size=self.vocab_size,
                                      max_len=self.max_length)
        n = mask.sum(1)
        if len(n) and n.min() > 0:
            L = int(n.max())
        else:
            # a text with no tokens attends uniformly over the padding, so
            # its embedding depends on the width: the JAX package's
            # (the tokenizer's, rounded up to a multiple of 32)
            L = min(self.max_length, -(-max(ids.shape[1], 1) // 32) * 32)
            pad = ((0, 0), (0, max(L - ids.shape[1], 0)))
            ids, mask = np.pad(ids, pad), np.pad(mask, pad)
        return ids[:, :L].astype(np.int64), mask[:, :L]

    @torch.no_grad()
    def _pool(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.model(ids, mask)
        if self.family == "bert":
            emb = h[:, 0]
        else:
            m = mask.unsqueeze(-1).to(h.dtype)
            emb = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
        emb = emb.float()
        if self.whitening is not None:
            emb = self.whitening.transform_torch(emb)
        return emb

    def encode_device(self, texts) -> torch.Tensor:
        """(texts, H or the whitened width) embeddings, left on the
        device (no host sync)."""
        outs = []
        for s in range(0, len(texts), self.batch_size):
            ids, mask = self.tokenize(texts[s:s + self.batch_size])
            outs.append(self._pool(
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device)))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def __call__(self, texts) -> np.ndarray:
        """The ``encode_func`` contract of ``bench/encoders.py``: float32
        numpy out."""
        return self.encode_device(texts).cpu().numpy().astype(np.float32)


def make_random_encoder(hidden_size: int = 64, n_layers: int = 2,
                        n_heads: int = 2, vocab_size: int = 4096,
                        max_length: int = 64, batch_size: int = 64,
                        family: str = "bert", seed: int = 0,
                        whitening=None, device="cuda",
                        intermediate_size: Optional[int] = None,
                        max_position_embeddings: Optional[int] = None
                        ) -> TorchEncoder:
    """A randomly initialised BERT and the hash tokenizer (counterpart of
    ``make_random_flax_encoder``, whose widths it defaults to: intermediate
    4 x hidden, max(max_length, 64) positions)."""
    cfg = BertConfig(
        vocab_size=vocab_size, hidden_size=hidden_size,
        num_hidden_layers=n_layers, num_attention_heads=n_heads,
        intermediate_size=intermediate_size or 4 * hidden_size,
        max_position_embeddings=(max_position_embeddings
                                 or max(max_length, 64)))
    return TorchEncoder(random_bert(cfg, seed), None, family=family,
                        max_length=max_length, batch_size=batch_size,
                        vocab_size=vocab_size, whitening=whitening,
                        device=device)


def make_local_hf_encoder(name_or_path: str, max_length: int = 128,
                          batch_size: int = 256, whitening=None,
                          device="cuda") -> TorchEncoder:
    """A locally cached BERT checkpoint (weights and tokenizer, read with
    ``transformers``, nothing downloaded) in ``BertEncoderModel``
    (counterpart of ``make_flax_hf_encoder``).  Another architecture
    raises ``NotImplementedError`` naming it."""
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    hf_cfg = AutoConfig.from_pretrained(name_or_path, local_files_only=True)
    if hf_cfg.model_type != "bert":
        raise NotImplementedError(
            f"{name_or_path}: the {hf_cfg.model_type!r} architecture is not "
            "ported (BERT only; RoBERTa, T5 and GPT-2 are still to port)")
    model = BertEncoderModel(BertConfig.of(hf_cfg))
    hf = AutoModel.from_pretrained(name_or_path, local_files_only=True)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in hf.state_dict().items()
                           if k in own})
    tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
    return TorchEncoder(model, tok, family=infer_model_type(name_or_path),
                        max_length=max_length, batch_size=batch_size,
                        whitening=whitening, device=device)


def encode_whiten_insert(encoder: TorchEncoder, db, texts) -> list:
    """The ingest pipeline: encode (and whiten) on the device, insert
    into ``db`` (a ``CobwebIndex``); returns what ``add_sentences``
    returns (leaf slots of a single tree, global ids of a forest)."""
    embs = encoder.encode_device(texts)
    return db.add_sentences(list(texts), embs.cpu().numpy())
