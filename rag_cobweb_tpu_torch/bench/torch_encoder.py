"""Transformer encoders on the card (counterpart of
``rag_cobweb_tpu/bench/flax_encoder.py``): the reference's encoder stage
(benchmark_utils.py:218-346, the per-family tokenize and pool
conventions) as a PyTorch forward pass on the device, with the whitening
applied there too, so encode -> whiten -> insert touches the host only
to tokenize.

Four architectures, written here in plain PyTorch because the card's
machine has no ``transformers``, each computing what HF's model of that
architecture computes (``last_hidden_state``, inference, no dropout):

- ``BertEncoderModel``: BERT (word, position and token-type embeddings,
  post-LayerNorm blocks, exact (erf) GELU), and RoBERTa, the same graph
  with positions numbered from ``pad_token_id + 1`` past the pad ids
  (``BertConfig.model_type == "roberta"``);
- ``GPT2EncoderModel``: GPT-2 (token and position embeddings, pre-
  LayerNorm blocks under a causal and a padding mask, tanh GELU, the
  final ``ln_f``);
- ``T5EncoderModel``: T5's encoder stack (RMS LayerNorm, attention with
  no ``1/sqrt(d)`` and a bidirectional relative-position bias shared by
  every block, a ReLU or gated-GELU feed-forward).

Their submodules carry HF's names, so a torch checkpoint's state dict
loads into them (``make_local_hf_encoder``; GPT-2's ``Conv1D`` weights
transposed) and a flax one through ``interop.encoder_from_flax``.

Nothing is downloaded: tests and the card's runs build a randomly
initialised model at given widths (``make_random_encoder``, the published
base widths in ``PUBLISHED``) with the vocabulary-free hash tokenizer of
``training/text_encoder.py``; a model by name needs a locally cached
checkpoint and ``transformers``.
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

# the pooling family of each architecture where the model's name does not
# say (``encoders.MODEL_TYPE_MAPPING`` maps roberta-base to "bert": CLS)
ARCH_FAMILY = {"bert": "bert", "roberta": "bert", "gpt2": "gpt2",
               "t5": "t5"}


class _Widths:
    @classmethod
    def of(cls, cfg):
        """From any object (an HF config) or dict with these names."""
        get = cfg.get if isinstance(cfg, dict) else \
            (lambda k, d: getattr(cfg, k, d))
        return cls(**{f.name: get(f.name, f.default)
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class BertConfig(_Widths):
    """The widths of a BERT or RoBERTa model, under HF ``BertConfig``'s
    names (the defaults are ``bert-base-uncased``'s ``config.json``).
    ``model_type`` "roberta" numbers positions by RoBERTa's rule from
    ``pad_token_id``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    model_type: str = "bert"
    pad_token_id: int = 0


@dataclasses.dataclass
class GPT2Config(_Widths):
    """GPT-2's widths under HF ``GPT2Config``'s names (defaults: ``gpt2``'s
    ``config.json``; ``n_inner`` None is 4 x ``n_embd``)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None
    layer_norm_epsilon: float = 1e-5
    activation_function: str = "gelu_new"
    model_type: str = "gpt2"

    def __post_init__(self):
        if self.activation_function != "gelu_new":
            raise NotImplementedError(
                f"GPT-2 activation {self.activation_function!r}: only "
                "'gelu_new' (tanh GELU) is ported")


@dataclasses.dataclass
class T5Config(_Widths):
    """T5's encoder widths under HF ``T5Config``'s names (defaults:
    ``t5-base``'s ``config.json``).  ``feed_forward_proj``: "relu" (T5) or
    "gated-gelu" (T5 v1.1)."""

    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"
    model_type: str = "t5"

    def __post_init__(self):
        if self.feed_forward_proj not in ("relu", "gated-gelu"):
            raise NotImplementedError(
                f"T5 feed-forward {self.feed_forward_proj!r}: 'relu' and "
                "'gated-gelu' are ported")


CONFIGS = {"bert": BertConfig, "roberta": BertConfig, "gpt2": GPT2Config,
           "t5": T5Config}


def _mask_bias(allowed: torch.Tensor, dtype) -> torch.Tensor:
    """0 where ``allowed``, the dtype's most negative value elsewhere (as
    HF's flax models bias masked keys)."""
    return torch.where(allowed, torch.zeros((), dtype=dtype,
                                            device=allowed.device),
                       torch.full((), torch.finfo(dtype).min, dtype=dtype,
                                  device=allowed.device))


def _attend(q, k, v, bias) -> torch.Tensor:
    """(B, h, L, dh) heads -> (B, L, h * dh): softmax in float32 of
    ``q k^T + bias``."""
    B, h, L, dh = q.shape
    scores = torch.matmul(q, k.transpose(2, 3)) + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, h * dh)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    B, L, d = t.shape
    return t.view(B, L, h, d // h).transpose(1, 2)


# ---------------------------------------------------------------- BERT

class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.roberta = c.model_type == "roberta"
        self.pad = c.pad_token_id

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.roberta:
            # RoBERTa's rule (HF create_position_ids_from_input_ids): each
            # non-pad id numbered from pad + 1, pad ids at pad
            real = (ids != self.pad).long()
            pos = torch.cumsum(real, dim=1) * real + self.pad
        else:
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
        h = self.n_heads
        q = _heads(self.query(x), h) / math.sqrt(x.shape[-1] // h)
        return _attend(q, _heads(self.key(x), h), _heads(self.value(x), h),
                       bias)


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
    """BERT's (or RoBERTa's) ``last_hidden_state`` (no pooler, no
    dropout: inference)."""

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
        bias = _mask_bias(attention_mask[:, None, None, :] > 0, x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


# ---------------------------------------------------------------- GPT-2

class _GPT2Attention(nn.Module):
    """``c_attn`` -> q, k, v; ``c_proj``.  Both are ``nn.Linear`` here,
    weights (out, in): HF's torch ``Conv1D`` stores (in, out), flax's
    ``FlaxConv1D`` kernel (out, in)."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        d = c.n_embd
        self.n_heads = c.n_head
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)

    def forward(self, x, bias):
        h, d = self.n_heads, x.shape[-1]
        q, k, v = self.c_attn(x).split(d, dim=2)
        q = _heads(q, h) / math.sqrt(d // h)
        return self.c_proj(_attend(q, _heads(k, h), _heads(v, h), bias))


class _GPT2MLP(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        inner = c.n_inner or 4 * c.n_embd
        self.c_fc = nn.Linear(c.n_embd, inner)
        self.c_proj = nn.Linear(inner, c.n_embd)

    def forward(self, x):
        # gelu_new: the tanh approximation
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class _GPT2Block(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(c.n_embd, eps=c.layer_norm_epsilon)
        self.attn = _GPT2Attention(c)
        self.ln_2 = nn.LayerNorm(c.n_embd, eps=c.layer_norm_epsilon)
        self.mlp = _GPT2MLP(c)

    def forward(self, x, bias):
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class GPT2EncoderModel(nn.Module):
    """GPT-2's ``last_hidden_state`` (HF ``GPT2Model``; inference)."""

    # the 2-D weights stored (in, out) by HF's torch Conv1D
    CONV1D = ("attn.c_attn.weight", "attn.c_proj.weight",
              "mlp.c_fc.weight", "mlp.c_proj.weight")

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.n_embd)
        self.wpe = nn.Embedding(config.n_positions, config.n_embd)
        self.h = nn.ModuleList([_GPT2Block(config)
                                for _ in range(config.n_layer)])
        self.ln_f = nn.LayerNorm(config.n_embd,
                                 eps=config.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """Positions 0..L-1 (right padding, as ``FlaxGPT2Model`` makes
        them); a key is seen where it is not after the query and not
        masked."""
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()
        bias = _mask_bias(causal[None, None]
                          & (attention_mask[:, None, None, :] > 0), x.dtype)
        for block in self.h:
            x = block(x, bias)
        return self.ln_f(x)


# ---------------------------------------------------------------- T5

class _T5LayerNorm(nn.Module):
    """RMS norm: no mean, no bias, the variance in float32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x / torch.sqrt(var + self.eps)).to(x.dtype)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of ``key - query`` positions: half the
    buckets a sign, half of those exact, the rest log-spaced to
    ``max_distance``."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    rel = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(rel.clamp(min=exact).float() / exact)
                     / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return out + torch.where(rel < exact, rel, large)


class _T5Attention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.n_heads = c.num_heads
        self.q = nn.Linear(c.d_model, inner, bias=False)
        self.k = nn.Linear(c.d_model, inner, bias=False)
        self.v = nn.Linear(c.d_model, inner, bias=False)
        self.o = nn.Linear(inner, c.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                c.relative_attention_num_buckets, c.num_heads)
        self.buckets = c.relative_attention_num_buckets
        self.max_distance = c.relative_attention_max_distance

    def position_bias(self, L: int, device) -> torch.Tensor:
        """(1, heads, L, L) from the bucket of each key - query offset."""
        pos = torch.arange(L, device=device)
        b = relative_position_bucket(pos[None, :] - pos[:, None],
                                     self.buckets, self.max_distance)
        return self.relative_attention_bias(b).permute(2, 0, 1)[None]

    def forward(self, x, bias):
        h = self.n_heads
        return self.o(_attend(_heads(self.q(x), h), _heads(self.k(x), h),
                              _heads(self.v(x), h), bias))


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _T5Attention(c, has_bias)
        self.layer_norm = _T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class _T5DenseReluDense(nn.Module):
    """``wo(relu(wi(x)))``, or gated: ``wo(gelu_new(wi_0(x)) * wi_1(x))``."""

    def __init__(self, c: T5Config):
        super().__init__()
        self.gated = c.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = nn.Linear(c.d_model, c.d_ff, bias=False)
            self.wi_1 = nn.Linear(c.d_model, c.d_ff, bias=False)
        else:
            self.wi = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, x):
        if self.gated:
            return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                           * self.wi_1(x))
        return self.wo(F.relu(self.wi(x)))


class _T5LayerFF(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseReluDense(c)
        self.layer_norm = _T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class _T5Block(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(c, has_bias),
                                    _T5LayerFF(c)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class _T5Stack(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_T5Block(c, i == 0)
                                    for i in range(c.num_layers)])
        self.final_layer_norm = _T5LayerNorm(c.d_model,
                                             c.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """T5's encoder ``last_hidden_state`` (HF ``T5EncoderModel``;
    inference): ``shared`` embeddings, the blocks, ``final_layer_norm``.
    Block 0's relative-position bias, plus the padding mask, is computed
    once and added in every block."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _T5Stack(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids)
        attn0 = self.encoder.block[0].layer[0].SelfAttention
        bias = attn0.position_bias(input_ids.shape[1], x.device).to(x.dtype) \
            + _mask_bias(attention_mask[:, None, None, :] > 0, x.dtype)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


MODELS = {"bert": BertEncoderModel, "roberta": BertEncoderModel,
          "gpt2": GPT2EncoderModel, "t5": T5EncoderModel}


def build_model(config) -> nn.Module:
    """The port's model for a config of any of the four architectures
    (its ``model_type``)."""
    return MODELS[config.model_type](config)


def _t5_init(model: T5EncoderModel, gen: torch.Generator) -> None:
    """HF's T5 initialisation (``T5PreTrainedModel._init_weights``, factor
    1): the embedding N(0, 1), q N(0, (d_model d_kv)^-1/2), k and v
    N(0, d_model^-1/2), o N(0, (heads d_kv)^-1/2), the relative bias
    N(0, d_model^-1/2), wi N(0, d_model^-1/2), wo N(0, d_ff^-1/2)."""
    c = model.config
    std = {"q": (c.d_model * c.d_kv) ** -0.5, "k": c.d_model ** -0.5,
           "v": c.d_model ** -0.5, "o": (c.num_heads * c.d_kv) ** -0.5,
           "relative_attention_bias": c.d_model ** -0.5,
           "wi": c.d_model ** -0.5, "wi_0": c.d_model ** -0.5,
           "wi_1": c.d_model ** -0.5, "wo": c.d_ff ** -0.5}
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, std.get(leaf, 1.0), generator=gen)


def random_model(config, seed: int = 0) -> nn.Module:
    """A model of ``config``'s architecture with HF's initialisation, drawn
    on the host from a ``torch.Generator`` seeded with ``seed`` (the same
    weights on every device): BERT, RoBERTa and GPT-2 Linear and Embedding
    weights N(0, 0.02), biases 0, LayerNorm 1 and 0; T5 as ``_t5_init``."""
    model = build_model(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if config.model_type == "t5":
            _t5_init(model, gen)
            return model
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=gen)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
    return model


def random_bert(config: BertConfig, seed: int = 0) -> BertEncoderModel:
    """A BERT (or RoBERTa) with HF's initialisation (``random_model``)."""
    return random_model(config, seed)


def random_config(arch: str = "bert", hidden_size: int = 64,
                  n_layers: int = 2, n_heads: int = 2,
                  vocab_size: int = 4096, max_length: int = 64,
                  intermediate_size: Optional[int] = None,
                  max_position_embeddings: Optional[int] = None,
                  d_kv: Optional[int] = None,
                  feed_forward_proj: str = "relu"):
    """A config of ``arch`` at the given widths, under each architecture's
    own names.  Defaults: intermediate 4 x hidden; positions
    max(max_length, 64), plus RoBERTa's pad id + 1 (its positions run to
    L + pad); T5's d_kv hidden / heads.  RoBERTa takes roberta-base's
    type_vocab_size 1, eps 1e-5 and pad id 1."""
    ff = intermediate_size or 4 * hidden_size
    positions = max_position_embeddings or max(max_length, 64)
    if arch in ("bert", "roberta"):
        extra = {}
        if arch == "roberta":
            extra = dict(type_vocab_size=1, layer_norm_eps=1e-5,
                         model_type="roberta", pad_token_id=1)
            positions = max_position_embeddings or max(max_length, 64) + 2
        return BertConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                          num_hidden_layers=n_layers,
                          num_attention_heads=n_heads,
                          intermediate_size=ff,
                          max_position_embeddings=positions, **extra)
    if arch == "gpt2":
        return GPT2Config(vocab_size=vocab_size, n_positions=positions,
                          n_embd=hidden_size, n_layer=n_layers,
                          n_head=n_heads, n_inner=ff)
    if arch == "t5":
        return T5Config(vocab_size=vocab_size, d_model=hidden_size,
                        d_kv=d_kv or hidden_size // n_heads, d_ff=ff,
                        num_layers=n_layers, num_heads=n_heads,
                        feed_forward_proj=feed_forward_proj)
    raise NotImplementedError(f"architecture {arch!r} is not ported "
                              f"({', '.join(MODELS)})")


# the published base widths (each name's HF config.json), as
# ``make_random_encoder`` arguments
PUBLISHED = {
    "bert-base-uncased": dict(arch="bert", hidden_size=768, n_layers=12,
                              n_heads=12, intermediate_size=3072,
                              vocab_size=30522,
                              max_position_embeddings=512),
    "roberta-base": dict(arch="roberta", hidden_size=768, n_layers=12,
                         n_heads=12, intermediate_size=3072,
                         vocab_size=50265, max_position_embeddings=514),
    "gpt2": dict(arch="gpt2", hidden_size=768, n_layers=12, n_heads=12,
                 intermediate_size=3072, vocab_size=50257,
                 max_position_embeddings=1024),
    "t5-base": dict(arch="t5", hidden_size=768, n_layers=12, n_heads=12,
                    intermediate_size=3072, vocab_size=32128, d_kv=64,
                    feed_forward_proj="relu"),
}


class TorchEncoder:
    """Sentence encoder on ``device`` with the reference's per-family
    pooling: "bert" pools the CLS token (reference benchmark_utils
    :266-279); every other family mean-pools the last hidden state over
    the real tokens (:281-309), T5 after a "Summarize :" prefix (:311).
    The pooling family is apart from the model's architecture (RoBERTa
    pools as "bert").

    ``tokenizer``: an HF tokenizer; None hashes whitespace words into
    ``vocab_size`` buckets (``hash_tokenize``).  ``whitening``: a fitted
    whitening model whose ``transform_torch`` runs on the pooled
    embeddings on the device.  Each batch is cut to its longest text, so
    padding costs nothing: masked keys weigh exactly 0 (and GPT-2's causal
    mask keeps the real tokens off the padding after them), so the
    embeddings are those of the JAX package's longer length buckets (but
    for a text with no tokens, see ``tokenize``)."""

    def __init__(self, model: nn.Module, tokenizer=None,
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
                        family: Optional[str] = None, seed: int = 0,
                        whitening=None, device="cuda",
                        intermediate_size: Optional[int] = None,
                        max_position_embeddings: Optional[int] = None,
                        arch: str = "bert", d_kv: Optional[int] = None,
                        feed_forward_proj: str = "relu") -> TorchEncoder:
    """A randomly initialised model of ``arch`` ("bert", "roberta", "gpt2"
    or "t5"; ``random_config`` maps the widths to its names) and the hash
    tokenizer (counterpart of ``make_random_flax_encoder``, whose BERT
    widths it defaults to).  ``family``: the pooling, by default the
    architecture's (``ARCH_FAMILY``).  ``make_random_encoder(
    **PUBLISHED["gpt2"])`` builds a published base width."""
    cfg = random_config(arch, hidden_size, n_layers, n_heads, vocab_size,
                        max_length, intermediate_size,
                        max_position_embeddings, d_kv, feed_forward_proj)
    return TorchEncoder(random_model(cfg, seed), None,
                        family=family or ARCH_FAMILY[arch],
                        max_length=max_length, batch_size=batch_size,
                        vocab_size=vocab_size, whitening=whitening,
                        device=device)


def state_dict_from_hf(model: nn.Module, hf_state: dict) -> dict:
    """The entries of an HF torch model's state dict that ``model`` (the
    port's model of the same architecture) holds, GPT-2's ``Conv1D``
    weights (stored (in, out)) transposed to ``nn.Linear``'s (out, in);
    T5's tied ``encoder.embed_tokens`` and any buffer HF keeps are
    dropped."""
    own = model.state_dict()
    conv = getattr(model, "CONV1D", ())
    out = {}
    for k, v in hf_state.items():
        if k not in own:
            continue
        out[k] = v.t() if k.endswith(conv) else v
    missing = sorted(set(own) - set(out))
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:4]}")
    return out


def make_local_hf_encoder(name_or_path: str, max_length: int = 128,
                          batch_size: int = 256, whitening=None,
                          device="cuda") -> TorchEncoder:
    """A locally cached checkpoint (weights and tokenizer, read with
    ``transformers``, nothing downloaded) of a BERT, RoBERTa, GPT-2 or T5
    (its encoder) in the port's model of that architecture (counterpart of
    ``make_flax_hf_encoder``).  Another architecture raises
    ``NotImplementedError`` naming it.

    The tokenizer is the checkpoint's own (GPT-2's gets ``pad_token =
    eos_token``, as ``flax_encoder.py`` gives it).  The pooling family is
    the name's (``encoders.infer_model_type``, as ``make_flax_hf_encoder``
    picks it), but where that falls back to "bert", the architecture's
    (``ARCH_FAMILY``: a GPT-2 or T5 checkpoint whose name says nothing
    mean-pools)."""
    import transformers

    hf_cfg = transformers.AutoConfig.from_pretrained(
        name_or_path, local_files_only=True)
    arch = hf_cfg.model_type
    if arch not in MODELS:
        raise NotImplementedError(
            f"{name_or_path}: the {arch!r} architecture is not ported "
            f"(ported: {', '.join(MODELS)})")
    model = build_model(CONFIGS[arch].of(hf_cfg))
    loader = (transformers.T5EncoderModel if arch == "t5"
              else transformers.AutoModel)
    hf = loader.from_pretrained(name_or_path, local_files_only=True)
    with torch.no_grad():
        model.load_state_dict(state_dict_from_hf(model, hf.state_dict()))
    tok = transformers.AutoTokenizer.from_pretrained(
        name_or_path, local_files_only=True)
    if arch == "gpt2" and tok.pad_token is None:
        tok.pad_token = tok.eos_token
    family = infer_model_type(name_or_path)
    if family == "bert":
        family = ARCH_FAMILY[arch]
    return TorchEncoder(model, tok, family=family, max_length=max_length,
                        batch_size=batch_size, whitening=whitening,
                        device=device)


def encode_whiten_insert(encoder: TorchEncoder, db, texts) -> list:
    """The ingest pipeline: encode (and whiten) on the device, insert
    into ``db`` (a ``CobwebIndex``); returns what ``add_sentences``
    returns (leaf slots of a single tree, global ids of a forest)."""
    embs = encoder.encode_device(texts)
    return db.add_sentences(list(texts), embs.cpu().numpy())
