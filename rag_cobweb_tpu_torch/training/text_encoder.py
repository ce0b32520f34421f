"""End-to-end query-encoder fine-tuning (port of
``rag_cobweb_tpu/training/text_encoder.py``): a small transformer text
encoder (hash-token embeddings, self-attention blocks, masked mean-pool)
in front of the projection head, both trained through the differentiable
Cobweb rank scores of a single tree.

The layers follow flax's, not torch's defaults: LayerNorm epsilon 1e-6,
the tanh GELU, attention with masked keys at the dtype's most negative
value (so a text with no words attends uniformly instead of giving NaN)
and mean-pooling over ``max(words, 1)``.  ``fit_dp`` is data parallel
as ``query_train``'s is; the encoder's gradient norm it reports is taken
after the gradients are averaged over the ranks, the global batch's.
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.device import full_f32_matmul
from rag_cobweb_tpu_torch.files import read_pickle
from rag_cobweb_tpu_torch.training.flax_layout import (Attention, dense,
                                                       embed, gelu,
                                                       layer_norm,
                                                       load_flax, to_flax)
from rag_cobweb_tpu_torch.training.query_train import (ADAMW_WEIGHT_DECAY,
                                                       ProjectionHead,
                                                       dp_group, dp_reduce,
                                                       dp_rows, epoch_order,
                                                       rank_loss, ranks_of,
                                                       single_tree_index)


def hash_tokenize(texts, vocab_size: int = 8192, max_len: int = 32):
    """Deterministic vocabulary-free tokenizer: whitespace words hashed into
    ``vocab_size`` buckets (id 0 reserved for padding).  Returns
    (ids (B, L) int32, mask (B, L) float32)."""
    B = len(texts)
    ids = np.zeros((B, max_len), np.int32)
    mask = np.zeros((B, max_len), np.float32)
    for b, t in enumerate(texts):
        words = str(t).lower().split()[:max_len]
        for i, w in enumerate(words):
            h = int.from_bytes(
                hashlib.md5(w.encode()).digest()[:4], "little"
            )
            ids[b, i] = 1 + h % (vocab_size - 1)
            mask[b, i] = 1.0
    return ids, mask


class EncoderBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + MLP(LN(x)) (4x, GELU)."""

    def __init__(self, d_model: int, n_heads: int = 4,
                 gen: "torch.Generator | None" = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.LayerNorm_0 = layer_norm(d_model)
        self.MultiHeadDotProductAttention_0 = Attention(d_model, n_heads, gen)
        self.LayerNorm_1 = layer_norm(d_model)
        self.Dense_0 = dense(d_model, 4 * d_model, gen)
        self.Dense_1 = dense(4 * d_model, d_model, gen)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask)
        h = gelu(self.Dense_0(self.LayerNorm_1(x)))
        return x + self.Dense_1(h)


class TinyTextEncoder(nn.Module):
    """Hash-token transformer encoder -> masked mean-pooled (B, d_model)
    embedding."""

    def __init__(self, vocab_size: int = 8192, d_model: int = 128,
                 n_layers: int = 2, max_len: int = 32, n_heads: int = 4,
                 gen: "torch.Generator | None" = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.n_layers = n_layers
        self.Embed_0 = embed(vocab_size, d_model, gen)
        self.pos = nn.Parameter(torch.empty((max_len, d_model)))
        with torch.no_grad():
            nn.init.normal_(self.pos, 0.0, 0.02, generator=gen)
        for i in range(n_layers):
            setattr(self, f"EncoderBlock_{i}",
                    EncoderBlock(d_model, n_heads, gen))
        self.LayerNorm_0 = layer_norm(d_model)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.Embed_0(ids) + self.pos[None, :ids.shape[1]]
        for i in range(self.n_layers):
            x = getattr(self, f"EncoderBlock_{i}")(x, mask)
        x = self.LayerNorm_0(x)
        denom = mask.sum(-1, keepdim=True).clamp(min=1.0)
        return (x * mask[..., None]).sum(1) / denom


def global_norm(params) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of every gradient together."""
    return torch.sqrt(sum(torch.sum(torch.square(p.grad)) for p in params
                          if p.grad is not None))


class EndToEndQueryTrainer:
    """Encoder + head trained jointly through the Cobweb rank scores of
    ``db``'s tree, on ``db``'s device: one AdamW step (weight decay 1e-4,
    as ``optax.adamw``) over both."""

    def __init__(self, db, vocab_size: int = 8192, d_model: int = 128,
                 n_layers: int = 2, max_len: int = 32, hidden_dim: int = 512,
                 temperature: float = 1.0, lr: float = 1e-3, seed: int = 0):
        full_f32_matmul()
        self.db = db
        self.device = db.device
        self.index = single_tree_index(db)
        self.temperature = temperature
        self.max_len = max_len
        self.vocab_size = vocab_size
        gen = torch.Generator().manual_seed(seed)
        self.encoder = TinyTextEncoder(vocab_size, d_model, n_layers,
                                       max_len, gen=gen).to(self.device)
        self.head = ProjectionHead(d_model, db.cfg.dim, hidden_dim,
                                   gen).to(self.device)
        self.opt = torch.optim.AdamW(
            list(self.encoder.parameters()) + list(self.head.parameters()),
            lr=lr, weight_decay=ADAMW_WEIGHT_DECAY)
        self.step = 0

    def _tokens(self, texts):
        ids, mask = hash_tokenize(texts, self.vocab_size, self.max_len)
        return self._tensors(ids, mask)

    def _tensors(self, ids, mask):
        return (torch.as_tensor(ids, dtype=torch.int64, device=self.device),
                torch.as_tensor(mask, dtype=torch.float32,
                                device=self.device))

    def encode(self, texts) -> np.ndarray:
        """(B, dim) projected embeddings of the texts."""
        with torch.no_grad():
            return self.head(self.encoder(*self._tokens(texts))) \
                .cpu().numpy()

    def train_step(self, ids, mask, labels):
        """One step on a batch of tokens; returns (loss, the encoder's
        gradient norm), device scalars."""
        ids, mask = self._tensors(ids, mask)
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                            device=self.device)
        proj = self.head(self.encoder(ids, mask))
        loss = rank_loss(self.index, proj, y, self.temperature)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        gn = global_norm(self.encoder.parameters())
        self.opt.step()
        self.step += 1
        return loss.detach(), gn.detach()

    def train_step_dp(self, ids, mask, labels, group):
        """One data-parallel step on a global batch of tokens: this rank's
        share, the gradients and the loss averaged over ``group``, the
        step; returns (the global batch's mean loss, the encoder's
        gradient norm after the average), device scalars."""
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        ids, mask = self._tensors(dp_rows(ids, rank, n),
                                  dp_rows(mask, rank, n))
        y = torch.as_tensor(np.asarray(dp_rows(labels, rank, n)),
                            dtype=torch.int64, device=self.device)
        loss = rank_loss(self.index, self.head(self.encoder(ids, mask)), y,
                         self.temperature)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        loss, = dp_reduce(list(self.encoder.parameters())
                          + list(self.head.parameters()), group, n, loss)
        gn = global_norm(self.encoder.parameters())
        self.opt.step()
        self.step += 1
        return loss, gn.detach()

    def _fit(self, step, query_texts, gold_rows, epochs, batch_size, seed,
             log_every, tag):
        ids, mask = hash_tokenize(query_texts, self.vocab_size, self.max_len)
        gold_rows = np.asarray(gold_rows, np.int64)
        rng = np.random.default_rng(seed)
        losses, grad_norms = [], []
        for epoch in range(1, epochs + 1):
            order = epoch_order(rng, len(gold_rows), batch_size)
            tot, gtot = 0.0, 0.0
            for s in range(0, len(order), batch_size):
                sel = order[s:s + batch_size]
                loss, gn = step(ids[sel], mask[sel], gold_rows[sel])
                tot += float(loss)
                gtot += float(gn)
            steps = len(order) // batch_size
            losses.append(tot / steps)
            grad_norms.append(gtot / steps)
            if log_every:
                print(f"[{tag}epoch {epoch}] CE {losses[-1]:.4f} "
                      f"enc-grad-norm {grad_norms[-1]:.4f}")
        return losses, grad_norms

    def fit(self, query_texts, gold_rows, epochs: int = 3,
            batch_size: int = 16, seed: int = 0, log_every: int = 0):
        """Returns (per-epoch mean CE losses, per-epoch mean encoder
        gradient norms); the batches are the JAX package's."""
        return self._fit(self.train_step, query_texts, gold_rows, epochs,
                         batch_size, seed, log_every, "")

    def fit_dp(self, query_texts, gold_rows, mesh, axis_name: str = "shard",
               epochs: int = 3, batch_size=None, seed: int = 0,
               log_every: int = 0):
        """Data-parallel ``fit`` over ``mesh``'s ``axis_name``, called on
        every rank with the same arguments (``query_train.fit_dp``'s
        rules); returns ``fit``'s pair over the global batches."""
        group, _, _, batch_size = dp_group(mesh, axis_name, batch_size)
        return self._fit(
            lambda i, m, y: self.train_step_dp(i, m, y, group), query_texts,
            gold_rows, epochs, batch_size, seed, log_every, "dp ")

    def evaluate(self, query_texts, gold_rows, k: int = 10) -> dict:
        proj = torch.as_tensor(self.encode(query_texts), device=self.device)
        with torch.no_grad():
            scores = index_mod.rank_scores(self.index, proj).cpu().numpy()
        return ranks_of(scores, gold_rows, k)

    def save(self, path: str):
        """The JAX package's pickle: ``enc_params``, ``head_params`` (flax
        trees) and ``temperature``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"enc_params": to_flax(self.encoder),
                         "head_params": to_flax(self.head),
                         "temperature": self.temperature}, f)

    def load_params(self, path: str):
        """Encoder and head from a pickle of either package."""
        blob = read_pickle(path)
        load_flax(self.encoder, blob["enc_params"])
        load_flax(self.head, blob["head_params"])
