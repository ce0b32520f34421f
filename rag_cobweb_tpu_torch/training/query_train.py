"""Cobweb-supervised query-encoder fine-tuning (port of
``rag_cobweb_tpu/training/query_train.py``).

A projection head (Linear-ReLU-Linear, hidden 512) maps query embeddings
into the tree's (whitened) space and is trained with cross-entropy over
the differentiable Cobweb rank scores of a single tree
(``core/index.rank_scores``, divided by ``temperature``): the label is
the gold passage's corpus row.  AdamW with weight decay 1e-4, as
``optax.adamw``'s default.

``fit_dp`` is data parallel over a mesh axis: every rank of the axis
holds the whole tree and the parameters, takes its even share of each
global batch (the JAX package raises ``ValueError`` when the batch does
not divide, and so does the port), and before the optimizer step the
gradients are averaged over the ranks with one ``all_reduce``, the loss
riding in the same buffer (``dp_reduce``).  So each step is ``fit``'s step
on the whole global batch, and the reported loss is the global batch's
mean on every rank (the JAX package's GSPMD inserts the same
all-reduce).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.device import full_f32_matmul
from rag_cobweb_tpu_torch.files import read_pickle
from rag_cobweb_tpu_torch.parallel.collectives import all_reduce_sum
from rag_cobweb_tpu_torch.parallel.distributed import axis_group
from rag_cobweb_tpu_torch.training.flax_layout import (dense, load_flax,
                                                       to_flax)

# optax.adamw's default weight decay (torch.optim.AdamW's is 0.01)
ADAMW_WEIGHT_DECAY = 1e-4


class ProjectionHead(nn.Module):
    """flax ``ProjectionHead``: ``Dense(hidden) -> relu -> Dense(out)``."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 512,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = dense(in_dim, hidden_dim, gen)
        self.Dense_1 = dense(hidden_dim, out_dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


def single_tree_index(db):
    """The prediction index of ``db``'s single tree.  A forest's index is
    a stack of per-lane trees that ``rank_scores`` does not take (in the
    JAX package it fails inside the first step), so a forest is refused
    here."""
    if db.forest is not None:
        raise ValueError(
            f"the query trainers take a single-tree index (n_subtrees=1); "
            f"this one is a forest of {db.n_subtrees} lanes")
    return db.build_prediction_index()


def rank_loss(index, proj: torch.Tensor, labels: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """Mean cross-entropy of the (B, S) rank-score logits against the gold
    rows."""
    logits = index_mod.rank_scores(index, proj) / temperature
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.view(-1, 1)).mean()


def epoch_order(rng: np.random.Generator, n_items: int,
                batch_size: int) -> np.ndarray:
    """One epoch's sample order, as the JAX trainers draw it: a
    permutation wrapped (``np.resize``) to a whole number of batches, never
    fewer than one."""
    if n_items == 0:
        raise ValueError("no training examples: the query set is empty")
    n = max((n_items // batch_size) * batch_size, batch_size)
    return np.resize(rng.permutation(n_items), n)


def dp_group(mesh, axis_name: str, batch_size: Optional[int]):
    """(process group, this rank's index, ranks, global batch size) of a
    data-parallel fit over ``mesh``'s ``axis_name``; the batch defaults
    to 4 a rank, as in the JAX package, and must divide over the
    ranks."""
    group, rank, n = axis_group(mesh, axis_name)
    batch_size = batch_size or 4 * n
    if batch_size % n:
        raise ValueError(
            f"batch_size {batch_size} must divide over {n} devices")
    return group, rank, n, batch_size


def dp_rows(batch, rank: int, n: int):
    """This rank's even share of a global batch."""
    b = len(batch) // n
    return batch[rank * b:(rank + 1) * b]


def dp_reduce(params, group, n: int, *scalars):
    """The gradients of ``params`` and the device ``scalars`` averaged
    over the ``n`` ranks of ``group`` in one ``all_reduce``; the gradients
    are written back, the averaged scalars returned."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.flatten() for g in grads]
                     + [v.detach().float().view(1) for v in scalars])
    all_reduce_sum(flat, group).div_(n)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return tuple(flat[at:])


def ranks_of(scores: np.ndarray, gold_rows, k: int) -> dict:
    """recall@k, MRR and mean gold rank of (B, S) host scores ranked by
    ``np.argsort(-scores)``, as the JAX package ranks them (sentences that
    share a leaf tie exactly, and another sort would order them
    otherwise)."""
    order = np.argsort(-scores, axis=1)
    ranks = np.asarray([int(np.where(order[i] == gold_rows[i])[0][0]) + 1
                        for i in range(len(gold_rows))])
    return {f"recall@{k}": float((ranks <= k).mean()),
            "mrr": float((1.0 / ranks).mean()),
            "mean_gold_rank": float(ranks.mean())}


class CobwebQueryTrainer:
    """Trains a projection head so projected queries rank their gold
    passage first under the Cobweb path scores of ``db``'s tree, on
    ``db``'s device."""

    def __init__(self, db, in_dim: int, hidden_dim: int = 512,
                 temperature: float = 1.0, lr: float = 2e-5, seed: int = 0):
        full_f32_matmul()
        self.db = db
        self.device = db.device
        self.index = single_tree_index(db)
        self.temperature = temperature
        gen = torch.Generator().manual_seed(seed)
        self.head = ProjectionHead(in_dim, db.cfg.dim, hidden_dim,
                                   gen).to(self.device)
        self.opt = torch.optim.AdamW(self.head.parameters(), lr=lr,
                                     weight_decay=ADAMW_WEIGHT_DECAY)
        self.step = 0

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def train_step(self, queries, labels) -> torch.Tensor:
        """One AdamW step on the CE over rank-score logits of a (B, in_dim)
        batch with (B,) gold corpus rows; returns the loss (a device
        scalar, before the step)."""
        q = self._tensor(queries)
        y = self._tensor(labels, torch.int64)
        loss = rank_loss(self.index, self.head(q), y, self.temperature)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step += 1
        return loss.detach()

    def train_step_dp(self, queries, labels, group) -> torch.Tensor:
        """One data-parallel step on a global batch: this rank's share,
        the gradients and the loss averaged over ``group``, the AdamW
        step; returns the global batch's mean loss (a device scalar)."""
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        q = self._tensor(dp_rows(queries, rank, n))
        y = self._tensor(dp_rows(labels, rank, n), torch.int64)
        loss = rank_loss(self.index, self.head(q), y, self.temperature)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        loss, = dp_reduce(self.head.parameters(), group, n, loss)
        self.opt.step()
        self.step += 1
        return loss

    def _fit(self, step, query_embs, gold_rows, epochs, batch_size, seed,
             save_dir, log_every, tag) -> list:
        query_embs = np.asarray(query_embs, np.float32)
        gold_rows = np.asarray(gold_rows, np.int64)
        rng = np.random.default_rng(seed)
        losses = []
        for epoch in range(1, epochs + 1):
            order = epoch_order(rng, len(query_embs), batch_size)
            total = 0.0
            for s in range(0, len(order), batch_size):
                sel = order[s:s + batch_size]
                total += float(step(query_embs[sel], gold_rows[sel]))
            losses.append(total / (len(order) // batch_size))
            if log_every:
                print(f"[{tag}epoch {epoch}] avg CE loss {losses[-1]:.4f}")
            if save_dir:
                self.save(os.path.join(
                    save_dir, f"cobweb_query_encoder_epoch{epoch}.pkl"))
        return losses

    def fit(self, query_embs, gold_rows, epochs: int = 3,
            batch_size: int = 16, seed: int = 0,
            save_dir: Optional[str] = None, log_every: int = 0) -> list:
        """Per-epoch mean CE losses; the batches are the JAX package's
        (``epoch_order``).  An empty query set raises ``ValueError`` (the
        JAX package raises ``IndexError``)."""
        return self._fit(self.train_step, query_embs, gold_rows, epochs,
                         batch_size, seed, save_dir, log_every, "")

    def fit_dp(self, query_embs, gold_rows, mesh, axis_name: str = "shard",
               epochs: int = 3, batch_size: Optional[int] = None,
               seed: int = 0, log_every: int = 0) -> list:
        """Data-parallel ``fit`` over ``mesh``'s ``axis_name``, called
        on every rank with the same arguments: the same batches as
        ``fit`` with ``batch_size`` (default 4 a rank) split evenly over
        the ranks; per-epoch mean CE losses of the global batches.  A
        batch that does not divide over the ranks, or an empty query set,
        raises ``ValueError`` before any step."""
        group, _, _, batch_size = dp_group(mesh, axis_name, batch_size)
        return self._fit(lambda q, y: self.train_step_dp(q, y, group),
                         query_embs, gold_rows, epochs, batch_size, seed,
                         None, log_every, "dp ")

    def project(self, query_embs) -> np.ndarray:
        with torch.no_grad():
            return self.head(self._tensor(
                np.asarray(query_embs, np.float32))).cpu().numpy()

    def evaluate(self, query_embs, gold_rows, k: int = 10) -> dict:
        """recall@k / MRR / mean gold rank by a full-score argsort."""
        proj = self._tensor(self.project(query_embs))
        with torch.no_grad():
            scores = index_mod.rank_scores(self.index, proj).cpu().numpy()
        return ranks_of(scores, gold_rows, k)

    def save(self, path: str):
        """The JAX package's pickle: ``{"params": <flax tree>,
        "temperature": ...}``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"params": to_flax(self.head),
                         "temperature": self.temperature}, f)

    def load_params(self, path: str):
        """The head's parameters from a pickle of either package."""
        load_flax(self.head, read_pickle(path)["params"])
