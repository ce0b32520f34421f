"""Category-utility scores of the four Cobweb restructure operations (port
of ``rag_cobweb_tpu/ops/opscore.py``).

The JAX functions score one node's fanout block and are ``vmap``-ed over
forest lanes; here the lane axis is written out.  Shapes: ``x`` (L, D),
``parent`` stats (L,)/(L, D), ``children`` stats (L, F)/(L, F, D),
``mask`` (L, F) bool.  Tie-breaks follow the lexicographic
``(score, count, noise)`` order; the noise is a uniform draw the caller
makes from its own seeded ``torch.Generator``, so it never reproduces the
JAX package's ``jax.random`` bits — parity holds on tie-free data only,
the same assumption as the oracle tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.ops.gaussian import (
    GaussStats,
    compute_score,
    insert_mean_var,
    merge_mean_var,
    new_mean_var,
    stats_mean_var,
)

OP_BEST = 0
OP_NEW = 1
OP_MERGE = 2
OP_SPLIT = 3


class TwoBest(NamedTuple):
    best1: torch.Tensor     # (L,) int64 lane of the fanout block
    best2: torch.Tensor     # (L,) int64, -1 when there is one child only
    best1_pu: torch.Tensor  # (L,) f32 pu_for_insert(best1), 0 when greedy


def _lex_argmax(primary, secondary, noise, mask):
    """argmax over the last axis by (primary, secondary, noise) among the
    masked entries."""
    neg = torch.full_like(primary, float("-inf"))
    p = torch.where(mask, primary, neg)
    t1 = mask & (p == p.max(dim=-1, keepdim=True).values)
    s = torch.where(t1, secondary, neg)
    t2 = t1 & (s == s.max(dim=-1, keepdim=True).values)
    r = torch.where(t2, noise, neg)
    return torch.argmax(r, dim=-1)


def _scores_vs_parent(child_mean, child_var, parent_mean, parent_var, cfg):
    """score(child || parent) per fanout entry: (L, F, D) x (L, D) -> (L, F)."""
    return compute_score(child_mean, child_var, parent_mean.unsqueeze(-2),
                         parent_var.unsqueeze(-2), cfg)


def _masked_weighted_sum(weights, scores, mask):
    return torch.sum(torch.where(mask, weights * scores,
                                 torch.zeros_like(scores)), dim=-1)


def _pick(stats: GaussStats, idx: torch.Tensor) -> GaussStats:
    """Stats of fanout entry ``idx`` (L,) of every lane."""
    i = idx.clamp(min=0).unsqueeze(-1)
    return GaussStats(
        stats.count.gather(-1, i).squeeze(-1),
        stats.mean.gather(-2, i.unsqueeze(-1).expand(
            -1, 1, stats.mean.shape[-1])).squeeze(-2),
        stats.m2.gather(-2, i.unsqueeze(-1).expand(
            -1, 1, stats.m2.shape[-1])).squeeze(-2))


def insert_gains(x, parent: GaussStats, children: GaussStats,
                 cfg: TreeConfig) -> torch.Tensor:
    """(L, F) relative insert utility of each child:
    ``(c+1)/(p+1) * score(ins(c) || ins(p)) - c/(p+1) * score(c || ins(p))``
    (the primary key of ``two_best_children``)."""
    p_ins_mean, p_ins_var = insert_mean_var(parent, x, cfg)
    c_ins_mean, c_ins_var = insert_mean_var(children, x.unsqueeze(-2), cfg)
    c_mean, c_var = stats_mean_var(children, cfg)

    denom = (parent.count + 1.0).unsqueeze(-1)
    return ((children.count + 1.0) / denom) * _scores_vs_parent(
        c_ins_mean, c_ins_var, p_ins_mean, p_ins_var, cfg
    ) - (children.count / denom) * _scores_vs_parent(
        c_mean, c_var, p_ins_mean, p_ins_var, cfg)


def two_best_children(x, parent: GaussStats, children: GaussStats, mask,
                      cfg: TreeConfig, noise) -> TwoBest:
    """The two children with the highest ``insert_gains``."""
    gain = insert_gains(x, parent, children, cfg)
    best1 = _lex_argmax(gain, children.count, noise, mask)
    lanes = torch.arange(mask.shape[-1], device=mask.device)
    mask2 = mask & (lanes != best1.unsqueeze(-1))
    best2 = torch.where(mask2.any(dim=-1),
                        _lex_argmax(gain, children.count, noise, mask2),
                        torch.full_like(best1, -1))
    if cfg.greedy:
        best1_pu = torch.zeros_like(parent.count)
    else:
        best1_pu = pu_for_insert(x, parent, children, mask, best1, cfg)
    return TwoBest(best1, best2, best1_pu)


def pu_for_insert(x, parent: GaussStats, children: GaussStats, mask, best1,
                  cfg: TreeConfig):
    """Category utility of adding ``x`` to child ``best1``."""
    p_ins_mean, p_ins_var = insert_mean_var(parent, x, cfg)
    c_mean, c_var = stats_mean_var(children, cfg)
    c_ins_mean, c_ins_var = insert_mean_var(children, x.unsqueeze(-2), cfg)

    lanes = torch.arange(mask.shape[-1], device=mask.device)
    is_best = lanes == best1.unsqueeze(-1)
    sel_mean = torch.where(is_best.unsqueeze(-1), c_ins_mean, c_mean)
    sel_var = torch.where(is_best.unsqueeze(-1), c_ins_var, c_var)
    sel_count = torch.where(is_best, children.count + 1.0, children.count)

    denom = (parent.count + 1.0).unsqueeze(-1)
    scores = _scores_vs_parent(sel_mean, sel_var, p_ins_mean, p_ins_var, cfg)
    nc = mask.sum(dim=-1)
    return _masked_weighted_sum(sel_count / denom, scores, mask) / nc


def pu_for_new_child(x, parent: GaussStats, children: GaussStats, mask,
                     cfg: TreeConfig):
    """Category utility of giving ``x`` a new child of its own."""
    p_ins_mean, p_ins_var = insert_mean_var(parent, x, cfg)
    c_mean, c_var = stats_mean_var(children, cfg)

    denom = parent.count + 1.0
    scores = _scores_vs_parent(c_mean, c_var, p_ins_mean, p_ins_var, cfg)
    total = _masked_weighted_sum(children.count / denom.unsqueeze(-1),
                                 scores, mask)
    new_mean, new_var = new_mean_var(x, cfg)
    total = total + (1.0 / denom) * compute_score(
        new_mean, new_var, p_ins_mean, p_ins_var, cfg)
    return total / (mask.sum(dim=-1) + 1.0)


def pu_for_merge(x, parent: GaussStats, children: GaussStats, mask, best1,
                 best2, cfg: TreeConfig):
    """Category utility of merging the two best children."""
    p_ins_mean, p_ins_var = insert_mean_var(parent, x, cfg)
    c_mean, c_var = stats_mean_var(children, cfg)

    lanes = torch.arange(mask.shape[-1], device=mask.device)
    others = (mask & (lanes != best1.unsqueeze(-1))
              & (lanes != best2.unsqueeze(-1)))
    denom = parent.count + 1.0
    scores = _scores_vs_parent(c_mean, c_var, p_ins_mean, p_ins_var, cfg)
    total = _masked_weighted_sum(children.count / denom.unsqueeze(-1),
                                 scores, others)

    b1, b2 = _pick(children, best1), _pick(children, best2)
    m_mean, m_var = merge_mean_var(b1, b2, x, cfg)
    w = (b1.count + b2.count + 1.0) / denom
    total = total + w * compute_score(m_mean, m_var, p_ins_mean, p_ins_var,
                                      cfg)
    return total / (mask.sum(dim=-1) - 1.0)


def pu_for_split(parent: GaussStats, children: GaussStats, mask, best1,
                 grandchildren: GaussStats, gc_mask, cfg: TreeConfig):
    """Category utility of splitting ``best1`` into the current node (the
    parent's current stats: split does not absorb ``x``)."""
    p_mean, p_var = stats_mean_var(parent, cfg)
    c_mean, c_var = stats_mean_var(children, cfg)

    lanes = torch.arange(mask.shape[-1], device=mask.device)
    others = mask & (lanes != best1.unsqueeze(-1))
    pc = parent.count.unsqueeze(-1)
    scores = _scores_vs_parent(c_mean, c_var, p_mean, p_var, cfg)
    total = _masked_weighted_sum(children.count / pc, scores, others)

    g_mean, g_var = stats_mean_var(grandchildren, cfg)
    g_scores = _scores_vs_parent(g_mean, g_var, p_mean, p_var, cfg)
    total = total + _masked_weighted_sum(grandchildren.count / pc,
                                         g_scores, gc_mask)
    return total / (mask.sum(dim=-1) - 1.0 + gc_mask.sum(dim=-1))


def operation_utilities(x, parent: GaussStats, children: GaussStats, mask,
                        two_best: TwoBest, grandchildren: GaussStats,
                        gc_mask, cfg: TreeConfig, fanout_full, split_fits):
    """(L, 4) utilities of {best, new, merge, split} and which are valid:
    ``new`` is gated off when the fanout block is full and ``split`` when
    promoting best1's children would overflow it."""
    nc = mask.sum(dim=-1)
    utilities = torch.stack([
        two_best.best1_pu,
        pu_for_new_child(x, parent, children, mask, cfg),
        pu_for_merge(x, parent, children, mask, two_best.best1,
                     two_best.best2, cfg),
        pu_for_split(parent, children, mask, two_best.best1, grandchildren,
                     gc_mask, cfg),
    ], dim=-1)
    valid = torch.stack([
        torch.ones_like(fanout_full),
        ~fanout_full,
        (nc > 2) & (two_best.best2 >= 0),
        gc_mask.any(dim=-1) & split_fits,
    ], dim=-1)
    return utilities, valid


def best_operation(x, parent: GaussStats, children: GaussStats, mask,
                   two_best: TwoBest, grandchildren: GaussStats, gc_mask,
                   cfg: TreeConfig, noise, fanout_full, split_fits):
    """Best valid operation by ``operation_utilities``; ``noise`` (L, 4)
    breaks exact utility ties.  Returns (op (L,), utility (L,))."""
    utilities, valid = operation_utilities(
        x, parent, children, mask, two_best, grandchildren, gc_mask, cfg,
        fanout_full, split_fits)
    op = _lex_argmax(utilities, noise, noise, valid)
    return op, utilities.gather(-1, op.unsqueeze(-1)).squeeze(-1)
