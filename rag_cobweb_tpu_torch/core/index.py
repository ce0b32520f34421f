"""Fused serving index: the main-path subset of
``rag_cobweb_tpu/core/index.py``.

The path score of sentence t is linear in its path nodes' log-prob terms,
so it folds into per-sentence coefficients:

    score[b, t] = q_b . A_t - 0.5 q_b^2 . B_t + c_t
    A_t = sum_p w[t,p] mu/var[path(t,p)],  B_t = sum_p w[t,p] 1/var[...],
    c_t = sum_p w[t,p] const[...]

Stacking ``GT = [A | -0.5 B]^T`` (2D, Sp) makes the corpus sweep one
``[q, q^2] @ GT`` product plus a bias.  Rows are padded to
``_FUSED_ROW_BUCKET``; padding rows are invalid and score -inf.

Serving (``fused_query_rerank``) runs two hand-written kernels: the sweep
with a per-slab top-kappa pool (``ops/fused_topk``), merged to the top-c
by ``torch.topk``, then the exact stored-embedding re-rank
(``ops/rerank``), whose top-k is ``torch.topk`` again.  With
kappa = min(c, 2048) the merged pool is the EXACT top-c of the sweep.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from rag_cobweb_tpu_torch.ops import fused_topk, rerank

DEFAULT_LEVEL_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
_FUSED_ROW_BUCKET = fused_topk.SLAB   # 2048


class FusedIndex(NamedTuple):
    GT: torch.Tensor     # (2D, Sp) [A | -0.5 B]^T, serving dtype
    c: torch.Tensor      # (Sp,) f32 bias, 0 on padding rows
    valid: torch.Tensor  # (Sp,) bool, False on padding rows

    @property
    def num_slots(self) -> int:
        return self.c.shape[0]


def _fused_block_from_state(st, leaf_block: torch.Tensor, lw: torch.Tensor,
                            P: int, prior_var: float, acuity: bool):
    """One sentence block: chase each leaf's parent chain in global slot
    space (lane * capacity + local), derive each node's GEMM terms from
    the raw statistics and accumulate the fused coefficients.  Returns
    (G (Bs, 2D) f32, c (Bs,) f32, done) where ``done`` is False iff a
    chain did not reach a root within ``P`` hops."""
    cap = st.capacity
    dev = leaf_block.device
    neg = torch.full_like(leaf_block, -1)

    def lane_local(ids):
        safe = ids.clamp(min=0)
        return safe // cap, safe % cap

    cur = leaf_block
    chains = []
    for _ in range(P):
        chains.append(cur)
        lane, loc = lane_local(cur)
        par = st.parent[lane, loc]
        cur = torch.where((cur >= 0) & (par >= 0), par + lane * cap, neg)
    done = bool((cur < 0).all())
    chains = torch.stack(chains, dim=1)                 # (Bs, P) leaf->root
    plen = (chains >= 0).sum(dim=1)
    inv_plen = torch.where(plen > 0, 1.0 / plen.clamp(min=1).float(),
                           torch.zeros((), device=dev))

    Bs, D = leaf_block.shape[0], st.dim
    A = torch.zeros((Bs, D), dtype=torch.float32, device=dev)
    Bm = torch.zeros((Bs, D), dtype=torch.float32, device=dev)
    c = torch.zeros((Bs,), dtype=torch.float32, device=dev)
    for p in range(P):
        ids = chains[:, p]
        ok = ids >= 0
        lane, loc = lane_local(ids)
        cnt = st.counts[lane, loc]
        mu = st.means[lane, loc]
        m2 = st.m2s[lane, loc]
        pos = (cnt > 0).unsqueeze(1)
        ml = m2 / torch.where(cnt > 0, cnt, torch.ones_like(cnt)).unsqueeze(1)
        v = torch.clamp(ml, min=prior_var) if acuity else ml + prior_var
        v = torch.where(pos, v, torch.full_like(v, prior_var))
        inv = 1.0 / v
        mov = mu * inv
        cns = -0.5 * (torch.sum(torch.square(mu) * inv, dim=-1)
                      + torch.sum(torch.log(v), dim=-1))
        lvl = (plen - 1 - p).clamp(0, P - 1)
        w = torch.where(ok, lw[lvl] * inv_plen, torch.zeros_like(inv_plen))
        A = A + w.unsqueeze(1) * mov
        Bm = Bm + w.unsqueeze(1) * inv
        c = c + w * cns
    return torch.cat([A, -0.5 * Bm], dim=1), c, done


def build_fused_from_state(cfg, st, leaf_global: np.ndarray,
                           level_weights: Sequence[float]
                           = DEFAULT_LEVEL_WEIGHTS,
                           dtype=torch.float32, block: int = 1 << 19,
                           chase_depth: int = 32) -> FusedIndex:
    """FusedIndex straight from a stacked forest state (no flattened
    prediction index, no per-node stats arrays), one sentence block at a
    time.  ``leaf_global[s]`` is ``lane * capacity + local_leaf``; the
    parent-chase depth starts at ``chase_depth`` and doubles until every
    chain reaches a root."""
    dev = st.device
    S = int(len(leaf_global))
    bucket = _FUSED_ROW_BUCKET
    Bs = int(min(block, max(bucket, -(-max(S, 1) // bucket) * bucket)))
    Bs = -(-Bs // bucket) * bucket
    Sp = -(-max(S, 1) // Bs) * Bs
    leaf_pad = torch.full((Sp,), -1, dtype=torch.int64, device=dev)
    leaf_pad[:S] = torch.as_tensor(np.asarray(leaf_global, np.int64),
                                   device=dev)
    D = st.dim
    P = max(8, -(-int(chase_depth) // 8) * 8)
    GT = torch.zeros((2 * D, Sp), dtype=dtype, device=dev)
    c = torch.zeros((Sp,), dtype=torch.float32, device=dev)
    s0 = 0
    while s0 < Sp:
        lw = np.ones((P,), np.float32)
        lw[:min(len(level_weights), P)] = np.asarray(
            list(level_weights)[:P], np.float32)
        G, cb, done = _fused_block_from_state(
            st, leaf_pad[s0:s0 + Bs], torch.as_tensor(lw, device=dev), P,
            float(cfg.prior_var), bool(cfg.acuity_cutoff))
        if not done:          # a chain deeper than the chase: escalate
            P *= 2
            continue
        GT[:, s0:s0 + Bs] = G.T.to(dtype)
        c[s0:s0 + Bs] = cb
        s0 += Bs
    valid = torch.arange(Sp, device=dev) < S
    return FusedIndex(GT=GT, c=c, valid=valid)


def _qq(fidx: FusedIndex, queries: torch.Tensor) -> torch.Tensor:
    q = queries.float()
    return torch.cat([q, torch.square(q)], dim=1).to(fidx.GT.dtype) \
        .contiguous()


def fused_scores(fidx: FusedIndex, queries: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, Sp) f32 path scores (f32 operands and accumulation;
    padding rows -inf).  Reference form for tests: serving never
    materialises this matrix."""
    s = torch.matmul(_qq(fidx, queries).float(), fidx.GT.float()) + fidx.c
    return torch.where(fidx.valid, s, torch.full_like(s, float("-inf")))


def fused_query_topk(fidx: FusedIndex, queries: torch.Tensor, k: int):
    """Top-k path scores -> (scores (B, k) f32, sentence ids (B, k) int32).
    Per-slab top-kappa (kernel 1, kappa = min(k, 2048)) merged by
    ``torch.topk``: the exact top-k."""
    kappa = min(k, _FUSED_ROW_BUCKET)
    out_s, out_i = fused_topk.slab_topk(_qq(fidx, queries), fidx.GT, fidx.c,
                                        fidx.valid, kappa)
    NS, B, _ = out_s.shape
    cand_s = out_s.permute(1, 0, 2).reshape(B, NS * kappa)
    cand_i = out_i.permute(1, 0, 2).reshape(B, NS * kappa)
    top, pos = torch.topk(cand_s, min(k, NS * kappa), dim=1)
    return top, cand_i.gather(1, pos)


def exact_rerank(emb: torch.Tensor, queries: torch.Tensor,
                 cand: torch.Tensor, cand_scores: torch.Tensor, k: int,
                 prior_var: float = 1.0):
    """Re-rank (B, C) candidates by the fresh-leaf closed form on their
    stored rows (kernel 2), ``-0.5 (||q - x||^2 / prior_var + D log
    prior_var)``, non-finite candidates dropped -> (scores, ids) (B, k)."""
    lp = rerank.rerank_lp(emb, queries.float().contiguous(),
                          cand.to(torch.int32).contiguous(),
                          cand_scores.contiguous(), prior_var)
    top, pos = torch.topk(lp, k, dim=1)
    return top, cand.gather(1, pos)


def fused_query_rerank(fidx: FusedIndex, emb: torch.Tensor,
                       queries: torch.Tensor, queries_store: torch.Tensor,
                       k: int, c: int, prior_var: float = 1.0):
    """The serving path: fused sweep -> exact top-``c`` pool -> exact
    stored-embedding re-rank -> (scores, ids) (B, k)."""
    cs, cand = fused_query_topk(fidx, queries, c)
    return exact_rerank(emb, queries_store, cand, cs, k, prior_var)
