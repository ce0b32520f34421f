"""The plain reference of a retrieval cell: PyTorch and NumPy only, none
of the port and none of the JAX package.

What the port derives from the rows, the reference works out again:

* the whitening.  The port's PCA+ICA whitener maps a row to
  ``W K s P (x - m)``: PCA (``P``, scales ``s``) of the fit rows, then
  FastICA, whose unmixing ``W K`` is a whitening ``K`` of the ICA sample
  times an orthogonal ``W``.  Distances in that space do not depend on
  ``W`` nor on the signs an eigensolver picks, so ``fit_metric`` works out
  ``m``, ``s P`` and ``Sigma^-1/2`` (the ICA sample's covariance) in
  float64 and gives coordinates ``z`` whose distances are the port's;
  the port's own coordinates are ``z`` turned by an orthogonal matrix,
  which ``basis`` recovers from rows that the port placed in its leaves
  (the check of the whitening stage on its own, ``whiten_gap``);
* the forest's path scores.  A Cobweb build cannot be redone apart from
  the port (hosts part at near ties), so the sweep pool follows the
  port's own forest state; ``state_gaps`` checks that state by itself:
  each node's count, mean and spread are those of its children, and every
  row is in it;
* the candidate pools: the sweep's top pool by path score (bf16 operands,
  f32 sums, as the configuration serves them), the backstop's top pool by
  whitened distance over the indexed rows, and every row not yet indexed
  (the pending and delta tiers score each exactly: ``exact_top``);
* the answer: the top ``k`` of the union by exact float64 distance in the
  raw space.

Of these, the whitening, the backstop pool, the tiers and the answer are
worked out from the rows alone.  The sweep pool is not: it follows the
port's forest, and what checks the build (the choice of each row's leaf
and parent) is only ``state_gaps``, which sees a state that is wrong but
consistent as sound.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def no_tf32():
    """Float32 products in full float32 (the card would take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Metric(NamedTuple):
    mean: torch.Tensor     # (D,) f64
    proj: torch.Tensor     # (D, k) f64: s P, then Sigma^-1/2
    dim: int


def fit_metric(rows: torch.Tensor, pca_dim, ica_sample: int,
               eps: float = 1e-8, seed: int = 0) -> Metric:
    """The whitened space's metric from the fit rows, in float64: PCA to
    ``pca_dim`` (an int, or the least number of components that reach
    that share of the variance), unit variance, then the whitening of the
    ICA sample (the same rows the port's fit samples)."""
    no_tf32()
    X = rows.double()
    n = X.shape[0]
    mean = X.mean(0)
    Xc = X - mean
    cov = Xc.T @ Xc / (n - 1)
    vals, vecs = torch.linalg.eigh(cov)
    vals = vals.flip(0).clamp(min=0)
    vecs = vecs.flip(1)
    if isinstance(pca_dim, float):
        ratio = torch.cumsum(vals, 0) / vals.sum().clamp(min=1e-30)
        k = int(torch.searchsorted(ratio, torch.tensor(
            pca_dim, dtype=ratio.dtype, device=ratio.device))) + 1
    else:
        k = int(pca_dim)
    k = max(1, min(k, X.shape[1], n))
    sp = vecs[:, :k] / torch.sqrt(vals[:k] + eps)
    Y = Xc @ sp
    if ica_sample and n > ica_sample:
        sel = np.random.default_rng(seed).choice(n, ica_sample,
                                                 replace=False)
        Y = Y[torch.as_tensor(sel, device=Y.device)]
    Yc = Y - Y.mean(0)
    S = Yc.T @ Yc / (Y.shape[0] - 1)
    ev, eu = torch.linalg.eigh(S)
    inv_sqrt = (eu / torch.sqrt(ev.clamp(min=1e-12))) @ eu.T
    return Metric(mean, sp @ inv_sqrt, k)


def whiten(metric: Metric, x: torch.Tensor) -> torch.Tensor:
    """Reference coordinates (float64) of raw rows."""
    return (x.double() - metric.mean) @ metric.proj


def basis(z: torch.Tensor, port_rows: torch.Tensor):
    """The orthogonal turn ``R`` with ``z @ R`` closest to the port's
    coordinates of the same rows, and the worst row's distance from them
    over the median row's norm (``whiten_gap``)."""
    p = port_rows.double()
    u, _, vt = torch.linalg.svd(z.T @ p)
    R = u @ vt
    err = torch.linalg.vector_norm(z @ R - p, dim=1)
    scale = torch.linalg.vector_norm(p, dim=1).median()
    return R, float(err.max() / scale)


class ForestState(NamedTuple):
    """A K-lane forest's statistics: node arrays (K, N+1[, D or F]), each
    lane's root, and the global leaf slot (lane * capacity + node) of each
    row.  Nodes freed by a merge keep stale numbers: only nodes that a
    root reaches through ``children`` are the forest."""

    counts: torch.Tensor
    means: torch.Tensor
    m2s: torch.Tensor
    parent: torch.Tensor
    children: torch.Tensor
    root: torch.Tensor
    leaf_of_row: torch.Tensor


def reachable(st: ForestState) -> torch.Tensor:
    """(K, N+1) bool: the nodes each root reaches."""
    K = st.counts.shape[0]
    live = torch.zeros(st.counts.shape, dtype=torch.bool,
                       device=st.counts.device)
    lane = torch.arange(K, device=live.device)
    node = st.root.long()
    while len(node):
        live[lane, node] = True
        ch = st.children[lane, node]
        ok = ch >= 0
        lane = lane[:, None].expand_as(ch)[ok]
        node = ch[ok]
    return live


def state_gaps(st: ForestState, n_rows: int, dims: int = 64) -> dict:
    """The forest state checked by itself: ``rows_missing`` (rows whose
    leaf is not in the forest, plus the difference between the roots'
    counts and ``n_rows``, plus nodes whose count is not their children's
    sum) and ``state_gap`` (the worst node's mean and spread against those
    merged from its children, over the median node's spread), ``dims``
    dimensions at a time."""
    K, N1 = st.counts.shape
    D = st.means.shape[2]
    live = reachable(st).reshape(-1)
    cnt = st.counts.double().reshape(-1)
    par = st.parent.reshape(-1)
    lane = torch.arange(K, device=par.device).repeat_interleave(N1)
    child = torch.nonzero(live & (par >= 0)).squeeze(1)
    gpar = lane[child] * N1 + par[child]
    c_sum = torch.zeros_like(cnt).index_add_(0, gpar, cnt[child])
    own = torch.nonzero(live & (c_sum > 0)).squeeze(1)
    bad_count = int((c_sum[own] != cnt[own]).sum())
    lanes = torch.arange(K, device=par.device)
    missing = abs(int(st.counts[lanes, st.root.long()].double().sum())
                  - n_rows)
    cap = N1 - 1
    leaf = st.leaf_of_row
    ok = (leaf >= 0) & live[(leaf.clamp(min=0) // cap) * N1
                            + leaf.clamp(min=0) % cap]
    missing += int((~ok).sum()) + bad_count
    cnt_o, cnt_c = cnt[own], cnt[child]
    means = st.means.reshape(K * N1, D)
    m2s = st.m2s.reshape(K * N1, D)
    var = torch.zeros(len(own), dtype=torch.float64, device=cnt.device)
    g_mean = g_m2 = 0.0
    gaps = []
    for d0 in range(0, D, dims):
        mu_c = means[child, d0:d0 + dims].double()
        m2_c = m2s[child, d0:d0 + dims].double()
        s_sum = torch.zeros((K * N1, mu_c.shape[1]), dtype=torch.float64,
                            device=cnt.device).index_add_(
            0, gpar, cnt_c[:, None] * mu_c)
        mean_m = torch.zeros_like(s_sum)
        mean_m[own] = s_sum[own] / cnt_o[:, None]
        dev = mu_c - mean_m[gpar]
        m2_m = torch.zeros_like(s_sum).index_add_(
            0, gpar, m2_c + cnt_c[:, None] * dev * dev)
        mu_o = means[own, d0:d0 + dims].double()
        m2_o = m2s[own, d0:d0 + dims].double()
        var += m2_o.sum(1) / cnt_o
        gaps.append(((mu_o - mean_m[own]).abs().max(1).values,
                     ((m2_o - m2_m[own]).abs() / cnt_o[:, None])
                     .max(1).values))
    spread2 = (var / D).median().clamp(min=1e-30)
    g_mean = max(float(g.max()) for g, _ in gaps) / float(spread2.sqrt())
    g_m2 = max(float(g.max()) for _, g in gaps) / float(spread2)
    return {"rows_missing": missing, "state_gap": max(g_mean, g_m2)}


def path_terms(st: ForestState, prior_var: float, acuity: bool,
               level_weights=(1.0,) * 6, block: int = 1 << 17):
    """Each row's path-score coefficients from the forest state: the sum
    over the nodes from its leaf to its root, each weighted by its level's
    weight over the path's length, of ``[mu/var, -1/(2 var)]`` and of
    ``-(sum mu^2/var + sum log var)/2`` -> (G (S, 2D) f32, c (S,) f32)."""
    K, N1 = st.counts.shape
    cap = N1 - 1
    leaf = st.leaf_of_row
    S, D = leaf.shape[0], st.means.shape[2]
    G = torch.empty((S, 2 * D), dtype=torch.float32, device=leaf.device)
    c = torch.empty((S,), dtype=torch.float32, device=leaf.device)
    for s0 in range(0, S, block):
        cur = leaf[s0:s0 + block]
        chain = []
        while bool((cur >= 0).any()):
            chain.append(cur)
            ln, nd = cur.clamp(min=0) // cap, cur.clamp(min=0) % cap
            par = st.parent[ln, nd]
            cur = torch.where((cur >= 0) & (par >= 0), par + ln * cap,
                              torch.full_like(cur, -1))
        chain = torch.stack(chain, 1)
        plen = (chain >= 0).sum(1)
        P = chain.shape[1]
        lw = torch.ones(P, dtype=torch.float64, device=leaf.device)
        n_lw = min(len(level_weights), P)
        lw[:n_lw] = torch.tensor(level_weights[:n_lw], dtype=torch.float64)
        A = torch.zeros((len(cur), D), dtype=torch.float64,
                        device=leaf.device)
        Bm = torch.zeros_like(A)
        cc = torch.zeros(len(cur), dtype=torch.float64, device=leaf.device)
        for p in range(P):
            ids = chain[:, p]
            ok = ids >= 0
            ln, nd = ids.clamp(min=0) // cap, ids.clamp(min=0) % cap
            n = st.counts[ln, nd].double()
            mu = st.means[ln, nd].double()
            ml = st.m2s[ln, nd].double() / n.clamp(min=1)[:, None]
            v = ml.clamp(min=prior_var) if acuity else ml + prior_var
            v = torch.where((n > 0)[:, None], v,
                            torch.full_like(v, prior_var))
            lvl = (plen - 1 - p).clamp(0, P - 1)
            w = torch.where(ok, lw[lvl] / plen.clamp(min=1),
                            torch.zeros_like(cc))
            A += w[:, None] * mu / v
            Bm += w[:, None] / v
            cc += w * -0.5 * ((mu * mu / v).sum(1) + torch.log(v).sum(1))
        G[s0:s0 + block] = torch.cat([A, -0.5 * Bm], 1).float()
        c[s0:s0 + block] = cc.float()
    return G, c


def _topk_chunked(score_fn, n_rows: int, k: int, rows_per: int = 1 << 18):
    """Top ``k`` over ``n_rows`` columns of ``score_fn(r0, r1)`` -> (B, r1 -
    r0) scores, taken slab by slab (the lowest id first among ties)."""
    best_s = best_i = None
    for r0 in range(0, n_rows, rows_per):
        r1 = min(n_rows, r0 + rows_per)
        s = score_fn(r0, r1)
        ids = torch.arange(r0, r1, device=s.device).expand_as(s)
        if best_s is not None:
            s = torch.cat([best_s, s], 1)
            ids = torch.cat([best_i, ids], 1)
        o = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
        best_s, best_i = s.gather(1, o), ids.gather(1, o)
    return best_i


def sweep_pool(G: torch.Tensor, c: torch.Tensor, qw: torch.Tensor,
               n_indexed: int, size: int) -> torch.Tensor:
    """(B, size) rows with the best path scores over the first
    ``n_indexed`` rows: operands in bf16, sums in f32 (the configuration's
    serving precision)."""
    qq = torch.cat([qw, qw * qw], 1).to(torch.bfloat16).float()
    Gb = G[:n_indexed].to(torch.bfloat16)
    return _topk_chunked(
        lambda r0, r1: qq @ Gb[r0:r1].float().T + c[r0:r1], n_indexed,
        min(size, n_indexed))


def backstop_pool(zrows: torch.Tensor, zq: torch.Tensor, n_indexed: int,
                  size: int) -> torch.Tensor:
    """(B, size) indexed rows nearest in the whitened space (float32)."""
    zq = zq.float()
    return _topk_chunked(
        lambda r0, r1: zq @ zrows[r0:r1].T
        - 0.5 * zrows[r0:r1].square().sum(1), n_indexed,
        min(size, n_indexed))


def _d2(q: torch.Tensor, rows: torch.Tensor, dtype) -> torch.Tensor:
    """(B, C) squared distances of each query (B, D) to its rows (B, C, D):
    float64 throughout, or (the control) operands rounded to ``dtype`` and
    summed in float32."""
    if dtype == torch.float64:
        return (rows.double() - q.double()[:, None, :]).square().sum(-1)
    return (rows.to(dtype).float() - q.to(dtype).float()[:, None, :]
            ).square().sum(-1).double()


def exact_top(q: torch.Tensor, ranges, raw_rows, k: int,
              dtype=torch.float64, block: int = 1 << 17,
              short: int = 64) -> torch.Tensor:
    """Each query's ``k`` nearest raw rows among the ids of its range
    ``ranges[b] = (n0, n1)`` -> (B, k) ids, -1 past the range's rows.  The
    rows are scanned once in float32 (TF32 off) for each query's ``short``
    nearest; those are ordered in ``dtype`` as ``answer`` orders them."""
    B = len(q)
    if B > 1024:
        return torch.cat([exact_top(q[b0:b0 + 1024], ranges[b0:b0 + 1024],
                                    raw_rows, k, dtype, block, short)
                          for b0 in range(0, B, 1024)])
    lo = min((a for a, b in ranges if b > a), default=0)
    hi = max((b for a, b in ranges if b > a), default=0)
    out = torch.full((B, k), -1, dtype=torch.long, device=q.device)
    if hi <= lo:
        return out
    no_tf32()
    n0 = torch.tensor([a for a, _ in ranges], device=q.device)[:, None]
    n1 = torch.tensor([b for _, b in ranges], device=q.device)[:, None]
    qf = q.float()
    qn = qf.square().sum(1, keepdim=True)
    best_d = best_i = None
    for r0 in range(lo, hi, block):
        ids = torch.arange(r0, min(hi, r0 + block), device=q.device)
        x = raw_rows(ids).float()
        d = qn - 2.0 * qf @ x.T + x.square().sum(1)
        ok = (ids >= n0) & (ids < n1)
        d = torch.where(ok, d, torch.full_like(d, float("inf")))
        ids = ids.expand_as(d)
        if best_d is not None:
            d, ids = torch.cat([best_d, d], 1), torch.cat([best_i, ids], 1)
        m = min(short, d.shape[1])
        best_d, o = torch.topk(d, m, dim=1, largest=False)
        best_i = ids.gather(1, o)
    cand = torch.where(torch.isfinite(best_d), best_i,
                       torch.full_like(best_i, -1))
    return answer(q, cand, None, raw_rows, k, dtype)


def answer(q: torch.Tensor, cand: torch.Tensor, tier_ids, raw_rows, k: int,
           dtype=torch.float64, chunk: int = 16) -> torch.Tensor:
    """The reference's answer: of each query's candidates ``cand`` (B, C;
    -1 for none) and its tiers' best rows ``tier_ids`` (B, k, from
    ``exact_top`` over its unindexed range; None: no tiers), the ``k``
    nearest in the raw space, the lowest id first among equal distances
    -> (B, k) ids, -1 past the candidates.  ``raw_rows(ids)`` gives the
    raw rows of global ids."""
    if tier_ids is not None:
        cand = torch.cat([cand, tier_ids], 1)
    out = []
    for b0 in range(0, len(q), chunk):
        qb = q[b0:b0 + chunk]
        srt = torch.sort(cand[b0:b0 + chunk], 1).values   # ids ascending
        ok = srt >= 0
        ok[:, 1:] &= srt[:, 1:] != srt[:, :-1]          # distinct ids
        d2 = _d2(qb, raw_rows(srt.clamp(min=0)), dtype)
        d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
        o = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        ids = srt.gather(1, o)
        out.append(torch.where(torch.isfinite(d2.gather(1, o)), ids,
                               torch.full_like(ids, -1)))
    res = torch.cat(out)
    if res.shape[1] < k:
        res = torch.cat([res, torch.full((len(q), k - res.shape[1]), -1,
                                         dtype=res.dtype,
                                         device=res.device)], 1)
    return res
