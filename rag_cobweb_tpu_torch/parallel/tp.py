"""Within-tree tensor parallelism: one tree's serving index sharded over
the ranks of a mesh axis (port of ``rag_cobweb_tpu/parallel/tp.py``).

Two engines, both SPMD (every rank calls ``query_topk`` with the same
queries and returns the merged result):

  * ``TPPredictionIndex``: the node statistics split along **D** (the
    contraction of the scoring products) and the sentence paths along
    **S**.  Each rank computes the partial (B, N) node log-probs of its
    D-slice, ``all_reduce`` sums them (the JAX ``psum``), then path-sums
    and takes the top-kk of its own rows (plain PyTorch, as XLA compiled
    it).  With stored rows the pool is re-ranked by kernel 5
    (``ops/rerank``) on the rank's own rows, else by leaf log-prob.
  * ``TPFusedPredictionIndex``: the fused index's (2D, S) coefficients
    split along **S**.  Each rank's sweep and pool is kernel 1
    (``ops/fused_topk.slab_topk`` over its (2D, S/K) slab, the bf16 entry
    for a bf16 index and the f32 one for an f32 index), the exact re-rank
    kernel 5 on its rows.

Then ``collectives.merge_topk`` merges the ranks' (B, kk) candidates.
The re-rank key is the JAX package's ``-||q - x||^2``: kernel 5 runs
with prior variance 1, so its key ``-0.5 d2`` doubled is ``-d2`` bit for
bit.  ``queries_store`` (default: the queries) gives the re-rank its own
queries, for a store of raw rows beside a whitened tree.  ``approx``
selects an exact pool, as everywhere in the port (the TPU's
``approx_max_k`` has no counterpart).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from rag_cobweb_tpu_torch.core.index import (FusedIndex, PredictionIndex,
                                             path_scores_from_nlp,
                                             topk_stable)
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.ops import fused_topk, rerank
from rag_cobweb_tpu_torch.parallel import collectives
from rag_cobweb_tpu_torch.parallel.distributed import axis_group

_NEG_INF = float("-inf")


def _rows(a, shape) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).reshape(shape)


class TPIndex(NamedTuple):
    """A prediction index split over K ranks: stacked (leading axis K)
    from ``shard_index``, one rank's slice from ``place``."""

    ivt: torch.Tensor        # (K, D/K, N) inv_var_T split along D
    movt: torch.Tensor       # (K, D/K, N)
    const: torch.Tensor      # (N,) every rank's (per-node scalar term)
    paths: torch.Tensor      # (K, S/K, P) path rows split along S
    path_weights: torch.Tensor  # (K, S/K, P)
    sid: torch.Tensor        # (K, S/K) row -> global sentence id, -1 pad
    leaf: torch.Tensor       # (K, S/K) row -> leaf compact node id
    emb: torch.Tensor        # (K, S/K, De) stored rows ((K, S/K, 0) if none)

    @property
    def n_shards(self) -> int:
        return self.ivt.shape[0]


def shard_index(index: PredictionIndex, n_shards: int,
                embeddings=None) -> TPIndex:
    """Split a built PredictionIndex into ``n_shards`` TP shards on the
    host.  D is zero-padded to ``K * ceil(D / K)`` (a zero ``inv_var`` and
    ``mu/var`` adds exact zeros to the sum); S is padded with rows of
    path -1 and id -1.  ``embeddings``: optional (S, De) stored rows,
    split along S with the paths: the exact cross-shard re-rank."""
    ivt = index.inv_var_T.cpu().numpy()
    movt = index.mu_over_var_T.cpu().numpy()
    D, N = ivt.shape
    Dp = -(-D // n_shards) * n_shards
    pad = ((0, Dp - D), (0, 0))
    ivt, movt = np.pad(ivt, pad), np.pad(movt, pad)
    paths = index.paths.cpu().numpy()
    pw = index.path_weights.cpu().numpy()
    S, Pd = paths.shape
    Sp = -(-S // n_shards) * n_shards
    sid = np.arange(S, dtype=np.int64)
    plen = (paths >= 0).sum(1)
    leaf = paths[np.arange(S), np.maximum(plen - 1, 0)].astype(np.int64)
    rpad = (0, Sp - S)
    paths = np.pad(paths, (rpad, (0, 0)), constant_values=-1)
    pw = np.pad(pw, (rpad, (0, 0)))
    sid = np.pad(sid, rpad, constant_values=-1)
    leaf = np.pad(leaf, rpad)
    emb = (np.zeros((Sp, 0), np.float32) if embeddings is None
           else np.pad(np.asarray(embeddings, np.float32), (rpad, (0, 0))))
    K, s = n_shards, Sp // n_shards
    return TPIndex(
        ivt=_rows(ivt, (K, Dp // K, N)), movt=_rows(movt, (K, Dp // K, N)),
        const=index.const.cpu(), paths=_rows(paths, (K, s, Pd)),
        path_weights=_rows(pw, (K, s, Pd)), sid=_rows(sid, (K, s)),
        leaf=_rows(leaf, (K, s)), emb=_rows(emb, (K, s, emb.shape[1])))


def place(tpidx: TPIndex, mesh: DeviceMesh, axis: str = "shard",
          device="cuda") -> TPIndex:
    """This rank's shard of ``tpidx`` on ``device`` (no leading axis)."""
    _, shard, _ = axis_group(mesh, axis)
    dev = resolve_device(device)
    return TPIndex(*[(a if a is tpidx.const else a[shard])
                     .contiguous().to(dev) for a in tpidx])


def _rerank_keys(emb, qs, rows, top):
    """Kernel 5's key on the rank's stored rows at prior variance 1,
    doubled: ``-||q - x||^2`` exactly, -inf where ``top`` is not finite
    (those rows are not read)."""
    live = torch.isfinite(top)
    cand = torch.where(live, rows, torch.zeros_like(rows))
    lp = rerank.rerank_lp(emb, qs.float().contiguous(),
                          cand.to(torch.int32).contiguous(),
                          top.contiguous(), 1.0)
    return 2.0 * lp


def _tp_query(local: TPIndex, q: torch.Tensor, k: int, rerank_c: int,
              shard: int, group, queries_store=None):
    """``_tp_query`` of the JAX package on one rank: its D-slice's partial
    node log-probs summed over the ranks, the path scores of its rows and
    their top-kk, the re-rank, the merge -> (scores, global ids) (B, k)."""
    dsl = local.ivt.shape[0]
    ql = q[:, shard * dsl:(shard + 1) * dsl]
    partial = (torch.matmul(ql, local.movt)
               - 0.5 * torch.matmul(torch.square(ql), local.ivt))
    nlp = collectives.all_reduce_sum(partial, group) + local.const
    scores = path_scores_from_nlp(local.paths, local.path_weights, nlp)
    scores = torch.where(local.sid >= 0, scores,
                         torch.full_like(scores, _NEG_INF))
    top, rows = topk_stable(scores, min(max(k, rerank_c), scores.shape[1]))
    if rerank_c and local.emb.shape[-1] > 0:
        qs = q[:, :local.emb.shape[-1]] if queries_store is None \
            else queries_store
        top = _rerank_keys(local.emb, qs, rows, top)
    elif rerank_c:
        lp = torch.gather(nlp, 1, local.leaf[rows])
        top = torch.where(torch.isfinite(top), lp,
                          torch.full_like(lp, _NEG_INF))
    return collectives.merge_topk(top, local.sid[rows], k, group)


class TPFusedIndex(NamedTuple):
    """A FusedIndex split along S over K ranks, stacked (leading axis K),
    from ``shard_fused_index``; ``rank_slab`` takes one rank's."""

    GT: torch.Tensor    # (K, 2D, S/K) serving-dtype column slabs
    c: torch.Tensor     # (K, S/K) f32 bias
    sid: torch.Tensor   # (K, S/K) column -> global sentence id, -1 pad
    emb: torch.Tensor   # (K, S/K, De) stored rows ((K, S/K, 0) if none)

    @property
    def n_shards(self) -> int:
        return self.GT.shape[0]


def shard_fused_index(fidx: FusedIndex, n_shards: int,
                      embeddings=None) -> TPFusedIndex:
    """Split a built FusedIndex into ``n_shards`` column slabs on the
    host; columns padded to a multiple of K (id -1)."""
    GT = fidx.GT.cpu()
    c = fidx.c.cpu()
    twoD, Sp = GT.shape
    Spp = -(-Sp // n_shards) * n_shards
    K, s = n_shards, Spp // n_shards
    sid = torch.where(fidx.valid.cpu(), torch.arange(Sp), -1)
    GT = torch.nn.functional.pad(GT, (0, Spp - Sp))
    c = torch.nn.functional.pad(c, (0, Spp - Sp))
    sid = torch.nn.functional.pad(sid, (0, Spp - Sp), value=-1)
    if embeddings is None:
        emb = torch.zeros((Spp, 0))
    else:
        e = torch.as_tensor(np.asarray(embeddings, np.float32))
        emb = torch.nn.functional.pad(e, (0, 0, 0, Spp - e.shape[0]))
    return TPFusedIndex(
        GT=GT.view(twoD, K, s).permute(1, 0, 2).contiguous(),
        c=c.view(K, s), sid=sid.view(K, s),
        emb=emb.view(K, s, emb.shape[1]))


class _Slab(NamedTuple):
    """One rank's slab, padded to whole 2048-column kernel slabs."""

    GT: torch.Tensor     # (2D, W)
    c: torch.Tensor      # (W,)
    valid: torch.Tensor  # (W,) bool
    sid: torch.Tensor    # (W,)
    emb: torch.Tensor    # (S/K, De)
    width: int           # S/K, the JAX shard's column count


def rank_slab(t: TPFusedIndex, r: int, device) -> _Slab:
    """Rank ``r``'s slab of ``t`` on ``device``, its columns padded to
    whole kernel slabs (invalid, id -1)."""
    width = t.GT.shape[2]
    pad = (0, -width % fused_topk.SLAB)
    sid = torch.nn.functional.pad(t.sid[r], pad, value=-1).to(device)
    return _Slab(
        GT=torch.nn.functional.pad(t.GT[r], pad).contiguous().to(device),
        c=torch.nn.functional.pad(t.c[r], pad).to(device), valid=sid >= 0,
        sid=sid, emb=t.emb[r].contiguous().to(device), width=width)


class TPFusedPredictionIndex:
    """Fused index split along S over a mesh axis (query facade).

    Per rank: (2D S)/K coefficients and S/K stored rows; a query batch
    runs kernel 1 on the rank's slab, kernel 5 on its pool and one merge
    of (B, k) candidates.  With stored ``embeddings`` and ``rerank`` the
    merged ordering is the single-device fused pool + exact re-rank's."""

    def __init__(self, fidx: FusedIndex, mesh: DeviceMesh,
                 axis: str = "shard", embeddings=None, device="cuda"):
        full_f32_matmul()
        self.mesh, self.axis = mesh, axis
        self.group, self.shard, self.n_shards = axis_group(mesh, axis)
        self.device = resolve_device(device)
        t = shard_fused_index(fidx, self.n_shards, embeddings)
        self.slab = rank_slab(t, self.shard, self.device)

    def local_pool(self, q: torch.Tensor, kk: int):
        """Kernel 1 over the rank's slab: the exact top-``kk`` columns by
        ``[q, q^2] @ GT + c`` -> (scores (B, kk), columns (B, kk)),
        invalid columns -inf."""
        sl = self.slab
        qq = fused_topk.query_terms(q, sl.GT.dtype)
        top, rows = fused_topk.merge(*fused_topk.slab_topk(
            qq, sl.GT, sl.c, sl.valid, min(kk, fused_topk.SLAB)), kk)
        top = torch.where(top > fused_topk.NEG / 2, top,
                          torch.full_like(top, _NEG_INF))
        return top, rows.long()

    def local_rerank(self, qs: torch.Tensor, top: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
        """Kernel 5 on the rank's stored rows: ``-||q - x||^2`` (B, kk)."""
        return _rerank_keys(self.slab.emb, qs, rows, top)

    def query_topk(self, queries, k: int, rerank: int = 0,
                   approx: bool = False, queries_store=None):
        """(B, D) queries -> (scores (B, k), global ids (B, k)) as numpy,
        the same on every rank.  ``approx`` takes the exact pool."""
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        kk = min(max(k, rerank), self.slab.width)
        top, rows = self.local_pool(q, kk)
        if rerank and self.slab.emb.shape[-1] > 0:
            qs = q if queries_store is None else torch.as_tensor(
                np.atleast_2d(np.asarray(queries_store, np.float32)),
                device=self.device)
            top = self.local_rerank(qs, top, rows)
        s, ids = collectives.merge_topk(top, self.slab.sid[rows], k,
                                        self.group)
        return s.cpu().numpy(), ids.cpu().numpy()


class TPPredictionIndex:
    """One tree's prediction index split over a mesh axis (query
    facade)."""

    def __init__(self, index: PredictionIndex, mesh: DeviceMesh,
                 axis: str = "shard", embeddings=None, device="cuda"):
        """``embeddings``: optional (S, De) stored rows, for the exact
        cross-shard re-rank (``shard_index``)."""
        full_f32_matmul()
        self.mesh, self.axis = mesh, axis
        self.group, self.shard, self.n_shards = axis_group(mesh, axis)
        self.device = resolve_device(device)
        self.tpidx = place(shard_index(index, self.n_shards, embeddings),
                           mesh, axis, self.device)

    def _queries(self, queries) -> torch.Tensor:
        """The queries zero-padded to the shards' D (``K * D/K``): a
        rank's slice of an unpadded query would miss the padded rows'
        zeros, and the last ranks would read past it."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        Dp = self.n_shards * self.tpidx.ivt.shape[0]
        q = np.pad(q, ((0, 0), (0, Dp - q.shape[1])))
        return torch.as_tensor(q, device=self.device)

    def query_topk(self, queries, k: int, rerank: int = 0,
                   queries_store=None):
        """(B, D) queries -> (scores (B, k), global ids (B, k)) as numpy,
        the same on every rank."""
        q = self._queries(queries)
        qs = None if queries_store is None else torch.as_tensor(
            np.atleast_2d(np.asarray(queries_store, np.float32)),
            device=self.device)
        s, ids = _tp_query(self.tpidx, q, k, rerank, self.shard, self.group,
                           qs)
        return s.cpu().numpy(), ids.cpu().numpy()
