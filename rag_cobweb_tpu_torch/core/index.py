"""Serving indexes: the prediction, fused, blocked and beam subsets of
``rag_cobweb_tpu/core/index.py``.

**Flat prediction index** (``PredictionIndex``, ``build_index`` for one
tree, ``build_flat_forest_index`` for a forest): the K-lane state (K = 1
for a single tree) compacted in one multi-root BFS, with per-sentence root->leaf paths, per-hop weights and
the sentences laid out in DFS (lexicographic path) order.  The structure
pass is host numpy over the ``children``/``parent`` arrays, copied once;
the node statistics are gathered on the device.  The host copies of
paths, weights and order stay on the index as plain fields, for the
blocked build.

**Blocked index** (``BlockedIndex``, ``build_blocked_index``): sentences
in blocks of ``TS`` in that layout, each block with its own dense copy of
the nodes its paths touch, so a query is three batched products:

    nlp[b, s, m]   = q[b] . movt[s, m] - 0.5 q^2[b] . ivt[s, m] + const[s, m]
    score[b, s, t] = sum_m nlp[b, s, m] * W[s, m, t]

``blocked_query_topk`` is that product in PyTorch (the JAX package leaves
it to XLA), and ``blocked_query_topk_rerank`` re-ranks its pool by leaf
log-prob; the hand kernel behind the blocked engine is
``ops/blocked_topk``.

**Fused index**: the path score of sentence t is linear in its path nodes' log-prob terms,
so it folds into per-sentence coefficients:

    score[b, t] = q_b . A_t - 0.5 q_b^2 . B_t + c_t
    A_t = sum_p w[t,p] mu/var[path(t,p)],  B_t = sum_p w[t,p] 1/var[...],
    c_t = sum_p w[t,p] const[...]

Stacking ``GT = [A | -0.5 B]^T`` (2D, Sp) makes the corpus sweep one
``[q, q^2] @ GT`` product plus a bias.  Rows are padded to
``_FUSED_ROW_BUCKET``; padding rows are invalid and score -inf.

Serving (``fused_query_rerank``) runs two hand-written kernels: the sweep
with its exact top-c pool (``ops/fused_topk.pool_sweep`` and
``pool_select``: per-slab top-kappa pools, kappa = min(c, 2048), merged by
``torch.topk``, or at
scale the pruned path, whose second sweep keeps only the rows at or above
a bound from a group-max pass), then the exact stored-embedding re-rank
(``ops/rerank``), whose top-k is ``torch.topk``.
With a backstop (``backstop_topk``: kernel 1 again, over the whitened
store) the two pools are united (``union_candidates``) before the
re-rank.  Rows added since the index was built are scored apart, by the
same fresh-leaf key: ``pending_leaf_lp`` (tier 0, kernel 5) and
``delta_exact_topk`` (tier 1, one product).  ``grouped_pool_topk`` (a
strided two-level pool of a score matrix) is the JAX package's
alternative to an approximate pool; nothing calls it, since kernel 1's
pools are exact.  The serving stages are spans (``utils/profiling``):
``engine.sweep``, ``engine.merge`` (each pool's merge or final
selection, attribute ``pool``), ``engine.backstop``, ``engine.union``,
``engine.rerank`` and inside it ``engine.topk``, each timed on the
stream.

**Beam search** (``predict``): ``beam_search_topk`` is the oracle (every
beam node's full child row a level); the packed beam
(``build_beam_index``, ``beam_pack_topk``, ``beam_pack_topk_lanes``)
scores one row ``[mu/var | -0.5/var]`` a node and packs each frontier's
child runs (children are consecutive compact ids) into a fixed budget by
a row-wise ``searchsorted``; ``leaf_runs_to_sids`` expands the ranked
leaves into sentence ids.  The JAX package leaves these to XLA, so here
they are plain PyTorch: gathers, ``bmm`` at full f32 and stable sorts
(``topk_stable``), so ties keep the JAX order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from rag_cobweb_tpu_torch.ops import fused_topk, rerank
from rag_cobweb_tpu_torch.ops.gaussian import batched_node_log_probs
from rag_cobweb_tpu_torch.utils import profiling

DEFAULT_LEVEL_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
_FUSED_ROW_BUCKET = fused_topk.SLAB   # 2048


class PredictionIndex(NamedTuple):
    """Flat query index over the compacted forest (rebuilt after adds)."""

    inv_var_T: torch.Tensor      # (D, N) f32 GEMM terms
    mu_over_var_T: torch.Tensor  # (D, N) f32
    const: torch.Tensor          # (N,) f32
    paths: torch.Tensor          # (S, P) compact node ids root->leaf, -1 pad
    path_weights: torch.Tensor   # (S, P) level_weight[d]/path_len, 0 on pad
    children: torch.Tensor       # (N, F) compact child ids (BFS), -1 pad
    leaf_sentence_start: torch.Tensor  # (N,) first layout row of a leaf, -1
    leaf_sentence_count: torch.Tensor  # (N,)
    sentence_order: torch.Tensor  # (S,) sentence ids in DFS leaf layout
    paths_h: np.ndarray          # host copies of paths, path_weights and
    weights_h: np.ndarray        # sentence_order: the blocked build's input
    order_h: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.const.shape[0]

    @property
    def num_sentences(self) -> int:
        return self.paths.shape[0]


def host_structure(st):
    """Host copies of the state's ``children`` (K, cap, F), ``parent`` (K,
    cap) and ``root`` (K,): the input of the structure pass."""
    cap = st.capacity
    return (st.children[:, :cap].cpu().numpy(),
            st.parent[:, :cap].cpu().numpy(), st.root.cpu().numpy())


def build_flat_forest_index(cfg, st, leaf_global: np.ndarray,
                            level_weights: Sequence[float]
                            = DEFAULT_LEVEL_WEIGHTS,
                            pad_depth_to: int = 4,
                            host_struct=None) -> PredictionIndex:
    """ONE PredictionIndex over a stacked K-lane forest state.

    Lane l's node ids are offset by ``l * capacity`` (``leaf_global[s]``
    is ``lane * capacity + local_leaf``) and a multi-root level-synchronous
    BFS numbers every lane's live nodes at once.  Paths come from a
    vectorised parent chase; the sentence layout is the lexicographic
    order of the root->leaf paths, which keeps same-leaf runs and whole
    subtrees contiguous (it decides which sentences share a block of the
    blocked index, and so its M).  Structure and layout are host numpy and
    equal the JAX package's; statistics are gathered on the device.
    ``host_struct``: the state's ``host_structure``, when the caller holds
    it already."""
    cap, K = st.capacity, st.lanes
    children_h, parent_h, root_h = host_struct or host_structure(st)
    offs = (np.arange(K, dtype=np.int64) * cap)[:, None, None]
    children = np.where(children_h >= 0, children_h + offs, -1) \
        .reshape(K * cap, -1)
    parent = np.where(parent_h >= 0, parent_h + offs[:, :, 0], -1) \
        .reshape(K * cap)
    roots = np.arange(K, dtype=np.int64) * cap + root_h

    # level-synchronous BFS: one gather of the children table per level
    # (row-major ravel keeps parents in frontier order, siblings in slot
    # order)
    levels = [roots]
    while True:
        kids = children[levels[-1]].ravel()
        kids = kids[kids >= 0]
        if kids.size == 0:
            break
        levels.append(kids)
    order_arr = np.concatenate(levels)
    compact_of = np.full((K * cap,), -1, np.int64)
    compact_of[order_arr] = np.arange(len(order_arr))
    n_live = len(order_arr)
    max_depth = len(levels) - 1
    P = max(1, -(-(max_depth + 1) // pad_depth_to) * pad_depth_to)

    # per-sentence root->leaf paths by parent chasing
    S = len(leaf_global)
    leaf_compact = compact_of[np.asarray(leaf_global, np.int64)]
    if np.any(leaf_compact < 0):
        bad = np.where(leaf_compact < 0)[0]
        raise ValueError(f"sentences {bad[:5]} map to dead tree nodes")
    parent_compact = np.full((n_live,), -1, np.int64)
    live_parents = parent[order_arr]
    has_parent = live_parents >= 0
    parent_compact[has_parent] = compact_of[live_parents[has_parent]]
    lw = np.ones((P,), np.float32)
    lw[:min(len(level_weights), P)] = np.asarray(
        list(level_weights)[:P], np.float32)
    chains = np.full((S, P), -1, np.int64)           # leaf -> root
    cur = leaf_compact.copy()
    for p in range(P):
        chains[:, p] = cur
        cur = np.where(cur >= 0, parent_compact[np.maximum(cur, 0)], -1)
    path_len = (chains >= 0).sum(1)
    src = path_len[:, None] - 1 - np.arange(P)[None, :]
    paths = np.where(src >= 0,
                     chains[np.arange(S)[:, None], np.maximum(src, 0)],
                     -1).astype(np.int32)
    weights = np.where(
        paths >= 0, lw[None, :] / np.maximum(path_len, 1)[:, None], 0.0
    ).astype(np.float32)

    # DFS (lexicographic path) sentence layout and per-leaf runs
    sent_order = np.lexsort(
        tuple(paths[:, p] for p in range(P - 1, -1, -1))).astype(np.int32)
    leaf_start = np.full((n_live,), -1, np.int32)
    leaf_count = np.zeros((n_live,), np.int32)
    uniq, starts, counts = np.unique(leaf_compact[sent_order],
                                     return_index=True, return_counts=True)
    leaf_start[uniq] = starts
    leaf_count[uniq] = counts
    kids = children[order_arr]
    kids_compact = np.where(kids >= 0, compact_of[np.maximum(kids, 0)], -1)

    # node statistics gathered on the device, in compact order (compressed
    # stats upcast to f32)
    dev = st.device
    order_t = torch.as_tensor(order_arr, device=dev)
    lane, loc = order_t // cap, order_t % cap
    cnt = st.counts[lane, loc]
    mu = st.means[lane, loc].float()
    m2 = st.m2s[lane, loc].float()
    pos = (cnt > 0).unsqueeze(1)
    pv = float(cfg.prior_var)
    ml = m2 / torch.where(cnt > 0, cnt, torch.ones_like(cnt)).unsqueeze(1)
    v = torch.clamp(ml, min=pv) if cfg.acuity_cutoff else ml + pv
    v = torch.where(pos, v, torch.full_like(v, pv))
    inv = 1.0 / v
    const = -0.5 * (torch.sum(torch.square(mu) * inv, dim=1)
                    + torch.sum(torch.log(v), dim=1))

    def up(a):
        return torch.as_tensor(a, device=dev)

    return PredictionIndex(
        inv_var_T=inv.T.contiguous(),
        mu_over_var_T=(mu * inv).T.contiguous(),
        const=const,
        paths=up(paths.astype(np.int64)),
        path_weights=up(weights),
        children=up(kids_compact),
        leaf_sentence_start=up(leaf_start.astype(np.int64)),
        leaf_sentence_count=up(leaf_count.astype(np.int64)),
        sentence_order=up(sent_order.astype(np.int64)),
        paths_h=paths, weights_h=weights, order_h=sent_order)


def build_index(tree, leaf_of_sentence,
                level_weights: Sequence[float] = DEFAULT_LEVEL_WEIGHTS,
                pad_depth_to: int = 4) -> PredictionIndex:
    """The PredictionIndex of one tree (``core/tree.CobwebTree``):
    ``leaf_of_sentence[s]`` is the tree slot of sentence s's leaf.  A
    single tree is a one-lane state whose lane offset is 0, so its slot
    ids are the flat builder's global ids and its one root starts the
    BFS: the JAX ``build_index`` (``_build_index_from_arrays`` with one
    root), array for array."""
    if tree.state.lanes != 1:
        raise ValueError(f"build_index takes one tree, got "
                         f"{tree.state.lanes} lanes")
    return build_flat_forest_index(
        tree.cfg, tree.state, np.asarray(leaf_of_sentence, np.int64),
        level_weights, pad_depth_to)


def path_scores_from_nlp(paths: torch.Tensor, path_weights: torch.Tensor,
                         nlp: torch.Tensor) -> torch.Tensor:
    """Weighted path sum: (B, N) node log-probs -> (B, S) sentence
    scores, one gather per hop (P is small)."""
    safe = paths.clamp(min=0)
    acc = torch.zeros((nlp.shape[0], paths.shape[0]), dtype=torch.float32,
                      device=nlp.device)
    for p in range(paths.shape[1]):
        acc = acc + nlp[:, safe[:, p]] * path_weights[:, p].unsqueeze(0)
    return acc


def rank_scores(index: PredictionIndex, queries: torch.Tensor):
    """Per-sentence path scores of a (B, D) query batch -> (B, S): each
    node's Gaussian log-prob summed with its level weight along every
    sentence's root->leaf path.  Plain autograd: differentiable in the
    queries (and the index terms)."""
    nlp = batched_node_log_probs(queries, index.inv_var_T,
                                 index.mu_over_var_T, index.const)
    return path_scores_from_nlp(index.paths, index.path_weights, nlp)


def query_topk(index: PredictionIndex, queries: torch.Tensor, k: int,
               generator: "torch.Generator | None" = None):
    """Top-k path scores -> (scores (B, k), sentence ids (B, k)).  The JAX
    package computes this in XLA, so here it is plain PyTorch: the
    products, the path gather and ``torch.topk``.  ``generator`` adds the
    reference's 1e-6 Gaussian tie noise (the JAX ``noise_key``)."""
    scores = rank_scores(index, queries)
    if generator is not None:
        scores = scores + 1e-6 * torch.randn(
            scores.shape, generator=generator, device=scores.device)
    return torch.topk(scores, min(k, scores.shape[1]), dim=1)


def query_topk_rerank(index: PredictionIndex, queries: torch.Tensor, k: int,
                      rerank: int = 128):
    """Path-score top-``rerank`` pool re-ranked by leaf log-prob, then the
    final top-k -> (scores (B, k), ids (B, k))."""
    scores = rank_scores(index, queries)
    c = min(max(rerank, k), scores.shape[1])
    cand_scores, cand = torch.topk(scores, c, dim=1)
    return _leaf_lp_rerank(index, queries, cand, cand_scores, min(k, c))


def _sentence_leaf_nodes(index: PredictionIndex) -> torch.Tensor:
    """(S,) compact node id of each sentence's leaf (deepest path entry)."""
    plen = (index.paths >= 0).sum(dim=1)
    return index.paths.gather(1, (plen - 1).clamp(min=0).unsqueeze(1))[:, 0]


def _leaf_lp_rerank(index: PredictionIndex, queries: torch.Tensor,
                    cand: torch.Tensor, cand_scores: torch.Tensor, k: int):
    """Re-rank (B, C) candidate sentences by their LEAF log-probability
    (the key the beam search ranks by); non-finite candidates drop.  The
    re-rank of the engines when no vector store is kept.  Returns
    (scores (B, k), ids (B, k))."""
    leaves = _sentence_leaf_nodes(index)[cand.long()]      # (B, C)
    ivt = index.inv_var_T.T[leaves]                        # (B, C, D)
    movt = index.mu_over_var_T.T[leaves]
    x = queries.float().unsqueeze(1)
    lp = (torch.sum(x * movt, -1) - 0.5 * torch.sum(torch.square(x) * ivt, -1)
          + index.const[leaves])
    lp = torch.where(torch.isfinite(cand_scores), lp,
                     torch.full_like(lp, float("-inf")))
    top, pos = torch.topk(lp, k, dim=1)
    return top, cand.gather(1, pos)


def pad_width(x: torch.Tensor, D: int) -> torch.Tensor:
    """``x`` with its last dimension zero-padded to ``D``.  A blocked index
    keeps its width a multiple of 8 (the blocked kernel loads rows of
    16-byte multiples); zero columns, in the queries too, add nothing."""
    if x.shape[-1] >= D:
        return x
    return torch.nn.functional.pad(x, (0, D - x.shape[-1]))


class BlockedIndex(NamedTuple):
    """Block-local dense form of the prediction index: per block of ``TS``
    sentences, its own copy of the GEMM terms of the ``M`` (padded) nodes
    its paths touch and the dense path weights over them."""

    ivt_b: torch.Tensor        # (NB, M, D) inverse variances, D % 8 == 0
    movt_b: torch.Tensor       # (NB, M, D) mean / variance
    const_b: torch.Tensor      # (NB, M) f32
    W: torch.Tensor            # (NB, M, TS) local path weights
    valid: torch.Tensor        # (NB, TS) bool, False on padding slots
    sid_of_slot: torch.Tensor  # (NB, TS) int32 slot -> sentence id


def build_blocked_index(index: PredictionIndex, block_size: int = 512,
                        node_pad: int = 128,
                        dtype=torch.float32) -> BlockedIndex:
    """The blocked form of a flat index: host batched unique over every
    block's path entries (from the index's host copies), the W scatter and
    the stats gather on the device.  ``M`` is the largest per-block node
    count rounded up to ``node_pad``; pad node rows carry ``ivt=1,
    movt=0, const=0`` and a zero W row, so they add nothing; D is
    zero-padded to a multiple of 8 (``pad_width``).  A bf16 ``dtype``
    halves the sweep's bytes; pair it with a re-rank."""
    paths, weights, order = index.paths_h, index.weights_h, index.order_h
    S, P = paths.shape
    TS = block_size
    NB = max(1, -(-S // TS))
    order_pad = np.full((NB * TS,), -1, np.int64)
    order_pad[:S] = order
    valid = (order_pad >= 0).reshape(NB, TS)
    sid_of_slot = np.maximum(order_pad, 0).reshape(NB, TS)
    rows = np.maximum(order_pad, 0)[:, None]
    hops = np.arange(P)[None, :]
    bp = np.where(valid.reshape(-1, 1), paths[rows, hops], -1)
    bw = np.where(valid.reshape(-1, 1), weights[rows, hops], 0.0)
    flat = bp.reshape(NB, TS * P).astype(np.int32)    # -1 = padding

    # batched per-block unique: sort each row, mark firsts, rank by cumsum
    SENT = np.iinfo(np.int32).max
    keyed = np.where(flat >= 0, flat, SENT)
    ord_idx = np.argsort(keyed, axis=1, kind="stable")
    skey = np.take_along_axis(keyed, ord_idx, 1)
    is_new = np.empty_like(skey, dtype=bool)
    is_new[:, 0] = skey[:, 0] != SENT
    is_new[:, 1:] = (skey[:, 1:] != skey[:, :-1]) & (skey[:, 1:] != SENT)
    local_sorted = np.cumsum(is_new, axis=1) - 1
    m_per_block = is_new.sum(1)
    M = -(-max(int(m_per_block.max(initial=1)), 1) // node_pad) * node_pad
    nodes_pad = np.zeros((NB, M), np.int64)
    rows_b, cols_b = np.nonzero(is_new)
    nodes_pad[rows_b, local_sorted[rows_b, cols_b]] = skey[rows_b, cols_b]
    local = np.empty_like(local_sorted)
    np.put_along_axis(local, ord_idx, np.maximum(local_sorted, 0), 1)
    local = local.reshape(NB, TS, P)
    ok = bp.reshape(NB, TS, P) >= 0

    # W: one scatter-add on the device (each (block, node, slot) is hit at
    # most once: a path visits a node once)
    dev = index.const.device
    blk_i, slot_i, hop_i = np.nonzero(ok)
    flat_idx = (blk_i * M + local[blk_i, slot_i, hop_i]) * TS + slot_i
    W = torch.zeros((NB * M * TS,), dtype=torch.float32, device=dev)
    W.index_add_(0, torch.as_tensor(flat_idx, device=dev),
                 torch.as_tensor(bw.reshape(NB, TS, P)[ok].astype(
                     np.float32), device=dev))

    # per-block replicas of the node terms, gathered on the device
    nodes = torch.as_tensor(nodes_pad, device=dev)
    pad = torch.as_tensor(np.arange(M)[None, :] >= m_per_block[:, None],
                          device=dev)
    ivt_b = torch.where(pad.unsqueeze(2), 1.0, index.inv_var_T.T[nodes])
    movt_b = torch.where(pad.unsqueeze(2), 0.0, index.mu_over_var_T.T[nodes])
    const_b = torch.where(pad, 0.0, index.const[nodes])
    D8 = -(-ivt_b.shape[2] // 8) * 8
    ivt_b, movt_b = pad_width(ivt_b, D8), pad_width(movt_b, D8)
    return BlockedIndex(
        ivt_b=ivt_b.to(dtype).contiguous(),
        movt_b=movt_b.to(dtype).contiguous(),
        const_b=const_b.contiguous(),
        W=W.view(NB, M, TS).to(dtype),
        valid=torch.as_tensor(valid, device=dev),
        sid_of_slot=torch.as_tensor(sid_of_slot.astype(np.int32),
                                    device=dev))


def blocked_scores(bidx: BlockedIndex, queries: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, NB, TS) f32 path scores, padding slots -inf.

    The JAX package contracts bf16 operands with f32 results
    (``preferred_element_type``); a bf16 ``torch.matmul`` would round its
    output to bf16, so the operands are upcast to f32 first (their
    products are exact in f32).  ``nlp`` is rounded to the W dtype before
    the second product, as in the JAX package.  f32 operands need TF32 off
    on the card (``device.full_f32_matmul``)."""
    dt = bidx.ivt_b.dtype
    q = pad_width(queries, bidx.ivt_b.shape[2]).to(dt)
    nlp = (torch.einsum("bd,smd->sbm", q.float(), bidx.movt_b.float())
           - 0.5 * torch.einsum("bd,smd->sbm", torch.square(q).float(),
                                bidx.ivt_b.float())
           + bidx.const_b.unsqueeze(1))                    # (NB, B, M)
    scores = torch.einsum("sbm,smt->bst", nlp.to(bidx.W.dtype).float(),
                          bidx.W.float())
    return torch.where(bidx.valid.unsqueeze(0), scores,
                       torch.full_like(scores, float("-inf")))


def blocked_query_topk(bidx: BlockedIndex, queries: torch.Tensor, k: int):
    """Top-k over the blocked scores -> (scores (B, k) f32, sentence ids
    (B, k) int32).  The selection is exact (``torch.topk``): the JAX
    package may select a re-rank pool with ``approx_max_k``, which PyTorch
    lacks."""
    scores = blocked_scores(bidx, queries)
    B, NB, TS = scores.shape
    top, pos = torch.topk(scores.reshape(B, NB * TS), min(k, NB * TS), dim=1)
    return top, bidx.sid_of_slot.reshape(-1)[pos]


def blocked_query_topk_rerank(bidx: BlockedIndex, index: PredictionIndex,
                              queries: torch.Tensor, k: int,
                              rerank: int = 128):
    """The blocked sweep's top-``max(rerank, k)`` pool (``blocked_scores``
    in PyTorch, as XLA computes it in the JAX package) re-ranked by leaf
    log-prob on ``index``, then the final top-k -> (scores (B, k), ids
    (B, k))."""
    scores = blocked_scores(bidx, queries)
    B, NB, TS = scores.shape
    c = min(max(rerank, k), NB * TS)
    cand_scores, pos = torch.topk(scores.reshape(B, NB * TS), c, dim=1)
    cand = bidx.sid_of_slot.reshape(-1)[pos]
    return _leaf_lp_rerank(index, queries, cand, cand_scores, min(k, c))


class FusedIndex(NamedTuple):
    GT: torch.Tensor     # (2D, Sp) [A | -0.5 B]^T, serving dtype
    c: torch.Tensor      # (Sp,) f32 bias, 0 on padding rows
    valid: torch.Tensor  # (Sp,) bool, False on padding rows

    @property
    def num_slots(self) -> int:
        return self.c.shape[0]


def build_fused_index(index: PredictionIndex,
                      dtype=torch.float32) -> FusedIndex:
    """The fused form of a built PredictionIndex (the single tree's route
    to the fused sweep): the per-sentence coefficients accumulated in
    float32 with one (S,)-row gather per path hop, cast to ``dtype`` at
    the end; rows padded to the 2048-row bucket."""
    S, P = index.paths.shape
    D = index.inv_var_T.shape[0]
    dev = index.const.device
    Sp = -(-max(S, 1) // _FUSED_ROW_BUCKET) * _FUSED_ROW_BUCKET
    movt, ivt = index.mu_over_var_T.T, index.inv_var_T.T
    A = torch.zeros((S, D), dtype=torch.float32, device=dev)
    Bm = torch.zeros((S, D), dtype=torch.float32, device=dev)
    c = torch.zeros((S,), dtype=torch.float32, device=dev)
    for p in range(P):
        ids = index.paths[:, p]
        safe = ids.clamp(min=0)
        w = torch.where(ids >= 0, index.path_weights[:, p],
                        torch.zeros_like(index.path_weights[:, p]))
        A = A + w.unsqueeze(1) * movt[safe]
        Bm = Bm + w.unsqueeze(1) * ivt[safe]
        c = c + w * index.const[safe]
    GT = torch.zeros((2 * D, Sp), dtype=dtype, device=dev)
    GT[:, :S] = torch.cat([A, -0.5 * Bm], dim=1).T.to(dtype)
    cp = torch.zeros((Sp,), dtype=torch.float32, device=dev)
    cp[:S] = c
    return FusedIndex(GT=GT, c=cp,
                      valid=torch.arange(Sp, device=dev) < S)


def _fused_block_from_state(st, leaf_block: torch.Tensor, lw: torch.Tensor,
                            P: int, prior_var: float, acuity: bool):
    """One sentence block: chase each leaf's parent chain in global slot
    space (lane * capacity + local), derive each node's GEMM terms from
    the raw statistics (upcast to f32 when compressed) and accumulate the
    fused coefficients.  Returns
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
        mu = st.means[lane, loc].float()
        m2 = st.m2s[lane, loc].float()
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


def fused_scores(fidx: FusedIndex, queries: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, Sp) f32 path scores (f32 operands and accumulation;
    padding rows -inf).  Reference form for tests: serving never
    materialises this matrix."""
    qq = fused_topk.query_terms(queries, fidx.GT.dtype)
    return fused_topk.slab_scores_plain(qq, fidx.GT, fidx.c, fidx.valid,
                                        float("-inf")).reshape(len(qq), -1)


def fused_query_topk(fidx: FusedIndex, queries: torch.Tensor, k: int):
    """Top-k path scores -> (scores (B, k) f32, sentence ids (B, k) int32):
    kernel 1's exact pool (``fused_topk.pool_sweep``: per-slab pools merged
    by ``torch.topk``, or the pruned path's survivors sorted), its sweep
    under ``engine.sweep`` and its merge or final selection under
    ``engine.merge``."""
    dev = queries.device
    with profiling.span("engine.sweep", device=dev, B=queries.shape[0],
                        slots=fidx.GT.shape[1]):
        qq = fused_topk.query_terms(queries, fidx.GT.dtype)
        pend = fused_topk.pool_sweep(qq, fidx.GT, fidx.c, fidx.valid, k)
    with profiling.span("engine.merge", device=dev, pool="sweep", k=k):
        return fused_topk.pool_select(pend)


# The JAX package would switch its pool selection to the strided two-level
# reduction below from this many columns, and no index reaches it; kernel 1
# selects the port's pools exactly, so nothing calls ``grouped_pool_topk``.
_GROUPED_POOL_MIN_COLS = 1 << 62
_GROUP = 16


def grouped_pool_topk(scores: torch.Tensor, k: int, group: int = _GROUP):
    """A candidate POOL of ``k`` by a strided two-level reduction ->
    (scores (B, k) f32, ids (B, k)).  Pass 1 views the (B, Sp) scores as
    ``group`` interleaved column blocks (column i of the reduced matrix
    covers ids i, i + Sp/g, i + 2 Sp/g, ...) and takes the max and its
    member; pass 2 is the exact top-k of the reduced matrix, mapped back
    through the member.  A true top-k id is dropped only when a higher
    score shares its strided group (the stride keeps near-duplicates, which
    sit on adjacent ids, in separate groups).

    The member comes from ``torch.max``'s exact argmax (the first maximal
    one), so each returned score is ``scores[b, id]`` bit for bit.  The JAX
    package packs the member into the low mantissa bits of a uint32 key and
    takes one max, which can pair a score with another member's id when
    two members lie within 2^-19 of each other."""
    B, Sp = scores.shape
    g = group
    while Sp % g:
        g //= 2
    if g <= 1 or k >= Sp // g:
        return torch.topk(scores.float(), min(k, Sp), dim=1)
    cols = Sp // g
    gmax, member = torch.max(scores.float().view(B, g, cols), dim=1)
    top, pos = torch.topk(gmax, k, dim=1)
    return top, member.gather(1, pos) * cols + pos


def exact_rerank(emb: torch.Tensor, queries: torch.Tensor,
                 cand: torch.Tensor, cand_scores: torch.Tensor, k: int,
                 prior_var: float = 1.0):
    """Re-rank (B, C) candidates by the fresh-leaf closed form on their
    stored rows (kernel 5; an f32 or a bf16 store, distances in f32),
    ``-0.5 (||q - x||^2 / prior_var + D log prior_var)``, non-finite
    candidates dropped -> (scores, ids) (B, k)."""
    dev = queries.device
    with profiling.span("engine.rerank", device=dev, candidates=cand.shape[1]):
        lp = rerank.rerank_lp(emb, queries.float().contiguous(),
                              cand.to(torch.int32).contiguous(),
                              cand_scores.contiguous(), prior_var)
        with profiling.span("engine.topk", device=dev):
            top, pos = torch.topk(lp, k, dim=1)
            return top, cand.gather(1, pos)


def backstop_topk(wemb: torch.Tensor, half_norm2: torch.Tensor,
                  queries: torch.Tensor, c: int, n_valid: int,
                  gt_layout: bool):
    """The proximity backstop pool: the top-``c`` stored rows by
    ``q . w - 0.5 ||w||^2`` (monotone in the L2 distance to ``q``), rows at
    or past ``n_valid`` -inf -> (scores (B, c) f32, row ids (B, c)).

    The store's layout decides the route, not its dtype.  ``gt_layout``:
    the whitened store in kernel 1's GT layout, bf16 (Dw, Sw) with Sw a
    multiple of 2048: kernel 1 runs with ``qq = q`` in bf16 and ``c =
    -half_norm2``, and its pool (``fused_topk.pool_sweep``) is the exact
    top-c, so the (B, Sw) scores never reach memory; invalid entries come
    out -inf.
    Otherwise the raw re-rank store, row-major (Sw, D), f32 or bf16, which
    kernel 1 cannot take without a copy: the queries rounded to the
    store's dtype, a full-f32 product (bf16 rows widened a slab at a time)
    and ``torch.topk``, as the JAX package's product with f32 results.
    The pool is exact where the JAX package may take ``approx_max_k``."""
    dev = wemb.device
    if gt_layout:
        Sw = wemb.shape[1]
        valid = torch.arange(Sw, device=dev) < n_valid
        n0 = profiling.counter("launch.slab_topk")
        pend = fused_topk.pool_sweep(
            queries.to(torch.bfloat16).contiguous(), wemb, -half_norm2,
            valid, c)
        profiling.count("launch.backstop",
                        profiling.counter("launch.slab_topk") - n0)
        with profiling.span("engine.merge", device=dev, pool="backstop",
                            k=c):
            top, ids = fused_topk.pool_select(pend)
        return torch.where(top > fused_topk.NEG / 2, top,
                           torch.full_like(top, float("-inf"))), ids
    q = queries.to(wemb.dtype).float()
    if wemb.dtype == torch.float32:
        s = torch.matmul(q, wemb.T)
    else:
        step = 1 << 16
        s = torch.cat([torch.matmul(q, wemb[r:r + step].float().T)
                       for r in range(0, wemb.shape[0], step)], dim=1)
    s = s - half_norm2
    col = torch.arange(s.shape[1], device=dev)
    s = torch.where(col < n_valid, s, torch.full_like(s, float("-inf")))
    return torch.topk(s, min(c, s.shape[1]), dim=1)


_UNION_SENTINEL = 2**31 - 1


def union_candidates(cand_a: torch.Tensor, cs_a: torch.Tensor,
                     cand_b: torch.Tensor, cs_b: torch.Tensor):
    """Two candidate pools as one (B, Ca + Cb) set sorted by id, duplicate
    ids and dead entries (-inf) at -inf, so the union feeds the re-rank
    (which drops non-finite entries) without ranking a row twice.  Dead
    entries first take a sentinel id, so they never collide with a live
    one; the sentinel becomes id 0 at the end -> (cand int32, scores)."""
    cand = torch.cat([cand_a.to(torch.int32), cand_b.to(torch.int32)], 1)
    cs = torch.cat([cs_a.float(), cs_b.float()], dim=1)
    cand = cand.masked_fill(~torch.isfinite(cs), _UNION_SENTINEL)
    cand, order = torch.sort(cand, dim=1, stable=True)
    dead = cand == _UNION_SENTINEL
    dead[:, 1:] |= cand[:, 1:] == cand[:, :-1]
    cs = cs.gather(1, order).masked_fill(dead, float("-inf"))
    return cand.masked_fill(cand == _UNION_SENTINEL, 0), cs


def fused_query_rerank(fidx: FusedIndex, emb: torch.Tensor,
                       queries: torch.Tensor, queries_store: torch.Tensor,
                       k: int, c: int, wemb: torch.Tensor = None,
                       half_norm2: torch.Tensor = None, n_valid: int = 0,
                       bs: int = 0, prior_var: float = 1.0,
                       gt_layout: bool = False):
    """The serving path: fused sweep -> exact top-``c`` pool [-> the
    top-``bs`` backstop pool over ``wemb``, in GT layout (``gt_layout``)
    or row-major (``backstop_topk``) -> union] -> exact stored-embedding
    re-rank -> (scores, ids) (B, k)."""
    cs, cand = fused_query_topk(fidx, queries, c)
    if bs:
        dev = queries.device
        with profiling.span("engine.backstop", device=dev, k=bs):
            bcs, bcand = backstop_topk(wemb, half_norm2, queries, bs,
                                       n_valid, gt_layout)
        with profiling.span("engine.union", device=dev):
            cand, cs = union_candidates(cand, cs, bcand, bcs)
    return exact_rerank(emb, queries_store, cand, cs, k, prior_var)


def pending_leaf_lp(queries: torch.Tensor, vecs: torch.Tensor,
                    rows: torch.Tensor, prior_var: float = 1.0):
    """Leaf log-probabilities of rows not in the serving index yet (tier
    0): a row added since the last build sits in a fresh leaf (count 1,
    mean the row, ML variance 0), so its key is exactly the re-rank's
    fresh-leaf closed form ``-0.5 (||q - x||^2 / prior_var + D log
    prior_var)``, in the diff form (the dot form's cancellation loses the
    margins between near-duplicates).  Kernel 5 computes it for
    ``vecs[rows]``, each query against every row, without the (B, Np, D)
    broadcast -> (B, Np) f32."""
    B = queries.shape[0]
    cand = rows.to(torch.int32).view(1, -1).expand(B, -1).contiguous()
    n0 = profiling.counter("launch.rerank_lp")
    lp = rerank.rerank_lp(vecs, queries.float().contiguous(), cand,
                          torch.zeros(cand.shape, dtype=torch.float32,
                                      device=cand.device), prior_var)
    profiling.count("launch.pending",
                    profiling.counter("launch.rerank_lp") - n0)
    return lp


def delta_exact_topk(queries: torch.Tensor, vecs: torch.Tensor,
                     n_valid: int, prior_var: float, k: int):
    """Top-k of the fresh-leaf closed form over the consolidated delta
    segment (tier 1), in the GEMM form ``||q||^2 - 2 q.v + ||v||^2`` (full
    float32, TF32 off on the card), rows at or past ``n_valid`` -inf ->
    (scores (B, k), row positions (B, k))."""
    q = queries.float()
    pv = torch.tensor(prior_var, dtype=torch.float32)   # host: no sync
    d2 = (torch.sum(torch.square(q), dim=1, keepdim=True)
          - 2.0 * torch.matmul(q, vecs.T)
          + torch.sum(torch.square(vecs), dim=1))
    lp = -0.5 * (d2 / float(pv) + float(q.shape[1] * torch.log(pv)))
    valid = torch.arange(vecs.shape[0], device=q.device) < n_valid
    lp = torch.where(valid, lp, torch.full_like(lp, float("-inf")))
    return torch.topk(lp, k, dim=1)


def _append_rows(buf: torch.Tensor, rows: torch.Tensor, start: int):
    """Write ``rows`` into ``buf`` from row ``start`` on, in place (the
    caller keeps the capacity); returns ``buf``."""
    buf[start:start + rows.shape[0]] = rows
    return buf


# --------------------------------------------------------------------------- #
# beam search: the reference's tree search (``predict``), batched            #
# --------------------------------------------------------------------------- #

_NEG = -3e38    # the beam's dead-slot score, as in the JAX package


def topk_stable(x: torch.Tensor, k: int):
    """Top-``k`` along the last axis with the lower index first among
    equal values (``jax.lax.top_k``'s order; ``torch.topk`` leaves ties
    unordered): a stable descending sort, cut at ``k``."""
    top, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return top[..., :k], pos[..., :k]


def _mask_leaves(leaf_count: torch.Tensor, nodes: torch.Tensor,
                 scores: torch.Tensor):
    """(nodes, scores) kept where the node is a leaf holding sentences;
    elsewhere node -1 and score ``_NEG``."""
    is_leaf = (nodes >= 0) & (leaf_count[nodes.clamp(min=0)] > 0)
    return (torch.where(is_leaf, nodes, torch.full_like(nodes, -1)),
            torch.where(is_leaf, scores, torch.full_like(scores, _NEG)))


def _stack_levels(segs: list, rows: int, width: int, like: torch.Tensor):
    """The per-level (rows, width) segments as (rows, levels, width)."""
    if not segs:
        return like.new_empty((rows, 0, width))
    return torch.stack(segs, dim=1)


def beam_search_topk(index: PredictionIndex, queries: torch.Tensor, k: int,
                     beam_width: int = 64, max_depth: int = 16):
    """Fixed-width beam search down the tree for a (B, D) query batch, the
    budget-unlimited oracle: each level expands every beam node's full
    fanout-padded child row, keeps the ``beam_width`` best children by
    node log-prob and emits those that are leaves -> (leaf scores (B, M),
    leaf nodes (B, M)), ranked, -1 past the live leaves.  The JAX
    package's gathers and sums, in plain PyTorch."""
    q = queries.float()
    B = q.shape[0]
    F = index.children.shape[1]
    W = beam_width
    movt, ivt = index.mu_over_var_T.T, index.inv_var_T.T
    x = q.unsqueeze(1)

    def node_lp(ids):
        safe = ids.clamp(min=0)
        return (torch.sum(x * movt[safe], -1)
                - 0.5 * torch.sum(torch.square(x) * ivt[safe], -1)
                + index.const[safe])

    nodes = torch.full((B, W), -1, dtype=torch.int64, device=q.device)
    nodes[:, 0] = 0                       # the compact root (BFS order)
    scores = torch.where(nodes >= 0, node_lp(nodes),
                         torch.full((B, W), _NEG, device=q.device))
    root_leaf = _mask_leaves(index.leaf_sentence_count, nodes, scores)
    seg_n, seg_s = [], []
    for _ in range(max_depth):
        kids = torch.where((nodes >= 0).unsqueeze(2),
                           index.children[nodes.clamp(min=0)],
                           torch.full((B, W, F), -1, dtype=torch.int64,
                                      device=q.device)).reshape(B, W * F)
        ks = torch.where(kids >= 0, node_lp(kids),
                         torch.full(kids.shape, _NEG, device=q.device))
        top, pos = topk_stable(ks, W)
        nodes = torch.where(top > _NEG / 2, kids.gather(1, pos),
                            torch.full_like(pos, -1))
        n, s = _mask_leaves(index.leaf_sentence_count, nodes, top)
        seg_n.append(n)
        seg_s.append(s)
    all_n = torch.cat([_stack_levels(seg_n, B, W, nodes).reshape(B, -1),
                       root_leaf[0]], dim=1)
    all_s = torch.cat([_stack_levels(seg_s, B, W, scores).reshape(B, -1),
                       root_leaf[1]], dim=1)
    cap = min(W * max_depth, W * max_depth // 2 + k)
    lscores, pos = topk_stable(all_s, cap)
    leaves = all_n.gather(1, pos)
    return lscores, torch.where(lscores > _NEG / 2, leaves,
                                torch.full_like(leaves, -1))


def leaves_to_sentence_ids(index, leaf_nodes, k: int) -> np.ndarray:
    """Ranked leaf nodes (B, L) -> the first ``k`` sentence ids a query,
    each leaf's run in layout order (the reference shuffles within a leaf;
    this keeps insertion order) -> (B, k) host int64, -1 padded.  Host
    numpy, as in the JAX package; ``index`` is a PredictionIndex or a
    BeamIndex."""
    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    starts, counts = host(index.leaf_sentence_start), \
        host(index.leaf_sentence_count)
    sorder = host(index.sentence_order)
    leaf_nodes = host(leaf_nodes)
    out = np.full((leaf_nodes.shape[0], k), -1, np.int64)
    safe = np.maximum(leaf_nodes, 0)
    c = np.where((leaf_nodes >= 0) & (starts[safe] >= 0), counts[safe], 0)
    s = starts[safe]
    off = np.cumsum(c, axis=1) - c
    take = np.clip(k - off, 0, c)
    for b, j in zip(*np.nonzero(take > 0)):
        t, o = take[b, j], off[b, j]
        out[b, o:o + t] = sorder[s[b, j]:s[b, j] + t]
    return out


class BeamIndex(NamedTuple):
    """The packed beam's structures, derived from a PredictionIndex: one
    stats row a node and each node's children as a run of compact ids."""

    pack: torch.Tensor          # (N, 2D) [mu/var | -0.5/var], f32 or bf16
    const: torch.Tensor         # (N,) f32
    child_start: torch.Tensor   # (N,) first child's compact id, -1
    child_count: torch.Tensor   # (N,)
    leaf_sentence_start: torch.Tensor  # (N,)
    leaf_sentence_count: torch.Tensor  # (N,)
    sentence_order: torch.Tensor       # (S,)

    @property
    def num_nodes(self) -> int:
        return self.const.shape[0]


# from this many nodes the pack is stored in bf16 (it is N x 2D); the
# products still accumulate in f32
_BEAM_PACK_BF16_NODES = 1 << 19


def build_beam_index(index: PredictionIndex, pack_dtype=None) -> BeamIndex:
    """The packed beam structures of a flat index.  A node's children are
    consecutive compact ids (each BFS level is the ravel of the previous
    level's children rows), so a child run starts at the least valid
    child.  ``pack_dtype`` None: f32 below 2^19 nodes, bf16 from there."""
    children = index.children
    valid = children >= 0
    child_count = valid.sum(dim=1)
    child_start = torch.where(valid, children,
                              torch.full_like(children, 2 ** 30)).min(
        dim=1).values
    child_start = torch.where(child_count > 0, child_start,
                              torch.full_like(child_start, -1))
    if pack_dtype is None:
        pack_dtype = (torch.bfloat16 if index.num_nodes
                      >= _BEAM_PACK_BF16_NODES else torch.float32)
    pack = torch.cat([index.mu_over_var_T.T, -0.5 * index.inv_var_T.T],
                     dim=1).to(pack_dtype).contiguous()
    return BeamIndex(pack=pack, const=index.const, child_start=child_start,
                     child_count=child_count,
                     leaf_sentence_start=index.leaf_sentence_start,
                     leaf_sentence_count=index.leaf_sentence_count,
                     sentence_order=index.sentence_order)


def _runs_pack(starts: torch.Tensor, counts: torch.Tensor, budget: int):
    """Per-row runs (start, count) (R, W) packed into ``budget``
    consecutive slots -> (ids (R, budget), valid (R, budget)): a row-wise
    ``searchsorted(side="right")`` over the inclusive cumsum finds each
    slot's run; runs past the budget are cut (rows come in beam-score
    order, so the worst parents' children go)."""
    W = counts.shape[1]
    cum = torch.cumsum(counts, dim=1).contiguous()
    off = cum - counts
    t = torch.arange(budget, dtype=cum.dtype, device=cum.device)
    j = torch.searchsorted(cum, t.expand(cum.shape[0], budget).contiguous(),
                           right=True)
    jc = j.clamp(max=W - 1)
    ids = starts.gather(1, jc) + (t - off.gather(1, jc))
    valid = (j < W) & (t < cum[:, -1:])
    return torch.where(valid, ids, torch.zeros_like(ids)), valid


def _pack_scores(bidx: BeamIndex, qq: torch.Tensor, cand: torch.Tensor):
    """(R, M) node log-probs ``[q, q^2] . pack[cand] + const[cand]`` for
    the query terms ``qq`` (R, 2D) (rounded to the pack's dtype): the rows
    gathered and upcast to f32, one batched product at full f32 (TF32 off
    on the card; a bf16 pack's products are exact in f32)."""
    rows = bidx.pack[cand].float()                       # (R, M, 2D)
    s = torch.bmm(rows, qq.unsqueeze(2)).squeeze(2)
    return s + bidx.const[cand]


def _beam_levels(bidx: BeamIndex, qq: torch.Tensor, nodes: torch.Tensor,
                 W: int, C: int, max_depth: int):
    """``max_depth`` levels of the packed beam from the frontier ``nodes``
    (R, W): each level packs the frontier's child runs into ``C`` slots,
    scores them and keeps the stable top-``W`` -> the levels' leaves and
    their scores, each (R, max_depth, W)."""
    R = nodes.shape[0]
    seg_n, seg_s = [], []
    for _ in range(max_depth):
        safe = nodes.clamp(min=0)
        st = bidx.child_start[safe]
        ct = torch.where((nodes >= 0) & (st >= 0), bidx.child_count[safe],
                         torch.zeros_like(st))
        cand, valid = _runs_pack(st, ct, C)
        s = torch.where(valid, _pack_scores(bidx, qq, cand),
                        torch.full(cand.shape, _NEG, device=cand.device))
        top, pos = topk_stable(s, W)
        nodes = torch.where(top > _NEG / 2, cand.gather(1, pos),
                            torch.full_like(pos, -1))
        n, sc = _mask_leaves(bidx.leaf_sentence_count, nodes, top)
        seg_n.append(n)
        seg_s.append(sc)
    return (_stack_levels(seg_n, R, W, nodes),
            _stack_levels(seg_s, R, W, qq))


def beam_pack_topk(bidx: BeamIndex, queries: torch.Tensor, k: int,
                   beam_width: int = 32, max_depth: int = 16,
                   cand_budget: int = 0, n_roots: int = 1):
    """The packed beam -> (leaf scores (B, M), leaf nodes (B, M)), leaf
    log-probs ranked, -1 past the live leaves.  ``cand_budget`` 0: 4x the
    width, a multiple of 64, at most 16x.  ``n_roots``: a flat forest's
    lane roots are compact rows [0, n_roots), scored densely; one beam
    then prunes across the lanes."""
    qq = fused_topk.query_terms(queries, bidx.pack.dtype).float()
    B = qq.shape[0]
    W = max(beam_width, n_roots)
    C = cand_budget or min(64 * max(1, -(-4 * W // 64)), W * 16)
    dev = qq.device
    nodes0 = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    nodes0[:, :n_roots] = torch.arange(n_roots, device=dev)
    scores0 = torch.full((B, W), _NEG, device=dev)
    scores0[:, :n_roots] = _pack_scores(bidx, qq, nodes0[:, :n_roots])
    root_leaf = _mask_leaves(bidx.leaf_sentence_count, nodes0, scores0)
    seg_n, seg_s = _beam_levels(bidx, qq, nodes0, W, C, max_depth)
    all_n = torch.cat([seg_n.reshape(B, -1), root_leaf[0]], dim=1)
    all_s = torch.cat([seg_s.reshape(B, -1), root_leaf[1]], dim=1)
    lscores, pos = topk_stable(all_s, min(all_s.shape[1], max(2 * W, k)))
    leaves = all_n.gather(1, pos)
    return lscores, torch.where(lscores > _NEG / 2, leaves,
                                torch.full_like(leaves, -1))


def beam_pack_topk_lanes(bidx: BeamIndex, queries: torch.Tensor, k: int,
                         lane_width: int = 16, max_depth: int = 16,
                         cand_budget: int = 0, n_lanes: int = 1,
                         roots: "torch.Tensor | None" = None):
    """The lane-fair packed beam over a flat forest: every lane keeps its
    own ``lane_width`` beam to the leaves and the lanes merge only at the
    leaf log-prob.  The frontier is (B * n_lanes, W_l) rows, lane l of a
    query starting at its root; each level is one gather and one product
    over all of them.  ``roots`` (B, n_lanes): each query's lane roots
    (compact rows, -1 an unused slot), the content-routed forest's lane
    selection; None: rows [0, n_lanes).  ``cand_budget`` 0: 4x the lane
    width, a multiple of 16, at most 16x.  Returns (leaf scores (B, M),
    leaf nodes (B, M)) merged across the lanes, in the JAX package's
    layout (lane, level, slot) so ties keep its order."""
    qq = fused_topk.query_terms(queries, bidx.pack.dtype).float()
    B, K, Wl = qq.shape[0], n_lanes, lane_width
    C = cand_budget or min(16 * max(1, -(-4 * Wl // 16)), Wl * 16)
    dev = qq.device
    qq_f = qq.unsqueeze(1).expand(B, K, qq.shape[1]).reshape(B * K, -1)
    if roots is None:
        roots_f = torch.arange(K, device=dev).repeat(B)
    else:
        roots_f = roots.to(device=dev, dtype=torch.int64).reshape(B * K)
    nodes0 = torch.full((B * K, Wl), -1, dtype=torch.int64, device=dev)
    nodes0[:, 0] = roots_f
    scores0 = torch.full((B * K, Wl), _NEG, device=dev)
    first = nodes0[:, :1]
    scores0[:, :1] = torch.where(first >= 0,
                                 _pack_scores(bidx, qq_f, first.clamp(min=0)),
                                 torch.full(first.shape, _NEG, device=dev))
    root_leaf = _mask_leaves(bidx.leaf_sentence_count, nodes0, scores0)
    seg_n, seg_s = _beam_levels(bidx, qq_f, nodes0, Wl, C, max_depth)
    all_n = torch.cat([seg_n.reshape(B, -1), root_leaf[0].reshape(B, -1)],
                      dim=1)
    all_s = torch.cat([seg_s.reshape(B, -1), root_leaf[1].reshape(B, -1)],
                      dim=1)
    lscores, pos = topk_stable(all_s, min(all_s.shape[1], max(k + Wl, 64)))
    leaves = all_n.gather(1, pos)
    return lscores, torch.where(lscores > _NEG / 2, leaves,
                                torch.full_like(leaves, -1))


def leaf_runs_to_sids(start: torch.Tensor, count: torch.Tensor,
                      order: torch.Tensor, leaves: torch.Tensor,
                      scores: torch.Tensor, k: int) -> torch.Tensor:
    """Ranked leaves (B, M) -> the first ``k`` sentence ids a query, on the
    device (``leaves_to_sentence_ids``'s expansion by ``_runs_pack``) ->
    (B, k), -1 padded."""
    safe = leaves.clamp(min=0)
    ok = (leaves >= 0) & torch.isfinite(scores) & (scores > _NEG / 2)
    s0 = torch.where(ok, start[safe], torch.full_like(safe, -1))
    c = torch.where(ok & (s0 >= 0), count[safe], torch.zeros_like(safe))
    ids, valid = _runs_pack(s0.clamp(min=0), c, k)
    return torch.where(valid, order[ids], torch.full_like(ids, -1))


def beam_query_ids(bidx: BeamIndex, queries: torch.Tensor, k: int,
                   beam_width: int = 32, max_depth: int = 16,
                   n_roots: int = 1, cand_budget: int = 0) -> torch.Tensor:
    """The packed beam -> (B, k) sentence ids on the device, -1 padded."""
    scores, leaves = beam_pack_topk(bidx, queries, k, beam_width=beam_width,
                                    max_depth=max_depth,
                                    cand_budget=cand_budget, n_roots=n_roots)
    return leaf_runs_to_sids(bidx.leaf_sentence_start,
                             bidx.leaf_sentence_count, bidx.sentence_order,
                             leaves, scores, k)
