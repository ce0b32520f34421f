"""K-lane Cobweb forest on one device: a port of
``rag_cobweb_tpu/parallel/vforest.py``.

K independent subtrees share one stacked state (``core/tree.TreeState``);
one round inserts one instance per lane through a lockstep descent over
the written-out lane axis.  Routing is round-robin (lane = global id % K)
or by content (``routing="content"``: the nearest lane centroid under a
per-lane load cap, the JAX package's router in host numpy, its proximity
product on the forest's device in full f32).

The retry schedule is the JAX package's, because it decides which
instance a lane inserts first and so shapes the trees: a descent longer
than the primary budget is suppressed and retried only after all primary
rounds, in waves of up to ``_RETRY_W`` instances per lane at
``_DEEP_STEPS``, and beyond that one at a time on the exact path at
``_EXACT_STEPS``.  The primary budget climbs 16 -> 24 -> 32 -> 48 while a
0.7/0.3 moving average of the deep fraction stays above 8%.

Below the wrapper's ``blocked_threshold`` a forest is served from its
stacked per-lane index (``parallel/stacked.build_stacked_index``):
``_vforest_query`` ranks each lane's rows by path score and merges the
lanes' candidates by leaf log-probability; ``vforest_rank_scores`` gives
every global sentence its lane's path score.  The JAX ``vmap`` over lanes
is a lane-batched product and a per-hop gather over ``(K, B, S)``.

``beam_topk`` (the wrapper's ``predict``) runs the packed beam of
``core/index.py`` over the flat forest index, lane-fair by default.
``vforest_beam_topk`` is the JAX package's per-lane oracle beam
(``beam_search_topk`` lane by lane over the stacked index) with its
device-side run expansion; nothing serves through it.

Memory tools of a large index, as in the JAX package: ``compress_stats``
stores ``means``/``m2s`` in bf16 after the build (every read upcasts);
``offload_state`` moves the state to host memory once the serving index
exists (the next add or index build moves it back first); a forest built
on the host (``build_device="cpu"``) moves to its serving device with
``to_device``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.files import read_npz
from rag_cobweb_tpu_torch.parallel.stacked import (StackedIndex,
                                                   build_stacked_index,
                                                   extend_bookkeeping,
                                                   lane_slots)

_MAX_STEPS = 16     # primary descent budget
_DEEP_STEPS = 48    # retry-wave budget
_RETRY_W = 32       # retry-wave width (instances per lane per wave)
_EXACT_STEPS = tree_mod.EXACT_STEPS
# byte budget of one query chunk's (K, Bc, N) node log-probs and (K, Bc,
# S) path-score temporaries in the small-forest query
QUERY_BUDGET = 1 << 30


def _centroid_scores(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, D) queries x (K, D) lane centroids -> (B, K) proximity scores
    ``q . c - 0.5 ||c||^2`` (negative half squared L2 up to a per-query
    constant), f32: the router's nearest-centroid rule and the lane
    selection share it."""
    return torch.matmul(q, c.T) - 0.5 * torch.sum(torch.square(c), dim=1)


def _lane_node_scores(idx: StackedIndex, q: torch.Tensor):
    """(B, D) queries -> every lane's node log-probs (K, B, N) and the
    path scores of its rows (K, B, S), padding rows -inf: the JAX
    per-lane ``batched_node_log_probs`` and ``path_scores_from_nlp``, as
    one lane-batched product and one gather per hop."""
    qb = q.float().unsqueeze(0)
    nlp = (torch.matmul(qb, idx.mu_over_var_T)
           - 0.5 * torch.matmul(torch.square(qb), idx.inv_var_T)
           + idx.const.unsqueeze(1))                        # (K, B, N)
    K, B = nlp.shape[0], nlp.shape[1]
    S = idx.paths.shape[1]
    safe = idx.paths.clamp(min=0)
    acc = torch.zeros((K, B, S), dtype=torch.float32, device=q.device)
    for p in range(idx.paths.shape[2]):
        hop = torch.gather(nlp, 2, safe[:, :, p].unsqueeze(1).expand(K, B, S))
        acc = acc + hop * idx.path_weights[:, :, p].unsqueeze(1)
    scores = torch.where(idx.sentence_valid.unsqueeze(1), acc,
                         torch.full_like(acc, float("-inf")))
    return nlp, scores


def _lane_merge(idx: StackedIndex, nlp: torch.Tensor, scores: torch.Tensor,
                k: int):
    """Each lane's top-``k`` rows by path score, merged across lanes by
    their leaf log-prob (the key calibrated alike in every lane) ->
    (leaf log-probs (B, k'), global ids (B, k')), k' = min(k, K * k_lane);
    padding rows carry -inf and id -1."""
    K, B, S = scores.shape
    kk = min(k, S)
    _, rows = index_mod.topk_stable(scores, kk)            # (K, B, kk)
    flat = rows.reshape(K, B * kk)
    gids = idx.global_sid.gather(1, flat).view(K, B, kk)
    leaf = idx.leaf_node.gather(1, flat).view(K, B, kk)
    lp = torch.gather(nlp, 2, leaf)
    lp = torch.where(gids >= 0, lp, torch.full_like(lp, float("-inf")))
    merged = lp.permute(1, 0, 2).reshape(B, K * kk)
    merged_ids = gids.permute(1, 0, 2).reshape(B, K * kk)
    top, pos = index_mod.topk_stable(merged, min(k, K * kk))
    return top, merged_ids.gather(1, pos)


def _query_chunk(idx: StackedIndex, B: int) -> int:
    """Queries a chunk so that the (K, Bc, N) node log-probs and ~4 (K,
    Bc, S) path-score temporaries stay under ``QUERY_BUDGET`` bytes: all
    of ``B``, or a power of two (at least 32)."""
    K, S = idx.paths.shape[0], idx.paths.shape[1]
    row = 4 * K * (idx.const.shape[1] + 4 * S)
    bmax = max(32, QUERY_BUDGET // max(row, 1))
    return B if bmax >= B else 1 << (bmax.bit_length() - 1)


def _vforest_query(idx: StackedIndex, q: torch.Tensor, k: int):
    """Per-lane path-ranked top-k merged across lanes by leaf log-prob ->
    (leaf log-probs (B, k'), global ids (B, k')), the query batch chunked
    by ``QUERY_BUDGET``."""
    bmax = _query_chunk(idx, q.shape[0])
    outs = [_lane_merge(idx, *_lane_node_scores(idx, q[s:s + bmax]), k)
            for s in range(0, q.shape[0], bmax)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _vforest_beam(idx: StackedIndex, q: torch.Tensor, k: int,
                  beam_width: int, max_depth: int):
    """Each lane's beam (``core/index.beam_search_topk``) over its view of
    the stacked index, lane by lane -> (leaf log-probs, leaf nodes), each
    (K, B, Wk); the leaf log-probs are calibrated alike in every lane."""
    outs = [index_mod.beam_search_topk(
        index_mod.PredictionIndex(
            inv_var_T=idx.inv_var_T[s], mu_over_var_T=idx.mu_over_var_T[s],
            const=idx.const[s], paths=idx.paths[s],
            path_weights=idx.path_weights[s], children=idx.children[s],
            leaf_sentence_start=idx.leaf_sentence_start[s],
            leaf_sentence_count=idx.leaf_sentence_count[s],
            sentence_order=idx.sentence_order[s],
            paths_h=None, weights_h=None, order_h=None),
        q, k, beam_width=beam_width, max_depth=max_depth)
        for s in range(idx.const.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _beam_expand_device(scores, leaves, lane_of, starts, counts, sorder,
                        gsid, k: int) -> torch.Tensor:
    """Ranked leaf-run expansion on the device: every lane's candidates
    flattened (B, K * Wk) and sorted by score (stable, so ties keep lane
    order), each leaf's run length, their running sum, and each output
    slot's source candidate found by a row-wise ``searchsorted`` over it ->
    (B, k) global sentence ids, -1 padded.  ``scores``/``leaves`` are
    ``_vforest_beam``'s; ``lane_of`` the lane of each flattened
    candidate."""
    K, B, Wk = scores.shape
    flat_s = scores.permute(1, 0, 2).reshape(B, K * Wk)
    flat_l = leaves.permute(1, 0, 2).reshape(B, K * Wk)
    order = torch.argsort(-flat_s, dim=1, stable=True)
    s_sorted = flat_s.gather(1, order)
    l_sorted = flat_l.gather(1, order)
    lanes = lane_of[order]                                  # (B, C)
    ok = (l_sorted >= 0) & torch.isfinite(s_sorted) & (s_sorted > -3e38 / 2)
    safe_leaf = l_sorted.clamp(min=0)
    s0 = starts[lanes, safe_leaf]
    c = torch.where(ok & (s0 >= 0), counts[lanes, safe_leaf],
                    torch.zeros_like(s0))
    cum = torch.cumsum(c, dim=1)                            # inclusive
    off = cum - c                                           # exclusive
    t = torch.arange(k, device=scores.device).expand(B, k).contiguous()
    j = torch.searchsorted(cum.contiguous(), t, right=True)     # (B, k)
    C = c.shape[1]
    valid = j < C
    jc = j.clamp(max=C - 1)
    pos = s0.gather(1, jc) + t - off.gather(1, jc)
    lane_sel = lanes.gather(1, jc)
    # slots past the runs index nothing: clamped in range, then masked
    out = gsid[lane_sel, sorder[lane_sel,
                                pos.clamp(0, sorder.shape[1] - 1)]]
    valid = valid & (c.gather(1, jc) > 0)
    return torch.where(valid, out, torch.full_like(out, -1))


def vforest_beam_topk(idx: StackedIndex, q: torch.Tensor, k: int,
                      beam_width: int = 32, max_depth: int = 16
                      ) -> np.ndarray:
    """Cross-lane beam retrieval: each lane's beam, the lanes merged by
    leaf log-prob and the leaves' sentence runs expanded to the first
    ``k`` global sentence ids a query, on the device -> (B, k) host ids,
    -1 padded.  Nothing serves through it (the wrapper's ``predict`` runs
    the packed beam); it is the library function of the JAX package."""
    scores, leaves = _vforest_beam(idx, q, k, beam_width, max_depth)
    K, _, Wk = scores.shape
    lane_of = torch.arange(K, device=q.device).repeat_interleave(Wk)
    return _beam_expand_device(
        scores, leaves, lane_of, idx.leaf_sentence_start,
        idx.leaf_sentence_count, idx.sentence_order, idx.global_sid,
        k).cpu().numpy()


def vforest_rank_scores(idx: StackedIndex, q: torch.Tensor,
                        n_global: int) -> torch.Tensor:
    """Per-global-sentence path scores over all lanes, (B, D) -> (B,
    n_global): each lane's scores placed at its rows' global ids (each id
    lives in exactly one lane; an id no lane holds scores -inf).  A
    gather, so plain autograd differentiates it in the queries."""
    _, scores = _lane_node_scores(idx, q)                   # (K, B, S)
    K, B, S = scores.shape
    flat = scores.permute(1, 0, 2).reshape(B, K * S)
    gsid = idx.global_sid.reshape(-1)
    src = torch.full((n_global,), -1, dtype=torch.int64, device=q.device)
    live = torch.nonzero(gsid >= 0)[:, 0]
    src[gsid[live]] = live
    out = flat[:, src.clamp(min=0)]
    return torch.where(src >= 0, out, torch.full_like(out, float("-inf")))


class VForest:
    """K-subtree forest on one device."""

    # per-lane load cap of content routing, as a multiple of the mean lane
    # load (the JAX package's value: 2.0 keeps spills within each row's
    # nearest few lanes)
    route_cap_factor: float = 2.0

    def __init__(self, cfg: TreeConfig, n_subtrees: int = 16,
                 capacity_per_tree: int = 4096, seed: int = 0,
                 routing: str = "round_robin", device="cuda",
                 build_device=None):
        """``routing``: ``"round_robin"`` (lane = global id % K) or
        ``"content"`` (the nearest lane centroid, balanced by a load cap;
        centroids start from a short k-means on the first batch and track
        their lane's running mean).  Content routing packs near-duplicate
        groups into one lane, so with ``absorb_depth == 0`` it sets
        ``absorb_depth=24``, as the JAX package does.

        ``device`` is the serving device; ``build_device`` (None: the
        same) is where the state lives and the inserts run until
        ``to_device()`` moves them to ``device``."""
        if routing not in ("round_robin", "content"):
            raise ValueError(f"unknown routing {routing!r}")
        self.serve_device = resolve_device(device)
        self.device = (self.serve_device if build_device is None
                       else resolve_device(build_device))
        full_f32_matmul()
        if routing == "content" and cfg.absorb_depth == 0:
            cfg = dataclasses.replace(cfg, absorb_depth=24)
        self.cfg = cfg
        self.K = n_subtrees
        self.routing = routing
        self.seed = seed
        self._centroids: Optional[np.ndarray] = None   # (K, D) host f32
        self._route_count = np.zeros(n_subtrees, np.int64)
        self._lane_total = np.zeros(n_subtrees, np.int64)
        self._route_rng = np.random.default_rng(seed ^ 0x5EED)
        self.state = tree_mod.init_state(n_subtrees, capacity_per_tree,
                                         cfg.dim, cfg.max_fanout, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.n_sentences = 0
        self.shard_of: list[int] = []
        self.local_sid: list[int] = []
        self._leaf_of_local: list[list[int]] = [[] for _ in range(n_subtrees)]
        self._budget = _MAX_STEPS
        self._deep_frac = 0.0
        # host upper bound on any lane's allocated-node count
        self._alloc_hi = 1
        self._graph: "tree_mod.StepGraph | None" = None
        self._flat_index: "index_mod.PredictionIndex | None" = None
        self._stacked_index: Optional[StackedIndex] = None
        self._beam_idx: "index_mod.BeamIndex | None" = None
        self._beam_src = None     # the flat index the beam index is of
        self._beam_depth = 1

    # ---------------------------------------------------------------- #
    # memory tools: compression, offload, the move between devices    #
    # ---------------------------------------------------------------- #
    def _drop_caches(self):
        """Drop the step graph and the indexes built from the state."""
        self._graph = None
        self._flat_index = None
        self._stacked_index = None
        self._beam_idx = None
        self._beam_src = None

    def _resident(self) -> tree_mod.TreeState:
        """The state, moved back to ``self.device`` first if
        ``offload_state`` put it on the host: every reader of the state
        but serving goes through here."""
        if self.state.device != self.device:
            self.state = tree_mod.state_to(self.state, self.device)
        return self.state

    def to_device(self, device=None):
        """Move the forest to ``device`` (None: its serving device, the
        card by default), the step after a build on the host: the state,
        and the descent's generator, seeded from the old one's next draw
        (a CPU and a CUDA generator draw different streams).  The indexes
        built on the old device are dropped; the next query builds them
        on the new one."""
        target = (self.serve_device if device is None
                  else resolve_device(device))
        if target == self.device and self.state.device == target:
            return
        self.state = tree_mod.state_to(self.state, target)
        if target != self.device:
            seed = int(torch.randint(2 ** 62, (1,), generator=self._gen,
                                     device=self.device))
            self._gen = torch.Generator(device=target)
            self._gen.manual_seed(seed)
        self.device = target
        self._drop_caches()

    def compress_stats(self, dtype=None):
        """At-rest stats compression, as in the JAX package: ``means`` and
        ``m2s`` cast to ``dtype`` (None: bf16), once (a second call is a
        no-op).  After the build by design: bf16 storage during Welford
        accumulation freezes the statistics once the increments fall
        under its rounding, while one rounding of the final values shifts
        scores by ~2^-9 relative.  Adds still work on a compressed state
        (the descent reads f32 and rounds its writes).  The step graph and
        the indexes of the f32 stats are dropped."""
        st = tree_mod.compress_state(self.state, dtype)
        if st is not self.state:
            self.state = st
            self._drop_caches()

    def offload_state(self):
        """Serve-only mode: the whole state to host memory (pinned from
        the card), the step graph dropped.  Serving an index that exists
        never reads the state; the next add or index build moves it back
        to ``self.device`` first."""
        self._graph = None
        self.state = tree_mod.state_to(self.state, "cpu")

    def _ensure_capacity(self, rounds: int):
        """Grow every lane when the next ``rounds`` inserts could overflow
        (at most 2 fresh nodes per insert), checking the host bound first
        and the lanes' real counts only when the bound says grow."""
        self._resident()
        cap = self.state.capacity
        needed = self._alloc_hi + 2 * rounds + 8
        if needed <= cap:
            return
        self._alloc_hi = int(self.state.n_alloc.max())
        needed = self._alloc_hi + 2 * rounds + 8
        if needed <= cap:
            return
        self.state = tree_mod.grow_state(
            self.state, tree_mod.align_capacity(max(needed, 2 * cap)))

    def _rounds(self, xs: torch.Tensor, mask: np.ndarray, n_rounds: int,
                max_steps: int) -> np.ndarray:
        """Round r inserts ``xs[:, r]`` into every lane whose ``mask[:, r]``
        is set.  Returns leaves (K, R), -1 where the budget cut a descent
        (which then applied nothing) or the mask is off."""
        K, R = mask.shape
        leaves = np.full((K, R), -1, np.int64)
        mask_t = torch.as_tensor(mask, device=self.device)
        graph = self._step_graph()
        for r in range(n_rounds):
            lf = tree_mod.descend(self.state, xs[:, r], mask_t[:, r],
                                  self.cfg, max_steps, self._gen, graph)
            leaves[:, r] = lf.cpu().numpy()
        return leaves

    def _step_graph(self) -> "tree_mod.StepGraph | None":
        """On the card, the descent step captured as a CUDA graph for the
        current state arrays (recaptured after they are reallocated)."""
        if self.device.type != "cuda":
            return None
        if self._graph is None or not self._graph.matches(self._resident()):
            self._graph = tree_mod.StepGraph(self.state, self.cfg)
        return self._graph

    def _retry(self, leaves: np.ndarray, xs_t: torch.Tensor,
               valid: np.ndarray):
        """Retry the descents the primary budget cut, in ``_RETRY_W``-wide
        waves at ``_DEEP_STEPS``, then one at a time at ``_EXACT_STEPS``;
        move the primary budget along its ladder."""
        K = self.K
        need = (leaves < 0) & valid
        n_deep = int(need.sum())
        self._deep_frac = 0.7 * self._deep_frac + 0.3 * (
            n_deep / max(int(valid.sum()), 1))
        if self._deep_frac > 0.08 and self._budget < _DEEP_STEPS:
            self._budget = {16: 24, 24: 32, 32: 48}.get(self._budget,
                                                        _DEEP_STEPS)
        if not n_deep:
            return
        pend_idx = [np.nonzero(need[s])[0] for s in range(K)]
        R2 = int(need.sum(1).max())
        for w0 in range(0, R2, _RETRY_W):
            sel = np.zeros((K, _RETRY_W), np.int64)
            mask2 = np.zeros((K, _RETRY_W), bool)
            for s in range(K):
                idx = pend_idx[s][w0:w0 + _RETRY_W]
                sel[s, :len(idx)] = idx
                mask2[s, :len(idx)] = True
            wave_max = int(mask2.sum(1).max())
            if not wave_max:
                break
            lane_ix = torch.arange(K, device=self.device).unsqueeze(1)
            xs2 = xs_t[lane_ix, torch.as_tensor(sel, device=self.device)]
            leaf2 = self._rounds(xs2, mask2, wave_max, _DEEP_STEPS)
            rows, cols = np.nonzero(mask2 & (leaf2 >= 0))
            leaves[rows, sel[rows, cols]] = leaf2[rows, cols]
            self._insert_exact(xs2, mask2 & (leaf2 < 0), leaves, sel)

    def _insert_exact(self, xs_t: torch.Tensor, need: np.ndarray,
                      leaves: np.ndarray, slot_of=None):
        """Insert each row ``xs_t[s, c]`` where ``need[s, c]`` alone on the
        exact path, lane by lane in row order; its leaf goes to ``leaves[s,
        slot_of[s, c]]`` (``slot_of`` defaults to ``c``)."""
        for s, c in np.argwhere(need):
            one = np.zeros((self.K, 1), bool)
            one[s, 0] = True
            lf = self._rounds(xs_t[:, c:c + 1], one, 1, _EXACT_STEPS)
            if lf[s, 0] < 0:
                raise RuntimeError(
                    f"insert descent exceeded _EXACT_STEPS="
                    f"{_EXACT_STEPS} in lane {int(s)}")
            leaves[s, c if slot_of is None else slot_of[s, c]] = lf[s, 0]

    # ---------------------------------------------------------------- #
    # content routing (host numpy, as in the JAX package)              #
    # ---------------------------------------------------------------- #
    def _lane_scores(self, x: np.ndarray,
                     centroids: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, K) centroid-proximity scores of host rows ``x``, computed on
        the forest's device in f32; ``centroids`` overrides the router's
        (the root-mean fallback)."""
        c = self._centroids if centroids is None else centroids
        s = _centroid_scores(
            torch.as_tensor(np.asarray(x, np.float32), device=self.device),
            torch.as_tensor(np.asarray(c, np.float32), device=self.device))
        return s.cpu().numpy()

    def _init_centroids(self, x: np.ndarray):
        """Short k-means over the first routed batch: K rows drawn from
        it (with replacement and 1e-3 noise when it has fewer than K),
        then 3 Lloyd iterations."""
        K, rng = self.K, self._route_rng
        B = len(x)
        if B >= K:
            c = np.array(x[rng.choice(B, K, replace=False)], np.float32)
        else:
            c = np.array(x[rng.choice(B, K, replace=True)], np.float32)
            c += 1e-3 * rng.standard_normal(c.shape).astype(np.float32)
        self._centroids = c
        for _ in range(3):
            assign = np.argmax(self._lane_scores(x), axis=1)
            sums = np.zeros_like(c)
            cnt = np.zeros(K, np.int64)
            np.add.at(sums, assign, x)
            np.add.at(cnt, assign, 1)
            upd = cnt > 0
            c[upd] = sums[upd] / cnt[upd, None]

    @staticmethod
    def _cumcount(g: np.ndarray, K: int) -> np.ndarray:
        """Rank of each element among the earlier elements of the same
        value."""
        o = np.argsort(g, kind="stable")
        gs = g[o]
        starts = np.searchsorted(gs, np.arange(K))
        out = np.empty(len(g), np.int64)
        out[o] = np.arange(len(g)) - starts[gs]
        return out

    def _route_lanes(self, x: np.ndarray) -> np.ndarray:
        """Nearest-centroid lanes under a per-lane load cap
        (``route_cap_factor`` x the mean load after this batch, + 16).
        Rows claim their nearest lane in order of their 1st-vs-2nd
        margin, largest first; spills try their 2nd-nearest lane, then
        walk their own centroid ranking, and only when every lane is full
        go to the least-loaded ones.  Centroids then move to the exact
        running mean of the rows routed to them."""
        K = self.K
        B = len(x)
        if self._centroids is None:
            self._init_centroids(x)
        s = self._lane_scores(x)
        if K == 1:
            return np.zeros(B, np.int32)
        rows = np.arange(B)
        top2 = np.argpartition(-s, 1, axis=1)[:, :2]
        swap = s[rows, top2[:, 0]] < s[rows, top2[:, 1]]
        top2[swap] = top2[swap][:, ::-1]
        load = self._lane_total.copy()
        cap = int(self.route_cap_factor * (int(load.sum()) + B) / K) + 16
        room = np.maximum(cap - load, 0)

        lane_of = np.full(B, -1, np.int32)
        margin = s[rows, top2[:, 0]] - s[rows, top2[:, 1]]
        ordr = np.argsort(-margin, kind="stable")
        lane1 = top2[ordr, 0]
        take1 = self._cumcount(lane1, K) < room[lane1]
        lane_of[ordr[take1]] = lane1[take1]
        room = room - np.bincount(lane1[take1], minlength=K)
        rem = ordr[~take1]
        if rem.size:
            lane2 = top2[rem, 1]
            take2 = self._cumcount(lane2, K) < room[lane2]
            lane_of[rem[take2]] = lane2[take2]
            room = room - np.bincount(lane2[take2], minlength=K)
            rem = rem[~take2]
        if rem.size:
            ranks = np.argsort(-s[rem], axis=1)
            left = np.arange(rem.size)
            for r in range(2, K):
                if left.size == 0:
                    break
                lane_r = ranks[left, r]
                take = self._cumcount(lane_r, K) < room[lane_r]
                lane_of[rem[left[take]]] = lane_r[take]
                room = room - np.bincount(lane_r[take], minlength=K)
                left = left[~take]
            if left.size:
                lane_order = np.argsort(-room)
                slots = np.repeat(lane_order,
                                  np.maximum(room, 0)[lane_order])
                if slots.size < left.size:
                    slots = np.concatenate([
                        slots, np.tile(np.argsort(load),
                                       -(-(left.size - slots.size) // K))])
                lane_of[rem[left]] = slots[:left.size]
        load += np.bincount(lane_of, minlength=K)
        self._lane_total = load
        sums = np.zeros_like(self._centroids)
        cnt = np.zeros(K, np.int64)
        np.add.at(sums, lane_of, x)
        np.add.at(cnt, lane_of, 1)
        tot = self._route_count + cnt
        upd = cnt > 0
        self._centroids[upd] += (
            sums[upd] - cnt[upd, None] * self._centroids[upd]
        ) / tot[upd, None]
        self._route_count = tot
        return lane_of

    def select_lanes(self, queries, n_lanes: int) -> np.ndarray:
        """Each query's ``n_lanes`` nearest lanes by centroid proximity,
        (B, L).  Without router state (round-robin, or a file from before
        routing) each lane's root mean stands for its centroid."""
        L = min(n_lanes, self.K)
        cent = None
        if self._centroids is None:     # read where the state is
            st = self.state
            cent = st.means[torch.arange(self.K, device=st.device),
                            st.root].float().cpu().numpy()
        s = self._lane_scores(np.atleast_2d(np.asarray(queries, np.float32)),
                              centroids=cent)
        if L >= self.K:
            return np.broadcast_to(np.arange(self.K, dtype=np.int32),
                                   (len(s), self.K)).copy()
        return np.argpartition(-s, L - 1, axis=1)[:, :L].astype(np.int32)

    # ---------------------------------------------------------------- #
    # insertion                                                        #
    # ---------------------------------------------------------------- #
    def add(self, embeddings) -> np.ndarray:
        """Insert a batch; one round inserts up to K instances, one per
        lane, each lane by ``routing``.  Returns the global ids of the new
        rows."""
        xs = torch.as_tensor(embeddings, dtype=torch.float32,
                             device=self.device)
        if xs.dim() == 1:
            xs = xs.unsqueeze(0)
        B, K = xs.shape[0], self.K
        gids = np.arange(self.n_sentences, self.n_sentences + B)
        if B == 0:
            return gids
        lane_of = (self._route_lanes(xs.cpu().numpy())
                   if self.routing == "content" else gids % K)
        slot = lane_slots(lane_of, K)
        leaves = self.insert_packed(xs, lane_of, slot, self._budget)
        extend_bookkeeping(self, lane_of, slot, leaves)
        return gids

    def insert_packed(self, xs: torch.Tensor, lane_of: np.ndarray,
                      slot: np.ndarray, steps: int,
                      waves: bool = True) -> np.ndarray:
        """Insert rows ``xs`` (B, D), row ``i`` the ``slot[i]``-th of lane
        ``lane_of[i]``: the lanes packed into (K, R, D), R lockstep rounds
        at ``steps``, then the descents that budget cut -- in retry waves
        (``_retry``) when ``waves``, else each alone on the exact path,
        lane by lane in row order (the JAX composed program).  Returns the
        leaves (K, R), slot for slot."""
        K = self.K
        R = int(slot.max()) + 1 if len(slot) else 0
        self._resident()
        self._flat_index = None
        self._stacked_index = None
        self._ensure_capacity(R + 1)
        lane_t = torch.as_tensor(lane_of, device=self.device)
        slot_t = torch.as_tensor(slot, device=self.device)
        xs_t = torch.zeros((K, R, xs.shape[1]), dtype=torch.float32,
                           device=self.device)
        xs_t[lane_t, slot_t] = xs.to(self.device, torch.float32)
        mask = np.zeros((K, R), bool)
        mask[lane_of, slot] = True
        leaves = self._rounds(xs_t, mask, R, steps)
        self._alloc_hi += 2 * R
        if waves:
            self._retry(leaves, xs_t, mask)
        else:
            self._insert_exact(xs_t, mask & (leaves < 0), leaves)
        return leaves

    def _leaf_global(self) -> np.ndarray:
        """(S,) global leaf slot per sentence: ``lane * capacity + leaf``."""
        cap = self.state.capacity
        n_local = max((len(lst) for lst in self._leaf_of_local), default=0)
        leaf_mat = np.full((self.K, max(n_local, 1)), -1, np.int64)
        for s, lst in enumerate(self._leaf_of_local):
            leaf_mat[s, :len(lst)] = lst
        shard = np.asarray(self.shard_of, np.int64)
        local = np.asarray(self.local_sid, np.int64)
        return shard * cap + leaf_mat[shard, local]

    def fused_index(self, dtype=torch.float32) -> "index_mod.FusedIndex":
        """FusedIndex over the current forest, built straight from the
        stacked state (``core/index.build_fused_from_state``)."""
        chase = 32
        if self.cfg.absorb_depth:
            chase = max(chase, self.cfg.absorb_depth + 8)
        return index_mod.build_fused_from_state(
            self.cfg, self._resident(), self._leaf_global(), dtype=dtype,
            chase_depth=chase)

    def flat_index(self) -> "index_mod.PredictionIndex":
        """The whole forest flattened to one PredictionIndex over global
        sentence ids (``core/index.build_flat_forest_index``), the input of
        the blocked engines; cached until the next ``add``."""
        if self._flat_index is None:
            self._flat_index = index_mod.build_flat_forest_index(
                self.cfg, self._resident(), self._leaf_global())
        return self._flat_index

    def beam_index(self) -> "index_mod.BeamIndex":
        """The packed BeamIndex over the flat forest index, rebuilt when
        the flat index is (after an add)."""
        idx = self.flat_index()
        if self._beam_idx is None or self._beam_src is not idx:
            self._beam_idx = index_mod.build_beam_index(idx)
            self._beam_src = idx
            self._beam_depth = int((idx.paths_h >= 0).sum(-1).max(initial=1))
        return self._beam_idx

    def beam_topk(self, queries, k: int, beam_width: int = 16,
                  max_depth: Optional[int] = None, lane_fair: bool = True,
                  lanes_per_query: Optional[int] = None) -> torch.Tensor:
        """Beam retrieval across the lanes -> (B, k) global sentence ids on
        the device, -1 padded: one packed beam over the flat index, whose
        lane roots are compact rows [0, K).  ``lane_fair`` keeps
        ``beam_width`` paths alive in every lane and merges the lanes by
        leaf log-prob (``index.beam_pack_topk_lanes``); False runs one
        global beam (``index.beam_pack_topk``).  ``max_depth`` None: the
        forest's depth rounded up to a multiple of 4; a number cuts it.
        ``lanes_per_query`` None: 8 nearest lanes a query when content
        routed (``select_lanes``), every lane otherwise.  Queries go in
        chunks whose gathered candidate rows (f32, chunk x lanes x budget
        x 2D) stay under 1 GiB."""
        bidx = self.beam_index()
        md = -(-max(self._beam_depth, 1) // 4) * 4
        if max_depth is not None:
            md = min(max_depth, md)
        q = self._queries(queries)
        B = q.shape[0]
        if lanes_per_query is None:
            lanes_per_query = (min(self.K, 8) if self.routing == "content"
                               else self.K)
        L = min(lanes_per_query, self.K)
        sel = None
        if lane_fair and L < self.K:
            sel = torch.as_tensor(self.select_lanes(q.cpu().numpy(), L),
                                  device=self.device)
        Wl = beam_width
        C = min(16 * max(1, -(-4 * Wl // 16)), Wl * 16)
        row_bytes = (L * C if lane_fair else C) * bidx.pack.shape[1] * 4
        chunk = max(1, (1 << 30) // row_bytes)
        outs = []
        for s0 in range(0, B, chunk):
            qc = q[s0:s0 + chunk]
            if lane_fair:
                scores, leaves = index_mod.beam_pack_topk_lanes(
                    bidx, qc, k, lane_width=Wl, max_depth=md, n_lanes=L,
                    roots=None if sel is None else sel[s0:s0 + chunk])
            else:
                scores, leaves = index_mod.beam_pack_topk(
                    bidx, qc, k, beam_width=Wl, max_depth=md,
                    n_roots=self.K)
            outs.append(index_mod.leaf_runs_to_sids(
                bidx.leaf_sentence_start, bidx.leaf_sentence_count,
                bidx.sentence_order, leaves, scores, k))
        return torch.cat(outs)

    def lane_signature(self, lane: int):
        """Structure signature of one lane's tree (see
        ``core/tree.structure_signature``)."""
        a = {k: v[lane] for k, v in
             tree_mod.state_to_numpy(self.state).items()}
        return tree_mod.structure_signature(
            a["counts"], a["means"], a["children"], a["n_children"],
            a["root"])

    # ---------------------------------------------------------------- #
    # the small-forest query                                           #
    # ---------------------------------------------------------------- #
    def build_index(self) -> StackedIndex:
        """The stacked per-lane index (``parallel/stacked``), cached until
        the next ``add``."""
        if self._stacked_index is None:
            self._stacked_index = build_stacked_index(
                self.cfg, self._resident(), self._leaf_of_local, self.shard_of,
                self.local_sid, self.n_sentences)
        return self._stacked_index

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return q.unsqueeze(0) if q.dim() == 1 else q

    def query_topk(self, queries, k: int):
        """(B, D) queries -> (leaf log-probs (B, k), global ids (B, k)):
        each lane's path-ranked top-k merged by leaf log-prob."""
        return _vforest_query(self.build_index(), self._queries(queries), k)

    def rank_scores(self, queries) -> torch.Tensor:
        """Differentiable (B, n_sentences) path scores over global ids."""
        return vforest_rank_scores(self.build_index(),
                                   self._queries(queries), self.n_sentences)

    def max_depth(self) -> int:
        """The longest root->leaf path of any sentence, in nodes."""
        return int((self.build_index().paths >= 0).sum(-1).max())

    # ---------------------------------------------------------------- #
    # persistence: the JAX package's npz layout                        #
    # ---------------------------------------------------------------- #
    def save_npz(self, path: str, **extra_arrays):
        """Write the forest in the JAX ``VForest.save_npz`` layout (state
        fields ``st_*``, bookkeeping, router state), so either package
        loads it.  ``__key__`` is ``jax.random.PRNGKey(seed)``'s raw
        form, ``[0, seed]`` in uint32.  Compressed stats are written as
        the JAX package writes them, bf16 bits as 2-byte records (which
        its own ``load_npz`` cannot read back; this package's can)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n_local = np.asarray([len(lst) for lst in self._leaf_of_local])
        leaf_mat = np.full((self.K, max(int(n_local.max(initial=0)), 1)),
                           -1, np.int64)
        for s, lst in enumerate(self._leaf_of_local):
            leaf_mat[s, :len(lst)] = lst
        routing = {"__routing__": np.asarray(self.routing)}
        if self._centroids is not None:
            routing.update(__centroids__=self._centroids,
                           __route_count__=self._route_count,
                           __lane_total__=self._lane_total)
        np.savez_compressed(
            path,
            __forest__=np.asarray(self.K),
            __cfg__=np.frombuffer(json.dumps(self.cfg.to_json_dict())
                                  .encode(), dtype=np.uint8),
            __key__=np.asarray([0, self.seed & 0xFFFFFFFF], np.uint32),
            n_sentences=np.asarray(self.n_sentences),
            shard_of=np.asarray(self.shard_of, np.int64),
            local_sid=np.asarray(self.local_sid, np.int64),
            leaf_of_local=leaf_mat, n_local=n_local, **routing,
            **{f"st_{k}": v for k, v in
               tree_mod.state_to_numpy(self.state, raw=True).items()},
            **extra_arrays)

    _NPZ_KEYS = {"__forest__", "__cfg__", "__key__", "n_sentences",
                 "shard_of", "local_sid", "leaf_of_local", "n_local",
                 "__routing__", "__centroids__", "__route_count__",
                 "__lane_total__"} | {f"st_{k}" for k in tree_mod.FIELDS}

    @classmethod
    def load_npz(cls, path: str, device="cuda"):
        """A forest from a file of either package's ``save_npz``; returns
        (forest, dict of the extra arrays saved beside it; object arrays
        through ``files.read_npz``'s restricted unpickler).  The descent's
        generator is seeded from the last word of ``__key__``."""
        data = read_npz(path)
        n_local = data["n_local"]
        leaf_mat = data["leaf_of_local"]
        meta = {
            "cfg": json.loads(bytes(data["__cfg__"]).decode()),
            "shard_of": data["shard_of"],
            "local_sid": data["local_sid"],
            "leaf_of_local": [leaf_mat[s, :int(n_local[s])]
                              for s in range(len(n_local))],
            "seed": int(np.asarray(data["__key__"]).ravel()[-1]),
        }
        if "__routing__" in data:
            meta["routing"] = str(data["__routing__"])
        if "__centroids__" in data:
            meta.update(centroids=data["__centroids__"],
                        route_count=data["__route_count__"],
                        lane_total=data["__lane_total__"])
        arrays = {k: data[f"st_{k}"] for k in tree_mod.FIELDS}
        extras = {k: v for k, v in data.items() if k not in cls._NPZ_KEYS}
        return cls.from_numpy(arrays, meta, device=device), extras

    @classmethod
    def from_numpy(cls, arrays: dict, meta: dict,
                   device="cuda") -> "VForest":
        """A forest from stacked state arrays in the JAX layout (counts,
        means, m2s, parent, children, n_children, root, n_alloc,
        free_stack, free_top, each with a leading lane axis) and ``meta``:
        ``cfg`` (a TreeConfig or its JSON dict), ``shard_of``,
        ``local_sid``, ``leaf_of_local`` (one list per lane), and
        optionally ``seed``, ``routing`` and the router state
        ``centroids``, ``route_count``, ``lane_total``."""
        cfg = meta["cfg"]
        if not isinstance(cfg, TreeConfig):
            cfg = TreeConfig.from_json_dict(cfg)
        K, cap = np.asarray(arrays["counts"]).shape
        vf = cls(cfg, n_subtrees=K, capacity_per_tree=cap,
                 seed=int(meta.get("seed", 0)),
                 routing=meta.get("routing", "round_robin"), device=device)
        vf.state = tree_mod.state_from_numpy(arrays, vf.device)
        vf.shard_of = [int(x) for x in meta["shard_of"]]
        vf.local_sid = [int(x) for x in meta["local_sid"]]
        vf._leaf_of_local = [[int(x) for x in lst]
                             for lst in meta["leaf_of_local"]]
        vf.n_sentences = len(vf.shard_of)
        vf._alloc_hi = int(np.asarray(arrays["n_alloc"]).max())
        if meta.get("centroids") is not None:
            vf._centroids = np.array(meta["centroids"], np.float32)
            vf._route_count = np.array(meta["route_count"], np.int64)
            vf._lane_total = np.array(meta["lane_total"], np.int64)
        return vf
