"""K-lane Cobweb forest on one device: the build subset of
``rag_cobweb_tpu/parallel/vforest.py``.

K independent subtrees share one stacked state (``core/tree.TreeState``);
one round inserts one instance per lane through a lockstep descent over
the written-out lane axis.  Routing is round-robin (lane = global id % K).

The retry schedule is the JAX package's, because it decides which
instance a lane inserts first and so shapes the trees: a descent longer
than the primary budget is suppressed and retried only after all primary
rounds, in waves of up to ``_RETRY_W`` instances per lane at
``_DEEP_STEPS``, and beyond that one at a time on the exact path at
``_EXACT_STEPS``.  The primary budget climbs 16 -> 24 -> 32 -> 48 while a
0.7/0.3 moving average of the deep fraction stays above 8%.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.device import resolve_device

_MAX_STEPS = 16     # primary descent budget
_DEEP_STEPS = 48    # retry-wave budget
_RETRY_W = 32       # retry-wave width (instances per lane per wave)
_EXACT_STEPS = tree_mod.EXACT_STEPS


class VForest:
    """K-subtree forest on one device."""

    def __init__(self, cfg: TreeConfig, n_subtrees: int = 16,
                 capacity_per_tree: int = 4096, seed: int = 0,
                 routing: str = "round_robin", device="cuda"):
        if routing != "round_robin":
            raise NotImplementedError(
                f"routing={routing!r}: content routing is not ported yet; "
                "only round_robin is")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.K = n_subtrees
        self.routing = routing
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

    def _ensure_capacity(self, rounds: int):
        """Grow every lane when the next ``rounds`` inserts could overflow
        (at most 2 fresh nodes per insert), checking the host bound first
        and the lanes' real counts only when the bound says grow."""
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
        if self._graph is None or not self._graph.matches(self.state):
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
            for s, c in np.argwhere(mask2 & (leaf2 < 0)):
                one = np.zeros((K, 1), bool)
                one[s, 0] = True
                lf = self._rounds(xs2[:, c:c + 1], one, 1, _EXACT_STEPS)
                if lf[s, 0] < 0:
                    raise RuntimeError(
                        f"insert descent exceeded _EXACT_STEPS="
                        f"{_EXACT_STEPS} in lane {int(s)}")
                leaves[s, sel[s, c]] = lf[s, 0]

    def add(self, embeddings) -> np.ndarray:
        """Insert a batch; one round inserts up to K instances, one per
        lane.  Returns the global ids of the new rows."""
        xs = torch.as_tensor(embeddings, dtype=torch.float32,
                             device=self.device)
        if xs.dim() == 1:
            xs = xs.unsqueeze(0)
        B, K = xs.shape[0], self.K
        gids = np.arange(self.n_sentences, self.n_sentences + B)
        if B == 0:
            return gids
        self._flat_index = None
        lane_of = gids % K
        lens = np.bincount(lane_of, minlength=K)
        R_max = int(lens.max())
        self._ensure_capacity(R_max + 1)
        # pack the per-lane streams into (K, R_max, D) with one scatter
        order = np.argsort(lane_of, kind="stable")
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        lanes_sorted = lane_of[order]
        pos = np.arange(B) - starts[lanes_sorted]
        xs_t = torch.zeros((K, R_max, xs.shape[1]), dtype=torch.float32,
                           device=self.device)
        xs_t[torch.as_tensor(lanes_sorted, device=self.device),
             torch.as_tensor(pos, device=self.device)] = \
            xs[torch.as_tensor(order, device=self.device)]
        mask_t = np.zeros((K, R_max), bool)
        mask_t[lanes_sorted, pos] = True

        leaves = self._rounds(xs_t, mask_t, R_max, self._budget)
        self._alloc_hi += 2 * R_max
        self._retry(leaves, xs_t, mask_t)

        base = np.asarray([len(lst) for lst in self._leaf_of_local])
        pos_of = np.empty(B, np.int64)
        pos_of[order] = pos
        self.shard_of.extend(int(s) for s in lane_of)
        self.local_sid.extend((base[lane_of] + pos_of).tolist())
        for s in range(K):
            if lens[s]:
                self._leaf_of_local[s].extend(
                    int(v) for v in leaves[s, :lens[s]])
        self.n_sentences += B
        return gids

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
            self.cfg, self.state, self._leaf_global(), dtype=dtype,
            chase_depth=chase)

    def flat_index(self) -> "index_mod.PredictionIndex":
        """The whole forest flattened to one PredictionIndex over global
        sentence ids (``core/index.build_flat_forest_index``), the input of
        the blocked engines; cached until the next ``add``."""
        if self._flat_index is None:
            self._flat_index = index_mod.build_flat_forest_index(
                self.cfg, self.state, self._leaf_global())
        return self._flat_index

    def lane_signature(self, lane: int):
        """Structure signature of one lane's tree (see
        ``core/tree.structure_signature``)."""
        a = {k: v[lane] for k, v in
             tree_mod.state_to_numpy(self.state).items()}
        return tree_mod.structure_signature(
            a["counts"], a["means"], a["children"], a["n_children"],
            a["root"])
