"""K lanes a rank over a mesh axis: the composed layout (port of
``rag_cobweb_tpu/parallel/mesh_vforest.py``).

N ranks x ``lanes_per_shard`` K lanes = L = N * K subtrees.  A row goes
to lane ``gid % L``; rank ``r`` holds lanes ``[r K, (r + 1) K)`` as one
port ``VForest`` of K lanes and inserts its own rows with the JAX
composed program: every round of the batch at the ``_DEEP_STEPS`` budget,
then each descent that budget cut, lane by lane in row order, on the
exact path at ``_EXACT_STEPS`` (``VForest.insert_packed``).  The leaves
are all-gathered, so every rank keeps the JAX bookkeeping over all L
lanes.  So each lane's tree is the one the JAX package's single-device
insert program builds for it, and the one a single
``VForest(n_subtrees=L)`` builds for its lane while no descent needs more
than its primary budget.

A query runs the single-device lane merge (``vforest._vforest_query``:
per-lane path-ranked top-k re-keyed by leaf log-prob) on the rank's
lanes, then the merge across ranks (``collectives.merge_topk``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.parallel import collectives
from rag_cobweb_tpu_torch.parallel import vforest as vf
from rag_cobweb_tpu_torch.parallel.distributed import axis_group, make_mesh
from rag_cobweb_tpu_torch.parallel.stacked import (StackedIndex,
                                                   extend_bookkeeping,
                                                   lane_slots,
                                                   rank_stacked_index)


class MeshVForest:
    """N mesh ranks x ``lanes_per_shard`` subtrees a rank."""

    def __init__(self, cfg: TreeConfig, mesh: Optional[DeviceMesh] = None,
                 lanes_per_shard: int = 4, capacity_per_lane: int = 4096,
                 seed: int = 0, axis_name: str = "shard", device="cuda"):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(
            axis_name=axis_name)
        self.axis = axis_name
        self.group, self.shard, self.n_shards = axis_group(self.mesh,
                                                           axis_name)
        self.K = lanes_per_shard
        self.L = self.n_shards * self.K
        self.lane0 = self.shard * self.K     # this rank's first lane
        self.forest = vf.VForest(cfg, n_subtrees=self.K,
                                 capacity_per_tree=capacity_per_lane,
                                 seed=seed + self.shard, device=device)
        self.device = self.forest.device
        self.n_sentences = 0
        self.shard_of: list[int] = []        # the LANE of each global id
        self.local_sid: list[int] = []
        self._leaf_of_local: list[list[int]] = [[] for _ in range(self.L)]
        self._stacked_index: Optional[StackedIndex] = None

    @property
    def state(self) -> tree_mod.TreeState:
        """This rank's K lanes."""
        return self.forest.state

    @classmethod
    def from_lane_state(cls, forest: vf.VForest, meta: dict,
                        mesh: Optional[DeviceMesh] = None,
                        axis_name: str = "shard") -> "MeshVForest":
        """The composed forest whose lanes on this rank are ``forest``
        (carried from the JAX package's stacked state, ``interop``), with
        the JAX bookkeeping over all lanes in ``meta``."""
        m = cls(forest.cfg, mesh, forest.K, forest.state.capacity,
                axis_name=axis_name, device=forest.device)
        m.forest = forest
        m.shard_of = [int(x) for x in meta["shard_of"]]
        m.local_sid = [int(x) for x in meta["local_sid"]]
        m._leaf_of_local = [[int(x) for x in lst]
                            for lst in meta["leaf_of_local"]]
        m.n_sentences = len(m.shard_of)
        return m

    def add(self, embeddings) -> np.ndarray:
        """Round-robin over all L lanes; each rank inserts its own lanes'
        rows (every round at ``_DEEP_STEPS``, the cut descents on the
        exact path).  Returns the global ids."""
        embeddings = np.asarray(embeddings, np.float32)
        B, K, L = len(embeddings), self.K, self.L
        gids = np.arange(self.n_sentences, self.n_sentences + B)
        if B == 0:
            return gids
        lane_of = gids % L
        slot = lane_slots(lane_of, L)
        mine = (lane_of >= self.lane0) & (lane_of < self.lane0 + K)
        leaves = self.forest.insert_packed(
            torch.as_tensor(embeddings[mine]), lane_of[mine] - self.lane0,
            slot[mine], vf._DEEP_STEPS, waves=False)
        R_all = int(np.bincount(lane_of, minlength=L).max())
        buf = torch.full((K, R_all), -1, dtype=torch.int64,
                         device=self.device)
        buf[:, :leaves.shape[1]] = torch.as_tensor(leaves,
                                                   device=self.device)
        every = collectives.all_gather(buf, self.group).cpu().numpy()
        extend_bookkeeping(self, lane_of, slot, every.reshape(L, -1))
        self._stacked_index = None
        return gids

    def lane_signature(self, lane: int):
        """Structure signature of global lane ``lane`` (on its rank)."""
        return self.forest.lane_signature(lane - self.lane0)

    def build_index(self) -> StackedIndex:
        """The stacked index of this rank's K lanes, rows carrying global
        ids, cached until the next ``add``."""
        if self._stacked_index is None:
            lanes = np.asarray(self.shard_of)
            own = [np.nonzero(lanes == lane)[0]
                   for lane in range(self.lane0, self.lane0 + self.K)]
            self._stacked_index = rank_stacked_index(
                self.cfg, self.state,
                self._leaf_of_local[self.lane0:self.lane0 + self.K], own)
        return self._stacked_index

    def query_topk(self, queries, k: int):
        """(B, D) -> (leaf log-prob scores (B, k), global ids (B, k)) as
        numpy, the same on every rank: the rank's K-lane merge, then the
        merge across ranks, both keyed on leaf log-prob."""
        idx = self.build_index()
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        lp, gids = vf._vforest_query(idx, q, k)
        rows = max(max(len(lst) for lst in self._leaf_of_local), 1)
        lp, gids = collectives.pad_columns(
            lp, gids, min(k, self.K * min(k, rows)))
        s, ids = collectives.merge_topk(lp, gids, k, self.group)
        return s.cpu().numpy(), ids.cpu().numpy()
