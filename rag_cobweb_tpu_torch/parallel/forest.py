"""The sharded forest over a mesh (port of
``rag_cobweb_tpu/parallel/forest.py``); the stacked per-lane index that
the JAX module also holds is ``parallel/stacked.py``, re-exported here.

``CobwebForest`` is one Cobweb tree a rank of a mesh axis (``make_mesh``),
SPMD over ``torch.distributed``: every rank calls ``add`` and
``query_topk`` with the same rows.  A row goes to shard ``gid % K``; each
rank inserts only its own rows into its one tree (``core/tree.CobwebTree``,
the whole batch as one chunk, as the JAX package's one ``insert_batch``),
and the leaves are all-gathered so that every rank keeps the JAX
package's bookkeeping (``shard_of``, ``local_sid``, ``_leaf_of_local``).
A query ranks the rank's rows by path score, re-keys its top-k by leaf
log-probability (the key calibrated alike on every shard) and merges the
ranks' candidates (``parallel/collectives.merge_topk``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.parallel import collectives
from rag_cobweb_tpu_torch.parallel.distributed import axis_group, make_mesh
# the stacked index's builders are re-exported, as the JAX module has them
from rag_cobweb_tpu_torch.parallel.stacked import (
    StackedIndex, build_stacked_index, extend_bookkeeping, lane_slots,
    merge_stacked_to_flat, rank_stacked_index)
from rag_cobweb_tpu_torch.parallel.vforest import _vforest_query


class CobwebForest:
    """A forest of Cobweb trees sharded one a rank over a mesh axis."""

    def __init__(self, cfg: TreeConfig, mesh: "DeviceMesh | None" = None,
                 capacity_per_shard: int = 4096, seed: int = 0,
                 axis_name: str = "shard", device="cuda"):
        """Every rank of the axis makes the forest with the same arguments;
        rank ``r`` holds shard ``r`` on ``device`` (the rank's card by
        default, or ``"cpu"``)."""
        full_f32_matmul()
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(
            axis_name=axis_name)
        self.axis = axis_name
        self.group, self.shard, self.n_shards = axis_group(self.mesh,
                                                           axis_name)
        self.device = resolve_device(device)
        self.capacity = capacity_per_shard
        self.tree = tree_mod.CobwebTree(cfg, capacity_per_shard,
                                        seed=seed + self.shard,
                                        device=self.device)
        self.n_sentences = 0
        self.shard_of: list[int] = []
        self.local_sid: list[int] = []
        self._leaf_of_local: list[list[int]] = [
            [] for _ in range(self.n_shards)]
        self._stacked_index: "StackedIndex | None" = None

    @property
    def state(self) -> tree_mod.TreeState:
        """This rank's shard (a one-lane state)."""
        return self.tree.state

    @classmethod
    def from_shard_state(cls, tree: tree_mod.CobwebTree, meta: dict,
                         mesh: "DeviceMesh | None" = None,
                         axis_name: str = "shard") -> "CobwebForest":
        """The forest whose shard on this rank is ``tree`` (its state
        carried from the JAX package's stacked state, ``interop``), with
        the JAX bookkeeping in ``meta`` (``shard_of``, ``local_sid``,
        ``leaf_of_local``)."""
        f = cls(tree.cfg, mesh, tree.state.capacity, axis_name=axis_name,
                device=tree.device)
        f.tree = tree
        f.shard_of = [int(x) for x in meta["shard_of"]]
        f.local_sid = [int(x) for x in meta["local_sid"]]
        f._leaf_of_local = [[int(x) for x in lst]
                            for lst in meta["leaf_of_local"]]
        f.n_sentences = len(f.shard_of)
        return f

    def add(self, embeddings) -> np.ndarray:
        """Insert a batch, routed round-robin by global id; returns the
        global ids.  Each shard's rows go in as one batch (a descent past
        48 steps retried on the exact path after it, where the JAX
        package records leaf -1)."""
        embeddings = np.asarray(embeddings, np.float32)
        B, K = len(embeddings), self.n_shards
        gids = np.arange(self.n_sentences, self.n_sentences + B)
        shard_of = gids % K
        mine = embeddings[shard_of == self.shard]
        leaves = (self.tree.fit(mine, batch_size=len(mine)) if len(mine)
                  else np.zeros((0,), np.int64))
        width = max(int(np.bincount(shard_of, minlength=K).max()), 1)
        buf = torch.full((width,), -1, dtype=torch.int64, device=self.device)
        buf[:len(leaves)] = torch.as_tensor(leaves, device=self.device)
        every = collectives.all_gather(buf, self.group).cpu().numpy()
        extend_bookkeeping(self, shard_of, lane_slots(shard_of, K), every)
        self._stacked_index = None
        return gids

    def build_index(self) -> StackedIndex:
        """This rank's shard's prediction index (a one-lane stacked index
        whose rows carry global ids), cached until the next ``add``."""
        if self._stacked_index is None:
            own = np.nonzero(np.asarray(self.shard_of) == self.shard)[0]
            self._stacked_index = rank_stacked_index(
                self.cfg, self.state, [self._leaf_of_local[self.shard]],
                [own])
        return self._stacked_index

    def _rows_common(self) -> int:
        """The JAX package's common per-shard row count (the padded S)."""
        return max(max(len(lst) for lst in self._leaf_of_local), 1)

    def query_topk(self, queries, k: int):
        """(B, D) queries -> (leaf log-prob scores (B, k), global ids (B,
        k)) as numpy, the same on every rank: this shard's top-k by path
        score re-keyed by leaf log-prob, merged across the ranks."""
        idx = self.build_index()
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        lp, gids = _vforest_query(idx, q, k)
        lp, gids = collectives.pad_columns(lp, gids,
                                           min(k, self._rows_common()))
        s, ids = collectives.merge_topk(lp, gids, k, self.group)
        return s.cpu().numpy(), ids.cpu().numpy()
