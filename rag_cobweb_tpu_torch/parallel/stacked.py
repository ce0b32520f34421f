"""The stacked per-lane index of a K-lane forest, and the bookkeeping
that maps a forest's global sentence ids to lanes (port of the stacked
index of ``rag_cobweb_tpu/parallel/forest.py``; ``parallel/forest.py``
re-exports it).

``build_stacked_index`` builds each lane's prediction index on that lane
alone (``core/index.build_flat_forest_index`` over a one-lane view of the
state, so the lane's compact node ids, paths and layout are the JAX
``build_index``'s), then pads and stacks them on a leading lane axis as
the JAX package does: padding nodes carry ``inv_var = 1``, ``mu/var = 0``
and ``const = 0``, padding rows carry paths -1, weight 0 and global id -1.
The ``children``/``parent`` arrays come to the host once for all lanes;
the statistics stay on the device.  ``merge_stacked_to_flat`` flattens a
stacked index into one ``PredictionIndex`` over global sentence ids.

``lane_slots`` and ``extend_bookkeeping`` keep the JAX package's
bookkeeping of a batch routed to lanes (``shard_of``, ``local_sid``,
``_leaf_of_local``) for ``VForest``, ``CobwebForest`` and ``MeshVForest``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.core import tree as tree_mod


class StackedIndex(NamedTuple):
    """Per-lane PredictionIndex tensors stacked on a leading lane axis and
    padded to common sizes; ``sentence_valid`` masks the padding rows."""

    inv_var_T: torch.Tensor       # (K, D, N) f32
    mu_over_var_T: torch.Tensor   # (K, D, N) f32
    const: torch.Tensor           # (K, N) f32
    paths: torch.Tensor           # (K, S, P) lane-compact node ids, -1 pad
    path_weights: torch.Tensor    # (K, S, P) f32
    sentence_valid: torch.Tensor  # (K, S) bool
    leaf_node: torch.Tensor       # (K, S) compact id of the row's leaf
    global_sid: torch.Tensor      # (K, S) lane row -> global id, -1 pad
    children: torch.Tensor        # (K, N, F) compact child ids, -1 pad
    leaf_sentence_start: torch.Tensor  # (K, N)
    leaf_sentence_count: torch.Tensor  # (K, N)
    sentence_order: torch.Tensor  # (K, S) lane rows grouped by leaf

    def lane(self, s: int) -> index_mod.PredictionIndex:
        """The lane-local PredictionIndex view of lane ``s`` (padded to
        the stacked sizes)."""
        return index_mod.PredictionIndex(
            inv_var_T=self.inv_var_T[s], mu_over_var_T=self.mu_over_var_T[s],
            const=self.const[s], paths=self.paths[s],
            path_weights=self.path_weights[s], children=self.children[s],
            leaf_sentence_start=self.leaf_sentence_start[s],
            leaf_sentence_count=self.leaf_sentence_count[s],
            sentence_order=self.sentence_order[s],
            paths_h=self.paths[s].cpu().numpy().astype(np.int32),
            weights_h=self.path_weights[s].cpu().numpy(),
            order_h=self.sentence_order[s].cpu().numpy().astype(np.int32))


def _lane_state(st: tree_mod.TreeState, s: int) -> tree_mod.TreeState:
    """A one-lane view (no copy) of lane ``s`` of the stacked state."""
    return tree_mod.TreeState(**{f: getattr(st, f)[s:s + 1]
                                 for f in tree_mod.FIELDS})


def _stack(tensors, shape, fill, dtype=None) -> torch.Tensor:
    """The per-lane tensors written into one (K, *shape) tensor of
    ``fill``, each at its leading corner."""
    out = torch.full((len(tensors),) + tuple(shape), fill,
                     dtype=dtype or tensors[0].dtype,
                     device=tensors[0].device)
    for s, t in enumerate(tensors):
        out[(s,) + tuple(slice(0, d) for d in t.shape)] = t
    return out


def build_stacked_index(cfg, st: tree_mod.TreeState, leaf_of_local: list,
                        shard_of: list, local_sid: list,
                        n_sentences: int) -> StackedIndex:
    """Per-lane prediction indexes, padded to common shapes and stacked on
    a leading lane axis (the JAX ``build_stacked_index``, array for
    array)."""
    K = st.lanes
    children_h, parent_h, root_h = index_mod.host_structure(st)
    per = [index_mod.build_flat_forest_index(
        cfg, _lane_state(st, s), np.asarray(leaf_of_local[s], np.int64),
        host_struct=(children_h[s:s + 1], parent_h[s:s + 1],
                     root_h[s:s + 1]))
        for s in range(K)]
    D = cfg.dim
    N = max(i.num_nodes for i in per)
    S = max(max(i.num_sentences for i in per), 1)
    Pd = max(i.paths.shape[1] for i in per)
    F = max(i.children.shape[1] for i in per)
    dev = st.device
    gsid = np.full((K, S), -1, np.int64)
    if n_sentences:
        gsid[np.asarray(shard_of[:n_sentences]),
             np.asarray(local_sid[:n_sentences])] = np.arange(n_sentences)
    return StackedIndex(
        inv_var_T=_stack([i.inv_var_T for i in per], (D, N), 1.0),
        mu_over_var_T=_stack([i.mu_over_var_T for i in per], (D, N), 0.0),
        const=_stack([i.const for i in per], (N,), 0.0),
        paths=_stack([i.paths for i in per], (S, Pd), -1),
        path_weights=_stack([i.path_weights for i in per], (S, Pd), 0.0),
        sentence_valid=_stack(
            [torch.ones((i.num_sentences,), dtype=torch.bool, device=dev)
             for i in per], (S,), False),
        leaf_node=_stack([index_mod._sentence_leaf_nodes(i) for i in per],
                         (S,), 0),
        global_sid=torch.as_tensor(gsid, device=dev),
        children=_stack([i.children for i in per], (N, F), -1),
        leaf_sentence_start=_stack([i.leaf_sentence_start for i in per],
                                   (N,), -1),
        leaf_sentence_count=_stack([i.leaf_sentence_count for i in per],
                                   (N,), 0),
        sentence_order=_stack([i.sentence_order for i in per], (S,), 0))


def merge_stacked_to_flat(stacked: StackedIndex) -> index_mod.PredictionIndex:
    """ONE PredictionIndex over global sentence ids from a K-lane stacked
    index: lane l's compact node ids are offset by ``l * N``, the per-lane
    terms and paths concatenate, and the leaf runs follow the JAX
    package's global numbering (sentences sorted stably by leaf).  Not a
    beam index: there is no single root."""
    K, D, N = stacked.inv_var_T.shape
    dev = stacked.const.device
    Pd = stacked.paths.shape[2]
    paths = stacked.paths.cpu().numpy()
    pw = stacked.path_weights.cpu().numpy()
    gsid = stacked.global_sid.cpu().numpy()
    valid = gsid >= 0
    n_sent = int(valid.sum())
    offs = (np.arange(K) * N)[:, None, None]
    paths_off = np.where(paths >= 0, paths + offs, -1)
    flat_paths = np.full((n_sent, Pd), -1, np.int32)
    flat_pw = np.zeros((n_sent, Pd), np.float32)
    lanes, rows = np.nonzero(valid)
    sids = gsid[lanes, rows]
    flat_paths[sids] = paths_off[lanes, rows]
    flat_pw[sids] = pw[lanes, rows]

    plen = (flat_paths >= 0).sum(1)
    leaf_of = flat_paths[np.arange(n_sent), np.maximum(plen - 1, 0)]
    sent_order = np.argsort(leaf_of, kind="stable").astype(np.int32)
    leaf_start = np.full((K * N,), -1, np.int64)
    leaf_count = np.zeros((K * N,), np.int64)
    uniq, starts, counts = np.unique(leaf_of[sent_order], return_index=True,
                                     return_counts=True)
    leaf_start[uniq] = starts
    leaf_count[uniq] = counts
    kids = stacked.children.cpu().numpy()
    kids_flat = np.where(kids >= 0, kids + offs, -1).reshape(K * N, -1)

    def up(a):
        return torch.as_tensor(a, device=dev)

    return index_mod.PredictionIndex(
        inv_var_T=stacked.inv_var_T.permute(1, 0, 2).reshape(D, K * N)
        .contiguous(),
        mu_over_var_T=stacked.mu_over_var_T.permute(1, 0, 2)
        .reshape(D, K * N).contiguous(),
        const=stacked.const.reshape(K * N),
        paths=up(flat_paths.astype(np.int64)), path_weights=up(flat_pw),
        children=up(kids_flat.astype(np.int64)),
        leaf_sentence_start=up(leaf_start), leaf_sentence_count=up(leaf_count),
        sentence_order=up(sent_order.astype(np.int64)),
        paths_h=flat_paths, weights_h=flat_pw, order_h=sent_order)


def rank_stacked_index(cfg, st: tree_mod.TreeState, leaf_of_local: list,
                       gids_of_lane: list) -> StackedIndex:
    """The stacked index of a rank's lanes (``st``, one lane per entry of
    ``leaf_of_local``) whose rows carry their global sentence ids:
    ``gids_of_lane[l]`` lists lane l's rows' ids in row order."""
    sizes = [len(g) for g in gids_of_lane]
    shard_of = np.repeat(np.arange(len(sizes)), sizes)
    local_sid = np.concatenate([np.arange(n) for n in sizes] + [[]]) \
        .astype(np.int64)
    idx = build_stacked_index(cfg, st, leaf_of_local, shard_of, local_sid,
                              int(sum(sizes)))
    gmap = torch.as_tensor(
        np.concatenate([np.asarray(g, np.int64) for g in gids_of_lane]
                       + [np.zeros(1, np.int64)]), device=st.device)
    gsid = idx.global_sid
    return idx._replace(global_sid=torch.where(
        gsid >= 0, gmap[gsid.clamp(min=0)], gsid))


def lane_slots(lane_of: np.ndarray, n_lanes: int) -> np.ndarray:
    """(B,) each row's slot in its lane's stream of the batch (``lane_of``
    each row's lane; a lane's rows keep their order)."""
    order = np.argsort(lane_of, kind="stable")
    lens = np.bincount(lane_of, minlength=n_lanes)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    slot = np.empty(len(lane_of), np.int64)
    slot[order] = np.arange(len(lane_of)) - starts[lane_of[order]]
    return slot


def extend_bookkeeping(owner, lane_of: np.ndarray, slot: np.ndarray,
                       leaves: np.ndarray):
    """Append a batch to ``owner``'s JAX-layout bookkeeping: ``lane_of``
    (B,) each new row's lane (shard), ``slot`` (B,) its slot in the lane
    (``lane_slots``), ``leaves`` (lanes, R) each lane's leaves of the
    batch in slot order."""
    base = np.asarray([len(lst) for lst in owner._leaf_of_local])
    lens = np.bincount(lane_of, minlength=len(base))
    owner.shard_of.extend(int(s) for s in lane_of)
    owner.local_sid.extend((base[lane_of] + slot).tolist())
    for s, n in enumerate(lens):
        owner._leaf_of_local[s].extend(int(x) for x in leaves[s, :n])
    owner.n_sentences += len(lane_of)
