"""Flat array-of-nodes Cobweb tree (port of ``rag_cobweb_tpu/core/tree.py``).

The state is a structure of arrays with a leading LANE axis, so one
descent function serves the single tree (one lane) and the K-lane forest
(``parallel/vforest.py``): ``counts (K, N)``, ``means``/``m2s (K, N, D)``,
``parent (K, N)``, ``children (K, N, F)`` (-1 sentinel), ``n_children``,
per-lane ``root``/``n_alloc``/``free_top`` and a ``free_stack (K, N)``.
Every per-node array carries ONE extra scratch row at index ``capacity``:
``index_put_`` has no ``mode="drop"``, so writes that a step does not make
(index -1) are routed there, and nothing ever reads it.

A descent reads the state as it was when the descent began and records
each step's effects as a small descriptor; once every lane has finished,
the descriptors of the lanes that reached a leaf are applied in step
order.  Reading a frozen state is exact: a step only reads nodes below the
current one, which the descent has not touched, and it carries the truth
about the current node itself.  Applying afterwards gives the three
behaviours the JAX package fixes:

  * pops consume the pre-descent free stack top-down, and nodes freed
    during a descent land on the stack only after it;
  * a descent cut off by its step budget applies nothing, so a deeper
    retry re-runs the whole insert;
  * lanes without an instance (padding) never write.

Within one step no two writes of a lane hit the same row, so applying
steps in order needs no "last writer wins" rule (``index_put_`` with
duplicate indices has no defined order on CUDA).

``means``/``m2s`` may be stored compressed (bf16 at rest, ``compress_stats``
of the forest and the wrapper).  Every read upcasts them to f32 and
``_apply`` rounds its f32 results into the stored dtype, so the descent
math stays f32, as in the JAX package.

Counters and spans (``utils/profiling``): a descent counts one
``insert.rounds``, its steps on ``insert.steps`` and its per-step done
checks on ``insert.syncs``, and spans ``_apply`` as ``insert.apply``;
``grow_state`` and each ``StepGraph`` capture are the spans
``insert.grow`` and ``insert.graph_capture``, counted on
``insert.grows`` and ``insert.graph_captures``.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import math
import os
from collections import defaultdict, deque

import numpy as np
import torch

from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.device import resolve_device
from rag_cobweb_tpu_torch.ops import opscore
from rag_cobweb_tpu_torch.ops.gaussian import (GaussStats, chan_merge,
                                               compute_var, welford_insert)
from rag_cobweb_tpu_torch.utils import profiling

NULL = -1
EXACT_STEPS = 256  # cap of the exact path for over-deep descents


def align_capacity(n: int) -> int:
    """Node capacity rounded up to 8, or to 256 from 2048 on.  Kept exactly
    as in the JAX package: capacity fixes the global leaf ids
    ``lane * capacity + local``."""
    q = 256 if n >= 2048 else 8
    return -(-int(n) // q) * q


_INT_FIELDS = ("parent", "children", "n_children", "root", "n_alloc",
               "free_stack", "free_top")
FIELDS = ("counts", "means", "m2s", "parent", "children", "n_children",
          "root", "n_alloc", "free_stack", "free_top")


@dataclasses.dataclass
class TreeState:
    """K stacked trees; per-node arrays hold ``capacity + 1`` rows (the
    last is the write scratch row)."""

    counts: torch.Tensor      # (K, N+1) f32
    means: torch.Tensor       # (K, N+1, D) f32
    m2s: torch.Tensor         # (K, N+1, D) f32
    parent: torch.Tensor      # (K, N+1) i64, -1 for root / unallocated
    children: torch.Tensor    # (K, N+1, F) i64, -1 sentinel
    n_children: torch.Tensor  # (K, N+1) i64
    root: torch.Tensor        # (K,) i64
    n_alloc: torch.Tensor     # (K,) i64 high-water mark
    free_stack: torch.Tensor  # (K, N+1) i64
    free_top: torch.Tensor    # (K,) i64

    @property
    def capacity(self) -> int:
        return self.counts.shape[1] - 1

    @property
    def lanes(self) -> int:
        return self.counts.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def fanout(self) -> int:
        return self.children.shape[2]

    @property
    def device(self) -> torch.device:
        return self.counts.device


def init_state(lanes: int, capacity: int, dim: int, fanout: int,
               device, stats_dtype=torch.float32) -> TreeState:
    """Empty trees: each root allocated with count 0; ``means``/``m2s``
    stored in ``stats_dtype``."""
    n = align_capacity(capacity) + 1
    K, dev = lanes, device
    i64 = dict(dtype=torch.int64, device=dev)
    return TreeState(
        counts=torch.zeros((K, n), dtype=torch.float32, device=dev),
        means=torch.zeros((K, n, dim), dtype=stats_dtype, device=dev),
        m2s=torch.zeros((K, n, dim), dtype=stats_dtype, device=dev),
        parent=torch.full((K, n), NULL, **i64),
        children=torch.full((K, n, fanout), NULL, **i64),
        n_children=torch.zeros((K, n), **i64),
        root=torch.zeros((K,), **i64),
        n_alloc=torch.ones((K,), **i64),
        free_stack=torch.full((K, n), NULL, **i64),
        free_top=torch.zeros((K,), **i64),
    )


def grow_state(st: TreeState, new_capacity: int) -> TreeState:
    """Copy ``st`` into arrays of ``new_capacity`` nodes per lane (the
    stats keep their stored dtype)."""
    cap = st.capacity
    profiling.count("insert.grows")
    with profiling.span("insert.grow", capacity=new_capacity):
        out = init_state(st.lanes, new_capacity, st.dim, st.fanout,
                         st.device, st.means.dtype)
        for name in ("counts", "means", "m2s", "parent", "children",
                     "n_children", "free_stack"):
            getattr(out, name)[:, :cap] = getattr(st, name)[:, :cap]
        for name in ("root", "n_alloc", "free_top"):
            setattr(out, name, getattr(st, name).clone())
    return out


def _is_bf16(a: np.ndarray) -> bool:
    """A host array of bf16 values: ml_dtypes' bfloat16, or the raw
    2-byte void records ``np.load`` returns for a file that held one."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def state_to_numpy(st: TreeState, raw: bool = False) -> dict:
    """Host arrays in the JAX package's layout and dtypes (no scratch row),
    the stats upcast to f32.  ``raw``: bf16 stats as they are stored, as
    the 2-byte records (``<V2``) that ``np.savez`` writes for the JAX
    package's bf16 arrays, so a compressed forest's file holds what the
    JAX package's holds."""
    cap = st.capacity
    out = {}
    for name in FIELDS:
        a = getattr(st, name)
        if a.dim() >= 2:
            a = a[:, :cap]
        if a.dtype == torch.bfloat16:
            a = (a.view(torch.int16).cpu().numpy().view("<V2") if raw
                 else a.float().cpu().numpy())
        else:
            a = a.cpu().numpy()
        out[name] = a.astype(np.int32) if name in _INT_FIELDS else a
    return out


def _stats_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host stats array as a tensor: bf16 arrays (``_is_bf16``) keep
    their bits, anything else becomes f32."""
    if _is_bf16(a):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.as_tensor(bits, device=device).view(torch.bfloat16)
    return torch.as_tensor(a.astype(np.float32), device=device)


def state_from_numpy(arrays: dict, device) -> TreeState:
    """Inverse of ``state_to_numpy``: (K, N, ...) arrays -> TreeState.
    Compressed (bf16) stats stay compressed."""
    K, cap = np.asarray(arrays["counts"]).shape
    D = np.asarray(arrays["means"]).shape[2]
    F = np.asarray(arrays["children"]).shape[2]
    bf16 = _is_bf16(np.asarray(arrays["means"]))
    st = init_state(K, cap, D, F, device,
                    torch.bfloat16 if bf16 else torch.float32)
    if st.capacity != cap:
        raise ValueError(f"capacity {cap} is not aligned")
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if name in ("means", "m2s"):
            t = _stats_tensor(a, device)
        elif name in _INT_FIELDS:
            t = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            t = torch.as_tensor(a.astype(np.float32), device=device)
        if t.dim() >= 2:
            getattr(st, name)[:, :cap] = t
        else:
            setattr(st, name, t.clone())
    return st


def compress_state(st: TreeState, dtype=None) -> TreeState:
    """``st`` with ``means``/``m2s`` cast to ``dtype`` (None: bf16; a torch
    dtype or its name) in new tensors, the f32 ones freed once the caller
    drops them; ``st`` itself when they are stored so already."""
    if dtype is None:
        dtype = torch.bfloat16
    elif isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if st.means.dtype == dtype:
        return st
    return dataclasses.replace(st, means=st.means.to(dtype),
                               m2s=st.m2s.to(dtype))


def state_to(st: TreeState, device) -> TreeState:
    """Every field of ``st`` on ``device``; moved to the host from the
    card, into pinned memory, so the move back is one DMA a field."""
    device = resolve_device(device)
    if st.device == device:
        return st
    pin = device.type == "cpu" and st.device.type == "cuda"

    def move(t):
        if pin:
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)
        return t.to(device)

    return TreeState(**{n: move(getattr(st, n)) for n in FIELDS})


def state_bytes(st: TreeState) -> int:
    """Bytes of every field of ``st``."""
    return sum(getattr(st, n).nbytes for n in FIELDS)


# ---------------------------------------------------------------------------
# the descent
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _View:
    """Carried truth about each lane's current node."""

    cur: torch.Tensor       # (K,)
    count: torch.Tensor     # (K,)
    mean: torch.Tensor      # (K, D)
    m2: torch.Tensor        # (K, D)
    row: torch.Tensor       # (K, F) children of cur
    n: torch.Tensor         # (K,)
    parent: torch.Tensor    # (K,)
    prev_row: torch.Tensor  # (K, F) children row of the node we came from
    prev_n: torch.Tensor    # (K,)

    def select(self, cond: torch.Tensor, other: "_View") -> "_View":
        """Fieldwise ``where(cond, self, other)`` over lanes."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            c = cond.view((-1,) + (1,) * (a.dim() - 1))
            out[f.name] = torch.where(c, a, b)
        return _View(**out)


def _node_view(st: TreeState, lanes, node, parent, prev_row, prev_n):
    return _View(cur=node, count=st.counts[lanes, node],
                 mean=st.means[lanes, node].float(),
                 m2=st.m2s[lanes, node].float(),
                 row=st.children[lanes, node], n=st.n_children[lanes, node],
                 parent=parent, prev_row=prev_row, prev_n=prev_n)


def _gather_stats(st: TreeState, lanes, idx) -> GaussStats:
    """Stats of nodes ``idx`` (K, M) per lane; -1 entries read row 0 and
    are masked by the caller."""
    safe = idx.clamp(min=0)
    li = lanes.unsqueeze(1)
    return GaussStats(st.counts[li, safe], st.means[li, safe].float(),
                      st.m2s[li, safe].float())


def _compact(slots, keep):
    """Stable-compact the kept entries of each row to the front, -1 after."""
    F = slots.shape[1]
    pos = torch.arange(F, device=slots.device).expand_as(slots)
    order = torch.argsort(torch.where(keep, pos, pos + F), dim=1)
    return torch.where(keep.gather(1, order), slots.gather(1, order),
                       torch.full_like(slots, NULL))


def _peek_slots(st: TreeState, lanes, free_top, n_alloc):
    """The next two fresh slots of each lane: pre-descent free stack top
    first, then the high-water mark."""
    s0 = torch.where(free_top >= 1,
                     st.free_stack[lanes, (free_top - 1).clamp(min=0)],
                     n_alloc)
    s1 = torch.where(free_top >= 2,
                     st.free_stack[lanes, (free_top - 2).clamp(min=0)],
                     torch.where(free_top >= 1, n_alloc, n_alloc + 1))
    return s0, s1


@dataclasses.dataclass
class _Delta:
    """One step's writes per lane (index -1 = no write)."""

    stat_idx: torch.Tensor    # (K, 2)
    stat_count: torch.Tensor  # (K, 2)
    stat_mean: torch.Tensor   # (K, 2, D)
    stat_m2: torch.Tensor     # (K, 2, D)
    crow_idx: torch.Tensor    # (K, 3)
    crow_vals: torch.Tensor   # (K, 3, F)
    crow_n: torch.Tensor      # (K, 3)
    par_idx: torch.Tensor     # (K, F + 3)
    par_val: torch.Tensor     # (K, F + 3)
    root: torch.Tensor        # (K,)
    free_node: torch.Tensor   # (K,)


def _step(st: TreeState, lanes, v: _View, x, s0, s1, depth,
          cfg: TreeConfig, noise_two, noise_op):
    """One descent decision for every lane.  Both the leaf rule and the
    internal-node rule are evaluated and selected per lane; ``noise_two``
    (K, F) and ``noise_op`` (K, 4) break exact ties.  Returns (delta,
    slots_used, done, leaf, next view)."""
    K, F = v.row.shape
    dev = x.device
    neg = torch.full_like(v.cur, NULL)
    cur = v.cur
    inc = welford_insert(GaussStats(v.count, v.mean, v.m2), x)
    is_leaf = v.n == 0

    # --- leaf: exact-match / empty absorb, else fringe split -------------
    std = torch.sqrt(v.m2 / v.count.clamp(min=1.0).unsqueeze(1))
    zero = torch.zeros_like(std)
    exact = ((v.count > 0)
             & torch.isclose(std, zero, rtol=1e-5, atol=1e-8).all(dim=1)
             & torch.isclose(x, v.mean, rtol=1e-5, atol=1e-8).all(dim=1))
    absorb = exact | (v.count == 0.0)
    if cfg.absorb_depth:
        absorb = absorb | ((v.count > 0) & (depth >= cfg.absorb_depth))
    absorb = is_leaf & absorb
    fringe = is_leaf & ~absorb
    has_parent = v.parent >= 0

    # --- internal: score {best, new, merge, split} -----------------------
    child_idx = v.row
    mask = child_idx >= 0
    children = _gather_stats(st, lanes, child_idx)
    parent = GaussStats(v.count, v.mean, v.m2)
    tb = opscore.two_best_children(x, parent, children, mask, cfg, noise_two)
    b1_node = child_idx.gather(1, tb.best1.unsqueeze(1)).squeeze(1)
    b2_node = torch.where(
        tb.best2 >= 0,
        child_idx.gather(1, tb.best2.clamp(min=0).unsqueeze(1)).squeeze(1),
        neg)
    b1_safe = b1_node.clamp(min=0)
    gc_idx = st.children[lanes, b1_safe]
    gc_mask = gc_idx >= 0
    grandchildren = _gather_stats(st, lanes, gc_idx)
    nc = v.n
    n_gc_b1 = st.n_children[lanes, b1_safe]
    if cfg.greedy:
        op = torch.full_like(nc, opscore.OP_NEW)
    else:
        op, _ = opscore.best_operation(
            x, parent, children, mask, tb, grandchildren, gc_mask, cfg,
            noise_op, nc >= F, (nc - 1 + n_gc_b1) <= F)
    internal = ~is_leaf
    best = internal & (op == opscore.OP_BEST)
    new = internal & (op == opscore.OP_NEW)
    merge = internal & (op == opscore.OP_MERGE)
    split = internal & (op == opscore.OP_SPLIT)

    col = torch.arange(F, device=dev).unsqueeze(0)
    minus = torch.full_like(child_idx, NULL)

    def w(c, a, b):
        c = c.view((-1,) + (1,) * (a.dim() - 1)) if a.dim() > 1 else c
        return torch.where(c, a, b)

    # fringe rows: the new parent p_new = s0 takes cur and the leaf s1
    p_row = torch.where(col == 0, cur.unsqueeze(1),
                        torch.where(col == 1, s1.unsqueeze(1), minus))
    spliced = torch.where(v.prev_row == cur.unsqueeze(1), s0.unsqueeze(1),
                          v.prev_row)
    # new: append s0 to cur's row
    new_row = torch.where(col == nc.clamp(max=F - 1).unsqueeze(1),
                          s0.unsqueeze(1), child_idx)
    # merge: M = s0 adopts best1/best2
    m_stats = chan_merge(opscore._pick(children, tb.best1),
                         opscore._pick(children, tb.best2))
    keep_m = mask & (child_idx != b1_node.unsqueeze(1)) \
        & (child_idx != b2_node.unsqueeze(1))
    merge_row = torch.where(col == (nc - 2).clamp(0, F - 1).unsqueeze(1),
                            s0.unsqueeze(1), _compact(child_idx, keep_m))
    m_row = torch.where(col == 0, b1_node.unsqueeze(1),
                        torch.where(col == 1, b2_node.unsqueeze(1), minus))
    # split: promote best1's children into cur's row
    keep_s = mask & (child_idx != b1_node.unsqueeze(1))
    n_keep = (nc - 1).unsqueeze(1)
    gc_gath = gc_idx.gather(1, (col - n_keep).clamp(0, F - 1).expand(K, F))
    split_row = torch.where(
        col < n_keep, _compact(child_idx, keep_s),
        torch.where(col < n_keep + n_gc_b1.unsqueeze(1), gc_gath, minus))

    # --- the step's writes ------------------------------------------------
    stat0 = torch.where(split, neg, torch.where(fringe, s0, cur))
    stat1 = torch.where(fringe, s1, torch.where(new | merge, s0, neg))
    stat_idx = torch.stack([stat0, stat1], dim=1)
    stat_count = torch.stack(
        [inc.count, torch.where(merge, m_stats.count,
                                torch.ones_like(inc.count))], dim=1)
    stat_mean = torch.stack([inc.mean, w(merge, m_stats.mean, x)], dim=1)
    stat_m2 = torch.stack(
        [inc.m2, w(merge, m_stats.m2, torch.zeros_like(x))], dim=1)

    crow0 = torch.where(fringe, s0,
                        torch.where(new | merge | split, cur, neg))
    crow1 = torch.where(fringe, torch.where(has_parent, v.parent, neg),
                        torch.where(new | merge, s0, neg))
    crow2 = torch.where(fringe, s1, neg)
    crow_idx = torch.stack([crow0, crow1, crow2], dim=1)
    vals0 = w(fringe, p_row, w(new, new_row, w(merge, merge_row, split_row)))
    vals1 = w(fringe, spliced, w(merge, m_row, minus))
    crow_vals = torch.stack([vals0, vals1, minus], dim=1)
    two = torch.full_like(nc, 2)
    zero_n = torch.zeros_like(nc)
    n0 = torch.where(fringe, two, torch.where(
        new, nc + 1, torch.where(merge, nc - 1, n_keep.squeeze(1) + n_gc_b1)))
    n1 = torch.where(fringe, v.prev_n, torch.where(merge, two, zero_n))
    crow_n = torch.stack([n0, n1, zero_n], dim=1)

    p3_idx = torch.stack([
        torch.where(fringe | new | merge, s0, neg),
        torch.where(fringe, cur, torch.where(merge, b1_node, neg)),
        torch.where(fringe, s1, torch.where(merge, b2_node, neg)),
    ], dim=1)
    p3_val = torch.stack([torch.where(fringe, v.parent, cur), s0, s0], dim=1)
    sp_idx = torch.where(split.unsqueeze(1) & gc_mask, gc_idx, minus)
    sp_val = cur.unsqueeze(1).expand(K, F)
    delta = _Delta(
        stat_idx=stat_idx, stat_count=stat_count, stat_mean=stat_mean,
        stat_m2=stat_m2, crow_idx=crow_idx, crow_vals=crow_vals,
        crow_n=crow_n,
        par_idx=torch.cat([sp_idx, p3_idx], dim=1),
        par_val=torch.cat([sp_val, p3_val], dim=1),
        root=torch.where(fringe & ~has_parent, s0, neg),
        free_node=torch.where(split, b1_node, neg),
    )
    slots_used = torch.where(fringe, two, torch.where(
        new | merge, torch.ones_like(nc), zero_n))
    done = absorb | fringe | new
    leaf = torch.where(absorb, cur, torch.where(
        fringe, s1, torch.where(new, s0, neg)))

    # --- where the descent goes next -------------------------------------
    # best: best1 read from the (untouched) state; merge: the virtual node
    # M carried; split: the rewritten current node carried
    at_b1 = _node_view(st, lanes, b1_safe, cur, child_idx, nc)
    at_m = _View(cur=s0, count=m_stats.count, mean=m_stats.mean,
                 m2=m_stats.m2, row=m_row, n=two, parent=cur,
                 prev_row=merge_row, prev_n=nc - 1)
    at_split = dataclasses.replace(v, row=split_row,
                                   n=n_keep.squeeze(1) + n_gc_b1)
    nxt = at_b1.select(best, at_m.select(merge, at_split.select(split, v)))
    return delta, slots_used, done, leaf, nxt


@dataclasses.dataclass
class _Carry:
    """What a lockstep descent carries from one step to the next."""

    v: _View
    free_top: torch.Tensor  # (K,) virtual free-stack top
    n_alloc: torch.Tensor   # (K,) virtual high-water mark
    done: torch.Tensor      # (K,) bool
    leaf: torch.Tensor      # (K,)

    def tensors(self):
        return [getattr(self.v, f.name) for f in dataclasses.fields(_View)] \
            + [self.free_top, self.n_alloc, self.done, self.leaf]


def _advance(st: TreeState, lanes, c: _Carry, x, noise_two, noise_op, depth,
             cfg: TreeConfig):
    """One lockstep step of every unfinished lane: the decision and the
    carry update.  Reads ``st`` only.  Returns (next carry, live, delta)."""
    live = ~c.done
    s0, s1 = _peek_slots(st, lanes, c.free_top, c.n_alloc)
    d, used, fin, lf, nxt = _step(st, lanes, c.v, x, s0, s1, depth, cfg,
                                  noise_two, noise_op)
    from_free = torch.minimum(used, c.free_top)
    nc = _Carry(v=nxt.select(live, c.v),
                free_top=torch.where(live, c.free_top - from_free, c.free_top),
                n_alloc=torch.where(live, c.n_alloc + used - from_free,
                                    c.n_alloc),
                done=c.done | (live & fin),
                leaf=torch.where(live & fin, lf, c.leaf))
    return nc, live, d


def _state_key(st: TreeState):
    """The state arrays a captured step reads, by address and dtype: a
    cast or a move makes new tensors, which may reuse freed addresses."""
    return tuple((getattr(st, n).data_ptr(), getattr(st, n).dtype)
                 for n in ("counts", "means", "m2s", "children",
                           "n_children", "free_stack"))


class StepGraph:
    """``_advance`` captured as one CUDA graph for one state allocation.

    Eager, a step is ~300 launches of tiny kernels and the build is bound
    by host dispatch; replaying the graph makes it one launch plus the
    copies of its inputs and outputs.  The graph reads the state arrays
    by address (``_apply`` updates them in place), so it is valid while
    ``matches(st)``: capacity growth reallocates them and needs a new
    graph.  The same function runs eagerly on the host, so both paths
    compute the same step.  Its carry is f32 whatever the stored stats
    dtype, so the descent math is f32 on a compressed state too."""

    def __init__(self, st: TreeState, cfg: TreeConfig):
        if st.device.type != "cuda":
            raise ValueError(f"a StepGraph captures a state on the card, "
                             f"not on {st.device}")
        profiling.count("insert.graph_captures")
        with profiling.span("insert.graph_capture", lanes=st.lanes):
            self._capture(st, cfg)

    def _capture(self, st: TreeState, cfg: TreeConfig):
        K, F, D, dev = st.lanes, st.fanout, st.dim, st.device
        self.key = _state_key(st)
        # every tensor the graph reads stays referenced here: a replay
        # reads by address, so a freed input would be reused memory
        self.lanes = torch.arange(K, device=dev)

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        f32 = torch.float32
        self.inp = _Carry(
            v=_View(cur=z(K), count=z(K, dtype=f32), mean=z(K, D, dtype=f32),
                    m2=z(K, D, dtype=f32), row=z(K, F), n=z(K), parent=z(K),
                    prev_row=z(K, F), prev_n=z(K)),
            free_top=z(K), n_alloc=z(K),
            done=torch.ones((K,), dtype=torch.bool, device=dev), leaf=z(K))
        self.x = z(K, D, dtype=f32)
        self.noise_two = z(K, F, dtype=f32)
        self.noise_op = z(K, 4, dtype=f32)
        self.depth = z()

        def run():
            return _advance(st, self.lanes, self.inp, self.x,
                            self.noise_two, self.noise_op, self.depth, cfg)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):     # warm-up: allocations, handles
            run()
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run()

    def matches(self, st: TreeState) -> bool:
        return self.key == _state_key(st)

    def begin(self, c: _Carry, xs: torch.Tensor) -> _Carry:
        """Load a descent's initial carry and instances; returns the carry
        that ``step`` updates in place."""
        for dst, src in zip(self.inp.tensors(), c.tensors()):
            dst.copy_(src)
        self.x.copy_(xs)
        return self.inp

    def step(self, t: int, gen: torch.Generator):
        self.noise_two.uniform_(0.0, 1.0, generator=gen)
        self.noise_op.uniform_(0.0, 1.0, generator=gen)
        self.depth.fill_(t)
        self.graph.replay()
        nc, live, d = self.out
        for dst, src in zip(self.inp.tensors(), nc.tensors()):
            dst.copy_(src)
        return live.clone(), _Delta(**{f.name: getattr(d, f.name).clone()
                                       for f in dataclasses.fields(_Delta)})


def descend(st: TreeState, xs: torch.Tensor, active: torch.Tensor,
            cfg: TreeConfig, max_steps: int, gen: torch.Generator,
            graph: "StepGraph | None" = None) -> torch.Tensor:
    """Insert ``xs[l]`` into lane ``l`` for every ``active`` lane, one
    lockstep descent with at most ``max_steps`` steps.  Lanes that reach a
    leaf apply their effects to ``st`` in place; lanes cut off by the
    budget apply nothing.  ``graph`` (CUDA only) replays each step from a
    captured graph.  Returns the leaf slot per lane, -1 where nothing was
    inserted."""
    K, F, dev = st.lanes, st.fanout, st.device
    lanes = torch.arange(K, device=dev)
    root = st.root
    c = _Carry(
        v=_node_view(st, lanes, root, st.parent[lanes, root],
                     torch.full((K, F), NULL, dtype=torch.int64, device=dev),
                     torch.zeros((K,), dtype=torch.int64, device=dev)),
        free_top=st.free_top.clone(), n_alloc=st.n_alloc.clone(),
        done=~active, leaf=torch.full((K,), NULL, dtype=torch.int64,
                                      device=dev))
    if graph is not None:
        c = graph.begin(c, xs)
    record = []
    for t in range(max_steps):
        profiling.count("insert.syncs")     # the done check waits
        if bool(c.done.all()):
            break
        if graph is not None:
            record.append(graph.step(t, gen))
            continue
        noise_two = torch.rand((K, F), generator=gen, device=dev)
        noise_op = torch.rand((K, 4), generator=gen, device=dev)
        c, live, d = _advance(st, lanes, c, xs, noise_two, noise_op, t, cfg)
        record.append((live, d))
    profiling.count("insert.rounds")
    profiling.count("insert.steps", len(record))
    ok = active & (c.leaf >= 0)
    with profiling.span("insert.apply", steps=len(record)):
        _apply(st, lanes, record, ok, c.free_top, c.n_alloc)
    return torch.where(ok, c.leaf, torch.full_like(c.leaf, NULL))


def _apply(st: TreeState, lanes, record, ok, free_top, n_alloc):
    """Apply the recorded steps of the ``ok`` lanes in step order, then the
    allocation bookkeeping: in-descent frees are pushed after the pops."""
    cap = st.capacity
    li = lanes.unsqueeze(1)
    top = free_top.clone()
    for live, d in record:
        wlane = (ok & live).unsqueeze(1)

        def tgt(idx):
            return torch.where(wlane & (idx >= 0), idx,
                               torch.full_like(idx, cap))

        si = tgt(d.stat_idx)
        st.counts[li, si] = d.stat_count
        st.means[li, si] = d.stat_mean.to(st.means.dtype)
        st.m2s[li, si] = d.stat_m2.to(st.m2s.dtype)
        ci = tgt(d.crow_idx)
        st.children[li, ci] = d.crow_vals
        st.n_children[li, ci] = d.crow_n
        st.parent[li, tgt(d.par_idx)] = d.par_val
        wl = wlane.squeeze(1)
        st.root = torch.where(wl & (d.root >= 0), d.root, st.root)
        push = wl & (d.free_node >= 0)
        slot = torch.where(push, top, torch.full_like(top, cap))
        st.free_stack[lanes, slot] = d.free_node
        top = top + push.long()
    st.free_top = torch.where(ok, top, st.free_top)
    st.n_alloc = torch.where(ok, n_alloc, st.n_alloc)


# ---------------------------------------------------------------------------
# host-side inspection (shared by the tree and the forest lanes)
# ---------------------------------------------------------------------------

def structure_signature(counts, means, children, n_children, root: int):
    """Order-invariant nested (count, mean, children) signature, rounded to
    4 decimals — the form ``tests/reference_oracle.OracleTree.signature``
    returns."""

    def sig(n):
        nc = int(n_children[n])
        kids = tuple(sorted(sig(int(children[n, i])) for i in range(nc)))
        return (round(float(counts[n]), 4),
                tuple(round(float(v), 4) for v in means[n]), kids)

    return sig(int(root))


def analyze_arrays(children, n_children, root: int) -> dict:
    """Structure statistics of one tree (breadth-first)."""
    leaf_count = 0
    level_counts: dict = defaultdict(int)
    fanout_hist: dict = defaultdict(int)
    q = deque([(int(root), 0)])
    while q:
        n, lvl = q.popleft()
        level_counts[lvl] += 1
        nc = int(n_children[n])
        if nc == 0:
            leaf_count += 1
        else:
            fanout_hist[nc] += 1
            for i in range(nc):
                q.append((int(children[n, i]), lvl + 1))
    return {
        "leaf_count": leaf_count,
        "level_counts": dict(level_counts),
        "fanout_histogram": dict(fanout_hist),
        "max_depth": max(level_counts) if level_counts else 0,
        "num_nodes": sum(level_counts.values()),
    }


class CobwebTree:
    """One Cobweb tree (a one-lane state): the host facade of the JAX
    package's ``CobwebTree`` (reference ``CobwebTorchTree``): ``fit``,
    ``ifit``, ``categorize``, ``dump_json``/``load_json``,
    ``save_npz``/``load_npz`` and the structure inspectors.

    On the card each descent step replays a captured CUDA graph
    (``StepGraph``), recaptured when capacity growth reallocates the
    state; on the host the same step runs eagerly."""

    def __init__(self, cfg: TreeConfig, capacity: int = 4096, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.state = init_state(1, capacity, cfg.dim, cfg.max_fanout,
                                self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._graph: "StepGraph | None" = None
        self._on = torch.ones((1,), dtype=torch.bool, device=self.device)
        self.n_inserted = 0

    # -- capacity management ------------------------------------------------
    def _ensure_capacity(self, n_new: int):
        """Grow when the next ``n_new`` inserts could overflow (at most 2
        fresh nodes each, plus slack), as the JAX package does."""
        st = self.state
        needed = int(st.n_alloc[0]) + 2 * n_new + 8
        profiling.count("insert.syncs")
        if needed > st.capacity:
            self.state = grow_state(
                st, align_capacity(max(needed, 2 * st.capacity)))

    def _step_graph(self) -> "StepGraph | None":
        """On the card, the descent step captured for the current state
        arrays (recaptured after they are reallocated)."""
        if self.device.type != "cuda":
            return None
        if self._graph is None or not self._graph.matches(self.state):
            self._graph = StepGraph(self.state, self.cfg)
        return self._graph

    # -- insertion ----------------------------------------------------------
    def _descend(self, x: torch.Tensor, max_steps: int) -> torch.Tensor:
        """One insert of ``x`` (D,); the leaf slot as a (1,) device tensor,
        -1 when the budget cut the descent (which then applied nothing)."""
        return descend(self.state, x.unsqueeze(0), self._on, self.cfg,
                       max_steps, self._gen, self._step_graph())

    def _exact(self, x: torch.Tensor) -> int:
        profiling.count("insert.exact")
        profiling.count("insert.syncs")
        leaf = int(self._descend(x, EXACT_STEPS)[0])
        if leaf < 0:
            raise RuntimeError(f"insert descent exceeded {EXACT_STEPS} steps")
        return leaf

    def ifit(self, x) -> int:
        """Insert one instance; returns its leaf slot.  A descent deeper
        than 48 steps is retried at once on the 256-step exact path."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=self.device).reshape(-1)
        self._ensure_capacity(1)
        profiling.count("insert.syncs")
        leaf = int(self._descend(x, 48)[0])
        if leaf < 0:
            leaf = self._exact(x)
        self.n_inserted += 1
        return leaf

    def fit(self, xs, batch_size: int = 2048, iterations: int = 1,
            randomize_first: bool = False, seed: int = 0) -> np.ndarray:
        """Insert every row in order; returns each row's leaf slot (of the
        final pass when ``iterations`` > 1: the first pass optionally
        shuffled by ``seed``, later passes land on exact-match leaves).  As
        in the JAX package, a descent deeper than 48 steps is retried on
        the 256-step exact path after the rest of its ``batch_size``
        chunk.  ``xs`` is an array or a tensor (kept on its device)."""
        xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
        if iterations > 1 or randomize_first:
            order = np.arange(len(xs))
            if randomize_first:
                np.random.default_rng(seed).shuffle(order)
            leaves_last = None
            for it in range(iterations):
                pass_xs = xs[torch.as_tensor(order, device=self.device)] \
                    if it == 0 else xs
                got = self.fit(pass_xs, batch_size=batch_size)
                if it == 0:
                    inv = np.empty_like(order)
                    inv[order] = np.arange(len(order))
                    got = got[inv]
                leaves_last = got
            return leaves_last
        leaves = np.empty((len(xs),), np.int64)
        for s in range(0, len(xs), batch_size):
            chunk = xs[s:s + batch_size]
            self._ensure_capacity(len(chunk))
            got = torch.cat([self._descend(x, 48) for x in chunk]) \
                .cpu().numpy()
            profiling.count("insert.syncs")
            for j in np.nonzero(got < 0)[0]:
                got[j] = self._exact(chunk[j])
            leaves[s:s + len(chunk)] = got
        self.n_inserted += len(xs)
        return leaves

    # -- inspection ---------------------------------------------------------
    def host_arrays(self) -> dict:
        """The tree's arrays on the host in the JAX single tree's layout:
        lane axis dropped, int32 structure, scalar root/n_alloc/free_top."""
        return {k: v[0] for k, v in state_to_numpy(self.state).items()}

    def node_var(self, idx: int) -> np.ndarray:
        """Variance of node ``idx`` under the tree's variance policy."""
        st = self.state
        return compute_var(st.m2s[0, idx].float(), st.counts[0, idx],
                           self.cfg).cpu().numpy()

    def num_nodes(self) -> int:
        """Number of live nodes (reference ``num_concepts``)."""
        return len(self.live_nodes())

    def live_nodes(self) -> list:
        """The live nodes, depth first from the root (last child first)."""
        a = self.host_arrays()
        out, stack = [], [int(a["root"])]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(int(a["children"][n, i])
                         for i in range(int(a["n_children"][n])))
        return out

    def analyze_structure(self) -> dict:
        a = self.host_arrays()
        return analyze_arrays(a["children"], a["n_children"], a["root"])

    def signature(self):
        a = self.host_arrays()
        return structure_signature(a["counts"], a["means"], a["children"],
                                   a["n_children"], a["root"])

    # -- categorize (host best-first search) --------------------------------
    def categorize(self, x, max_nodes: int = 100_000,
                   retrieve_k: "int | None" = None, greedy: bool = False,
                   leaf_has_sentences=None,
                   rng: "np.random.Generator | None" = None):
        """Best-first heap search over the host arrays (reference
        ``_cobweb_categorize``), numpy as in the JAX package.
        ``leaf_has_sentences`` (node -> bool) marks retrievable leaves
        (default: every leaf).  Returns the best node, or with
        ``retrieve_k`` the retrieved leaves in visit order."""
        a = self.host_arrays()
        counts, means, m2s = a["counts"], a["means"], a["m2s"]
        children, n_children = a["children"], a["n_children"]
        x = np.asarray(x, np.float32)
        rng = rng or np.random.default_rng(0)
        cfg = self.cfg

        def lp(n):
            var = m2s[n] / max(float(counts[n]), 1.0)
            if cfg.acuity_cutoff:
                var = np.maximum(var, cfg.prior_var)
            else:
                var = var + cfg.prior_var
            if float(counts[n]) <= 0:
                var = np.full_like(var, cfg.prior_var)
            d = x - means[n]
            return float(-0.5 * np.sum(np.log(var) + math.log(2 * math.pi)
                                       + d * d / var))

        if leaf_has_sentences is None:
            def leaf_has_sentences(n):
                return int(n_children[n]) == 0

        root = int(a["root"])
        heap = [(-lp(root), rng.random(), root)]
        best, best_score = root, -np.inf
        retrieved: list = []
        visited = 0
        while heap:
            neg, _, cur = heapq.heappop(heap)
            visited += 1
            if -neg > best_score:
                best, best_score = cur, -neg
            if greedy:      # keep only the best frontier
                heap = []
            if visited >= max_nodes:
                break
            if int(n_children[cur]) == 0 and leaf_has_sentences(cur):
                retrieved.append(cur)
            if retrieve_k is not None and len(retrieved) == retrieve_k:
                break
            for i in range(int(n_children[cur])):
                ch = int(children[cur, i])
                heapq.heappush(heap, (-lp(ch), rng.random(), ch))
        if retrieve_k is None:
            return best
        return retrieved[:retrieve_k]

    # -- serialization --------------------------------------------------------
    def dump_json(self, leaf_sentence_ids: "dict | None" = None) -> str:
        """The reference's nested {count, mean, meanSq, sentence_id,
        children} schema under the config's keys (iterative)."""
        a = self.host_arrays()
        leaf_sentence_ids = leaf_sentence_ids or {}

        def node_dict(n):
            return {"count": float(a["counts"][n]),
                    "mean": a["means"][n].tolist(),
                    "meanSq": a["m2s"][n].tolist(),
                    "sentence_id": leaf_sentence_ids.get(n, []),
                    "children": []}

        root = int(a["root"])
        root_d = node_dict(root)
        stack = [(root, root_d)]
        while stack:
            n, d = stack.pop()
            for i in range(int(a["n_children"][n])):
                ch = int(a["children"][n, i])
                cd = node_dict(ch)
                d["children"].append(cd)
                stack.append((ch, cd))
        params = self.cfg.to_json_dict()
        params["root"] = root_d
        return json.dumps(params)

    @classmethod
    def load_json(cls, json_string: str, seed: int = 0, device="cuda"):
        """Rebuild the tree from the nested schema, numbering the slots as
        the JAX package does (pop order, children pushed in reverse, so
        siblings take consecutive slots left to right).  Returns (tree,
        {leaf slot: sentence ids})."""
        data = json.loads(json_string)
        cfg = TreeConfig.from_json_dict(data)
        n_nodes, max_fanout = 0, cfg.max_fanout
        stack = [data["root"]]
        while stack:
            d = stack.pop()
            n_nodes += 1
            max_fanout = max(max_fanout, len(d["children"]))
            stack.extend(d["children"])
        if max_fanout > cfg.max_fanout:
            cfg = dataclasses.replace(cfg, max_fanout=max_fanout)
        cap, dim, F = 2 * n_nodes + 8, cfg.dim, cfg.max_fanout
        counts = np.zeros((cap,), np.float32)
        means = np.zeros((cap, dim), np.float32)
        m2s = np.zeros((cap, dim), np.float32)
        parent = np.full((cap,), NULL, np.int32)
        children = np.full((cap, F), NULL, np.int32)
        n_children = np.zeros((cap,), np.int32)
        leaf_sids: dict = {}
        idx = 0
        stack = [(data["root"], NULL)]
        while stack:
            d, par = stack.pop()
            n = idx
            idx += 1
            counts[n] = d["count"]
            means[n] = np.asarray(d["mean"], np.float32)
            m2s[n] = np.asarray(d["meanSq"], np.float32)
            parent[n] = par
            if d.get("sentence_id"):
                leaf_sids[n] = list(d["sentence_id"])
            if par >= 0:
                children[par, n_children[par]] = n
                n_children[par] += 1
            for c in reversed(d["children"]):
                stack.append((c, n))
        from rag_cobweb_tpu_torch.interop import tree_from_numpy
        tree = tree_from_numpy(dict(
            counts=counts, means=means, m2s=m2s, parent=parent,
            children=children, n_children=n_children, root=0, n_alloc=idx,
            free_stack=np.full((cap,), NULL, np.int32), free_top=0),
            cfg, seed=seed, n_inserted=int(counts[0]), device=device)
        return tree, leaf_sids

    def save_npz(self, path: str, **extra_arrays):
        """Binary checkpoint in the JAX single tree's layout (scalar root,
        n_alloc and free_top; no lane axis), so either package loads it."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path, __cfg__=np.frombuffer(
                json.dumps(self.cfg.to_json_dict()).encode(), dtype=np.uint8),
            n_inserted=np.asarray(self.n_inserted), **self.host_arrays(),
            **extra_arrays)

    @classmethod
    def load_npz(cls, path: str, seed: int = 0, device="cuda"):
        """Restore a checkpoint of either package; returns (tree, dict of
        the extra arrays)."""
        from rag_cobweb_tpu_torch.interop import load_jax_tree_npz
        return load_jax_tree_npz(path, seed=seed, device=device)
