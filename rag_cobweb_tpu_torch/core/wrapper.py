"""CobwebIndex: a port of ``rag_cobweb_tpu/core/wrapper.py``.

Single-tree mode (``n_subtrees=1``, the default: one ``CobwebTree``, the
reference's ``CobwebWrapper``) or forest mode (``n_subtrees >= 2``,
round-robin or content-routed lanes), optionally with a wrapper-owned
whitener: embeddings arrive RAW, the tree and the candidate pool run in
whitened space, and the raw float32 vector store feeds the exact
re-rank, so the final ranking is exact raw-space search whenever the
gold row is in the pool.

The reference's query API: ``predict_fast`` (its default query; text or
embeddings in, lists of sentences or ids out) and ``query_ids`` (raw
embeddings in, a device tensor of ids out) share one dispatch
(``_serve``); ``predict`` is the tree search, the packed beam of
``core/index.py`` (a forest's through ``VForest.beam_topk``); the
level-weight schedules (``set_level_weights``, ``set_weight_schedule``)
weight a single tree's path scores; ``save``/``load`` write and read the
JAX package's npz files in either mode, the whitener included
(``files.py``).

Serving: ``_serve`` -> ``_engine_topk``, which picks the engine as the
JAX package does:

* below ``blocked_threshold`` sentences: for a single tree the path
  scores of the prediction index in PyTorch (``index.query_topk``), then
  the re-rank; for a forest the small-forest engine
  (``_small_forest_topk``: each lane's path-ranked rows merged by leaf
  log-prob over the stacked index, ``parallel/vforest._vforest_query``,
  then the exact re-rank, kernel 5);
* ``use_pallas`` and at least ``pallas_threshold`` sentences: the blocked
  sweep kernel (``_pallas_topk`` -> ``ops/blocked_topk.blocked_topk``);
* ``use_fused`` (the default): ``_product_chunked`` ->
  ``index.fused_query_rerank`` (fused sweep kernel, exact top-c pool,
  exact re-rank kernel);
* otherwise the blocked sweep in PyTorch (``index.blocked_query_topk``).

A re-rank pool goes through ``_rerank_step``: the exact stored-row
re-rank, or the leaf log-prob re-rank when no vector store is kept.  A
single tree reaches the fused sweep through its prediction index
(``index.build_fused_index``), a forest straight from its state.  With
the store kept, the fused engine unites its pool with a proximity
backstop pool (``index.backstop_topk``) over the whitened rows (whitener
mode, from ``backstop_threshold`` sentences on, or any explicit
``backstop_pool > 0``).

The vector stores live on the device and grow in place: the raw rows
(the re-rank store, float32, or bfloat16 with ``emb_store_dtype``, its
exact rows then kept on the host) and, in whitener mode, the whitened
rows in bf16 in kernel 1's GT layout with their half-norms (the backstop
store).

Memory tools of a large index, as in the JAX package: ``compress_stats``
(bf16 node statistics at rest), ``offload_state`` (a forest's state to
host memory once its serving index exists), ``emb_store_dtype`` (the bf16
re-rank store, kernel 5's bf16-row entry), and ``build_device="cpu"`` with
``promote_build_device`` (a forest built on the host, then moved with
every store and index to the card).

Adds on top of a serving index keep it (bounded staleness, as in the
JAX package): the new rows wait in a tier-0 pending pool (scored by
kernel 5, ``index.pending_leaf_lp``), which past ``stale_pending_limit``
rows moves into a tier-1 delta segment on the device
(``index.delta_exact_topk``); ``query_ids`` merges both with the stale
engine's re-ranked pool by the shared fresh-leaf key.  The indexes are
rebuilt once the unindexed rows pass max(``delta_rebuild_min``,
``delta_rebuild_frac`` of the indexed ones), or when an exact-index
consumer runs (``rerank=0``, ``rank_scores``, and a forest below
``blocked_threshold``, whose small-forest engine serves no stale tier).

Spans (``utils/profiling``): ``serve.query`` around ``query_ids`` and
``predict_fast``, ``serve.add`` around ``add_sentences`` (with the
insert counters' deltas), ``serve.upload``, ``serve.whiten``,
``tiers.merge``, and ``index.rebuild`` around every serving-index build,
which is also logged in ``profiling.events()``.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
import torch

from rag_cobweb_tpu_torch import files
from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.core import tree as tree_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree, align_capacity
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.ops import blocked_topk
from rag_cobweb_tpu_torch.parallel.vforest import VForest, _vforest_query
from rag_cobweb_tpu_torch.utils import profiling
from rag_cobweb_tpu_torch.utils.viz import visualize_grandparent_subtrees


def _identity_encode(x):
    return np.asarray(x, np.float32)


class CobwebIndex:
    """Hierarchical vector database over a Cobweb tree or a K-lane
    forest."""

    # engine choice, under the JAX package's names and defaults
    use_fused = True
    fused_dtype = "bfloat16"      # serving GT dtype (pool selection only)
    blocked_dtype = "bfloat16"    # serving blocked-index dtype
    use_pallas = False            # opt-in: the blocked sweep kernel ...
    pallas_threshold = 300_000    # ... from this many sentences on
    pallas_block_k = 16           # its candidates per block
    rerank_threshold = 8192
    rerank_candidates = 512
    # byte budget for one query chunk's sweep working set
    fused_score_budget = 2 << 30
    backstop_pool = "auto"
    backstop_threshold = 131072

    def __init__(self, corpus=None, corpus_embeddings=None,
                 encode_func: Callable = _identity_encode,
                 config: Optional[TreeConfig] = None,
                 capacity: Optional[int] = None, seed: int = 0,
                 n_subtrees: int = 1, routing: str = "round_robin",
                 whitener=None, device="cuda", build_device=None):
        """``device``: where the index serves.  ``build_device``: where a
        forest's state lives and its inserts run until
        ``promote_build_device()`` (``"cpu"``: a build on the host; the
        stores and indexes live there too until then); a single tree
        ignores it, as in the JAX package."""
        device = resolve_device(device)
        if corpus_embeddings is not None:
            corpus_embeddings = np.asarray(corpus_embeddings, np.float32)
            dim = corpus_embeddings.shape[1]
            if whitener is not None:
                dim = whitener.dim_out
        elif corpus:
            dim = np.asarray(encode_func([corpus[0]])).shape[-1]
            if whitener is not None:
                dim = whitener.dim_out
        elif config is not None:
            dim = config.dim
        else:
            raise ValueError(
                "need corpus, corpus_embeddings, or config to fix the dim")
        cfg = config or TreeConfig(dim=dim)
        n0 = len(corpus_embeddings) if corpus_embeddings is not None else (
            len(corpus) if corpus else 0)
        cap = capacity or max(1024, 4 * n0 + 16)
        tree = forest = None
        if n_subtrees > 1:
            forest = VForest(cfg, n_subtrees=int(n_subtrees),
                             capacity_per_tree=max(1024, cap // n_subtrees),
                             seed=seed, routing=routing, device=device,
                             build_device=build_device)
        else:
            tree = CobwebTree(cfg, capacity=cap, seed=seed, device=device)
        self._setup(tree, forest, [], [], encode_func, whitener)

        if corpus_embeddings is not None:
            if corpus is None:
                corpus = [None] * len(corpus_embeddings)
            self.add_sentences(corpus, corpus_embeddings)
        elif corpus:
            self.add_sentences(corpus)

    def _setup(self, tree, forest, sentences: list, leaf_of_sentence: list,
               encode_func: Callable, whitener):
        """Every attribute of a new or loaded index (``__init__``,
        ``load_json`` and ``load`` share it): the single ``tree`` or the
        ``forest`` (the other None) and its device and config, the
        sentences, empty device stores and serving caches, the engine and
        staleness settings and no level-weight schedule.  The device is
        the owner's: a forest's build device until it is promoted."""
        self.tree, self.forest = tree, forest
        owner = forest if forest is not None else tree
        self.device = owner.device
        # float32 products run in full float32 on the card (TF32 off): the
        # counterpart of the JAX package's Precision.HIGHEST
        full_f32_matmul()
        self.cfg = owner.cfg      # a content-routed forest sets absorb_depth
        self.n_subtrees = forest.K if forest is not None else 1
        self.encode_func = encode_func
        self.whitener = whitener
        self.sentences = list(sentences)
        self.leaf_of_sentence = list(leaf_of_sentence)
        self.store_embeddings = True
        # the re-rank store's dtype on the device ("float32" or "bfloat16":
        # half the bytes, the distances still f32); a change takes effect
        # at the next _emb_device()
        self.emb_store_dtype = "float32"
        self._store_n = 0         # rows in the device stores
        self._emb_dev = None      # (cap, D) raw rows, zero past _store_n
        self._emb_host = None     # their exact f32 rows on the host, kept
        #                           while the device store is not f32
        self._wemb_dev = None     # whitener: (Dw, capw) bf16 whitened rows
        self._half_n2 = None      # backstop store's 0.5 ||row||^2, f32
        self._init_pending()
        self.blocked_threshold = 8192
        # level weights of the single tree's path scores (a forest ignores
        # them, as in the JAX package); max_depth is set by each build of
        # the prediction index
        self._level_weights: Optional[list] = None
        self._weight_schedule = None
        self._schedule_params: dict = {}
        self.max_depth = 0

    def _init_pending(self):
        """The bounded-staleness settings of the JAX package, and empty
        pending/delta tiers."""
        self.stale_reads = True
        self.stale_pending_limit = 4096
        self.delta_rebuild_min = 65536
        self.delta_rebuild_frac = 0.10
        self._invalidate_index()

    def __len__(self):
        return len(self.sentences)

    # ---------------------------------------------------------------- #
    # ingestion                                                        #
    # ---------------------------------------------------------------- #
    def add_sentences(self, new_sentences, new_vectors=None,
                      batch_size: int = 2048):
        """Insert sentences/embeddings; returns each row's leaf slot (one
        tree) or its global id (forest).  A serving index is kept while
        the unindexed rows stay under the rebuild point: the new rows join
        the pending tier (past ``stale_pending_limit`` the delta
        segment); otherwise the indexes are dropped and the next query
        rebuilds them."""
        with profiling.span("serve.add", counters=profiling.INSERT_COUNTERS,
                            rows=len(new_sentences)):
            return self._add(new_sentences, new_vectors, batch_size)

    def _add(self, new_sentences, new_vectors, batch_size: int):
        if new_vectors is None:
            new_vectors = self.encode_func(new_sentences)
        store_vecs = np.asarray(new_vectors, np.float32)
        if store_vecs.ndim == 1:
            store_vecs = store_vecs[None, :]
        with profiling.span("serve.upload", device=self.device):
            raw = torch.as_tensor(store_vecs, device=self.device)
            profiling.count("insert.syncs")     # a pageable upload waits
        tree_vecs = self._whiten(raw)
        if tree_vecs.shape[1] != self.cfg.dim:
            raise ValueError(f"vector dim {tree_vecs.shape[1]} != tree dim "
                             f"{self.cfg.dim}")
        if len(new_sentences) != len(store_vecs):
            raise ValueError(f"{len(new_sentences)} sentences != "
                             f"{len(store_vecs)} vectors")
        if self.forest is not None:
            out = self.forest.add(tree_vecs)
        else:
            out = self.tree.fit(tree_vecs, batch_size=batch_size)
            self.leaf_of_sentence.extend(int(v) for v in out)
        n0 = len(self.sentences)
        self.sentences.extend(new_sentences)
        if self.store_embeddings and self._store_n == n0:
            # a store that misses rows (a loaded tree, or one kept with the
            # store off) stays unused
            self._store_rows(raw, tree_vecs)
        # bounded staleness: keep serving the index that exists and score
        # the new rows by their fresh-leaf closed form until the rebuild
        # point
        n_new = len(self.sentences) - n0
        store = self._emb_device() is not None
        # tier 0 keeps its rows apart (exact f32, on the device) when the
        # store misses rows or holds them rounded
        apart = (not store or self._emb_dev.dtype != torch.float32
                 or self._pending_vecs is not None)
        if self.forest is not None:
            # the stats-free fused index alone can serve stale when the
            # exact re-rank store exists
            has_stale = (self._flat_cache is not None
                         or (self._fused is not None and store))
        else:
            has_stale = self._index is not None
        if self.whitener is not None and not store:
            # pending keys (store space) would not compare with the
            # tree-space leaf-lp re-rank
            has_stale = False
        n_indexed = n0 - self._unindexed_count()
        rebuild_at = max(self.delta_rebuild_min,
                         int(self.delta_rebuild_frac * max(n_indexed, 1)))
        if (self.stale_reads and has_stale
                and self._unindexed_count() + n_new <= rebuild_at):
            if apart and self._pending_vecs is None and self._pending_sids:
                # the store stopped covering the sentences: tier 0 keeps
                # apart the rows it held
                self._pending_vecs = self._exact_rows(self._pending_ids())
            self._pending_sids.extend(range(n0, n0 + n_new))
            self._pending_dev = None
            if apart:
                self._pending_vecs = (
                    raw.clone() if self._pending_vecs is None
                    else torch.cat([self._pending_vecs, raw]))
            if len(self._pending_sids) > self.stale_pending_limit:
                # the pending ids' upload (dropped above) waits
                profiling.count("insert.syncs")
                self._consolidate_pending()
        else:
            self._invalidate_index()
        return out

    def _whiten(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw rows -> tree space (the whitener's, or as they are)."""
        if self.whitener is None:
            return raw
        with profiling.span("serve.whiten", device=raw.device,
                            rows=raw.shape[0]):
            return self.whitener.transform_torch(raw)

    def _rebuild(self, engine: str):
        """The span and event of a serving-index build."""
        return profiling.span("index.rebuild", device=self.device, log=True,
                              engine=engine, rows=len(self.sentences))

    def _invalidate_index(self):
        """Drop every serving index and the pending/delta bookkeeping (a
        rebuild covers those rows)."""
        self._index = None
        self._fused = None
        self._fused_f32 = None
        self._blocked = None
        self._blocked_f32 = None
        self._flat_cache = None   # forest: the flat snapshot serving stale
        self._beam_cache = None   # single tree: the BeamIndex ...
        self._beam_src = None     # ... and the prediction index it is of
        self._pending_sids: list = []
        self._pending_dev = None  # the pending sids on the device
        self._pending_vecs = None  # their raw f32 rows, when the store
        #                            misses them or holds them rounded
        self._delta_vecs = None   # (cap, D) f32 delta segment
        self._delta_sids = None   # (delta_n,) int64 sentence ids
        self._delta_n = 0

    def _unindexed_count(self) -> int:
        return len(self._pending_sids) + self._delta_n

    def _indexed_count(self) -> int:
        """Sentences the serving index covers (the pending and delta rows
        are merged apart)."""
        return len(self.sentences) - self._unindexed_count()

    def _flush_pending(self):
        """Exact-index semantics: drop a stale index, if any."""
        if self._unindexed_count():
            self._invalidate_index()

    def _pending_ids(self) -> torch.Tensor:
        """The tier-0 pending sentence ids on the device."""
        if self._pending_dev is None:
            self._pending_dev = torch.as_tensor(
                self._pending_sids, dtype=torch.int64, device=self.device)
        return self._pending_dev

    def _pending_rows(self):
        """(row store, row ids, sentence ids on the device) of the tier-0
        pending rows: the raw store at their sentence ids, or the rows kept
        apart when no store is kept or it holds them rounded."""
        self._pending_ids()
        if self._pending_vecs is not None:
            return self._pending_vecs, torch.arange(
                len(self._pending_sids), device=self.device), \
                self._pending_dev
        return self._emb_device(), self._pending_dev, self._pending_dev

    def _consolidate_pending(self):
        """Move the tier-0 rows into the device delta segment, its
        capacity grown by powers of two as in the JAX package (from 8192
        rows, a slab of at least 1024 rows ahead)."""
        n_new = len(self._pending_sids)
        if not n_new:
            return
        vecs, rows, sids = self._pending_rows()
        new_rows = vecs[rows]
        mb = max(1024, 1 << (n_new - 1).bit_length())
        cap = 0 if self._delta_vecs is None else self._delta_vecs.shape[0]
        if self._delta_n + mb > cap:
            buf = torch.zeros(
                (max(8192, 1 << (self._delta_n + mb - 1).bit_length()),
                 new_rows.shape[1]), dtype=torch.float32, device=self.device)
            if self._delta_vecs is not None:
                index_mod._append_rows(buf, self._delta_vecs, 0)
            self._delta_vecs = buf
        index_mod._append_rows(self._delta_vecs, new_rows, self._delta_n)
        self._delta_sids = (sids if self._delta_sids is None
                            else torch.cat([self._delta_sids, sids]))
        self._delta_n += n_new
        self._pending_sids = []
        self._pending_dev = None
        self._pending_vecs = None

    def _merge_pending(self, qs, top_s, top_ids, k: int) -> torch.Tensor:
        """The stale engine's (B, k_old) keys and ids merged with the
        pending pool (tier 0) and the delta segment (tier 1), all keyed by
        the fresh-leaf closed form on the raw rows ``qs`` -> (B, k) ids.  A
        stable descending sort keeps the JAX order among equal keys:
        indexed, pending, delta."""
        with profiling.span("tiers.merge", device=qs.device,
                            pending=len(self._pending_sids),
                            delta=self._delta_n):
            return self._merge_tiers(qs, top_s, top_ids, k)

    def _merge_tiers(self, qs, top_s, top_ids, k: int) -> torch.Tensor:
        pv = float(self.cfg.prior_var)
        all_s, all_ids = [top_s], [top_ids.long()]
        if self._pending_sids:
            vecs, rows, sids = self._pending_rows()
            lp = index_mod.pending_leaf_lp(qs, vecs, rows, pv)
            ps, ppos = torch.topk(lp, min(k, lp.shape[1]), dim=1)
            all_s.append(ps)
            all_ids.append(sids[ppos])
        if self._delta_n:
            ds, dpos = index_mod.delta_exact_topk(
                qs, self._delta_vecs, self._delta_n, pv,
                min(k, self._delta_n))
            all_s.append(ds)
            all_ids.append(self._delta_sids[dpos.clamp(max=self._delta_n
                                                       - 1)])
        order = torch.sort(torch.cat(all_s, dim=1), dim=1, descending=True,
                           stable=True).indices[:, :k]
        return torch.cat(all_ids, dim=1).gather(1, order)

    def _store_rows(self, raw: torch.Tensor, tree_vecs: torch.Tensor):
        """Append rows to the device stores in place, each grown 1.25x
        geometrically when full (as the JAX package's bucketed stores):
        the raw rows in the store's dtype (and their exact f32 copy on the
        host while that is not f32), and in whitener mode the whitened
        rows in bf16, (Dw, capw) with capw a multiple of 2048 (kernel 1's
        GT layout), and beside the backstop's store its half-norms, in f32
        from the stored values, 0 on padding."""
        n0 = self._store_n
        n = n0 + raw.shape[0]
        cap = 0 if self._emb_dev is None else self._emb_dev.shape[0]
        if n > cap:
            shape = (align_capacity(max(n, int(cap * 1.25), 4096)),
                     raw.shape[1])
            emb = torch.zeros(shape, dtype=torch.float32 if self._emb_dev
                              is None else self._emb_dev.dtype,
                              device=self.device)
            if self._emb_dev is not None:
                emb[:n0] = self._emb_dev[:n0]
            self._emb_dev = emb
            if self._emb_host is not None:
                host = torch.zeros(shape, dtype=torch.float32)
                host[:n0] = self._emb_host[:n0]
                self._emb_host = host
        self._emb_dev[n0:n] = raw
        if self._emb_host is not None:
            self._emb_host[n0:n] = raw.cpu()
        if self.whitener is None:
            rows, cap = self._emb_dev[n0:n], self._emb_dev.shape[0]
        else:
            rows = tree_vecs.to(torch.bfloat16)
            capw = 0 if self._wemb_dev is None else self._wemb_dev.shape[1]
            if n > capw:
                slab = index_mod._FUSED_ROW_BUCKET
                w = torch.zeros(
                    (rows.shape[1],
                     -(-max(n, int(capw * 1.25), 4096) // slab) * slab),
                    dtype=torch.bfloat16, device=self.device)
                if self._wemb_dev is not None:
                    w[:, :n0] = self._wemb_dev[:, :n0]
                self._wemb_dev = w
            self._wemb_dev[:, n0:n] = rows.T
            cap = self._wemb_dev.shape[1]
        if self._half_n2 is None or self._half_n2.shape[0] != cap:
            half = torch.zeros((cap,), dtype=torch.float32,
                               device=self.device)
            if self._half_n2 is not None:
                half[:n0] = self._half_n2[:n0]
            self._half_n2 = half
        self._half_n2[n0:n] = 0.5 * torch.sum(torch.square(rows.float()),
                                              dim=1)
        self._store_n = n

    def _emb_device(self) -> Optional[torch.Tensor]:
        """(cap, D) raw store on the device in ``emb_store_dtype`` (rebuilt
        in it here when that changed), zero rows past the live count; None
        without a store (or one that misses rows)."""
        if (not self.store_embeddings or self._emb_dev is None
                or self._store_n != len(self.sentences)):
            return None
        if self.emb_store_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"emb_store_dtype must be float32 or bfloat16, "
                             f"not {self.emb_store_dtype!r}")
        want = getattr(torch, self.emb_store_dtype)
        if self._emb_dev.dtype != want:
            self._set_store_dtype(want)
        return self._emb_dev

    def _set_store_dtype(self, dtype):
        """Rebuild the raw store in ``dtype``: to bf16, its exact rows go to
        the host first (``save`` writes them, and tier 0 keeps its rows
        apart from a rounded store); back to f32, they come back from
        there.  Without a whitener the backstop keys on this store, so
        its half-norms are taken anew from the stored values."""
        if self._pending_sids and self._pending_vecs is None:
            self._pending_vecs = self._exact_rows(self._pending_ids())
        if dtype == torch.bfloat16:
            self._emb_host = self._emb_dev.cpu()
            self._emb_dev = self._emb_dev.to(dtype)
        else:
            self._emb_dev = self._emb_host.to(self.device)
            self._emb_host = None
        if self.whitener is None:
            step = 1 << 16
            for r in range(0, self._emb_dev.shape[0], step):
                self._half_n2[r:r + step] = 0.5 * torch.sum(
                    torch.square(self._emb_dev[r:r + step].float()), dim=1)

    def _exact_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """The raw f32 rows of sentence ids ``ids`` on the device: from the
        host copy while the device store is rounded."""
        if self._emb_host is not None:
            return self._emb_host[ids.cpu()].to(self.device)
        return self._emb_dev[ids]

    def _wemb_device(self):
        """The backstop's operands (store, half-norms), or None.  Whitener
        mode: the (Dw, capw) bf16 whitened store; without a whitener the
        tree space is the store space and the backstop keys on the raw
        re-rank store itself (``_wemb_device()[0] is _emb_device()``)."""
        emb = self._emb_device()
        if emb is None:
            return None
        return (emb if self.whitener is None else self._wemb_dev,
                self._half_n2)

    # ---------------------------------------------------------------- #
    # serving                                                          #
    # ---------------------------------------------------------------- #
    def _fused_index(self, exact: bool = False) -> index_mod.FusedIndex:
        """The serving FusedIndex (bf16 by default; f32 for the rerank=0
        path-score order), built from the forest state on first use."""
        attr = ("_fused_f32" if exact and self.fused_dtype != "float32"
                else "_fused")
        dtype = (torch.float32 if attr == "_fused_f32"
                 else getattr(torch, self.fused_dtype))
        if getattr(self, attr) is None:
            if self.forest is not None and self._flat_cache is None:
                # stats-free build from the forest state: only a fresh
                # snapshot (a stale one is pinned by the flat cache)
                self._flush_pending()
                fidx = self.forest.fused_index(dtype=dtype)
            else:
                idx = self._flat_pred_index()
                with self._rebuild(attr[1:]):
                    fidx = index_mod.build_fused_index(idx, dtype=dtype)
            setattr(self, attr, fidx)
        return getattr(self, attr)

    def _auto_rerank(self) -> int:
        """Default pool: always with absorb_depth or a whitener (raw-space
        ranking needs the exact re-rank), else from rerank_threshold on."""
        if self.cfg.absorb_depth or (self.whitener is not None
                                     and self.store_embeddings):
            return self.rerank_candidates
        return (self.rerank_candidates
                if len(self.sentences) >= self.rerank_threshold else 0)

    def _backstop_k(self, pool: int, n_indexed: int) -> int:
        """The backstop pool's size for this query (0: off): ``"auto"``
        turns it on from ``backstop_threshold`` sentences in whitener mode
        with the store kept, at the re-rank pool's size; an int is the
        size; never more than the indexed rows."""
        bs = self.backstop_pool
        if bs == "auto":
            if not (self.whitener is not None and self.store_embeddings
                    and len(self.sentences) >= self.backstop_threshold):
                return 0
            bs = pool
        bs = int(bs)
        if bs <= 0 or self._wemb_device() is None:
            return 0
        return min(bs, n_indexed)

    # ---------------------------------------------------------------- #
    # memory tools (reference wrapper: compress_stats, offload_state,  #
    # promote_build_device)                                            #
    # ---------------------------------------------------------------- #
    def compress_stats(self, dtype=None):
        """Stats compression (bf16 by default; ``VForest.compress_stats``)
        of the forest or the single tree, then the serving indexes
        dropped, so the next query builds them from the compressed
        stats."""
        if self.forest is not None:
            self.forest.compress_stats(dtype)
        else:
            st = tree_mod.compress_state(self.tree.state, dtype)
            if st is not self.tree.state:
                self.tree.state = st
                self.tree._graph = None
        self._invalidate_index()

    def offload_state(self):
        """Serve-only mode: a forest's state to host memory
        (``VForest.offload_state``) once its serving index is built; the
        next add or index build moves it back.  A single tree keeps its
        state, as in the JAX package."""
        if self.forest is not None:
            self.forest.offload_state()

    def promote_build_device(self):
        """Move a forest built on ``build_device`` to its serving device
        (``VForest.to_device``), and with it this index's own device
        state: the stores, the half-norms, the pending and delta tiers and
        every cached index, so serving goes on from the card without a
        rebuild.  No-op for a single tree or a forest already there."""
        f = self.forest
        if f is None or (f.device == f.serve_device
                         and self.device == f.serve_device):
            return
        f.to_device()
        dev = self.device = f.device

        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(dev)
            if isinstance(x, tuple) and hasattr(x, "_fields"):
                return type(x)(*map(move, x))
            return x

        for name in ("_emb_dev", "_wemb_dev", "_half_n2", "_pending_vecs",
                     "_pending_dev", "_delta_vecs", "_delta_sids",
                     "_index", "_fused", "_fused_f32", "_blocked",
                     "_blocked_f32", "_flat_cache", "_beam_cache"):
            setattr(self, name, move(getattr(self, name)))
        self._beam_src = None

    def _flat_pred_index(self) -> index_mod.PredictionIndex:
        """The flat PredictionIndex over global sentence ids: the whole
        forest flattened (``VForest.flat_index``; with rows pending, the
        snapshot kept in ``_flat_cache``), or a single tree's prediction
        index."""
        if self.forest is not None:
            if self._unindexed_count():
                if self._flat_cache is not None:
                    return self._flat_cache
                # no snapshot to serve (fused-only staleness): a rebuild
                # covers the pending rows, so their bookkeeping goes
                self._flush_pending()
            self._flat_cache = self.forest.flat_index()
            return self._flat_cache
        return self.build_prediction_index()

    def build_prediction_index(self):
        """The single tree's PredictionIndex (``index.build_index``), or a
        forest's stacked per-lane index (``VForest.build_index``), cached
        until the next add."""
        if self.forest is not None:
            return self.forest.build_index()
        if self._index is None:
            with self._rebuild("prediction"):
                self._index = index_mod.build_index(
                    self.tree, np.asarray(self.leaf_of_sentence, np.int64),
                    level_weights=(self._level_weights
                                   or list(index_mod.DEFAULT_LEVEL_WEIGHTS)))
            depths = (self._index.paths_h >= 0).sum(1)
            self.max_depth = int(depths.max()) if len(depths) else 0
        return self._index

    def force_rebuild_index(self):
        self._invalidate_index()
        self.build_prediction_index()

    def get_prediction_index_info(self) -> dict:
        """Diagnostics of the current prediction index (reference
        ``get_prediction_index_info``)."""
        valid = self._index is not None
        info = {
            "index_valid": valid,
            "total_nodes": self._index.num_nodes if valid else 0,
            "leaf_paths_cached": self._index.num_sentences if valid else 0,
            "means_cached": valid,
            "vars_cached": valid,
        }
        if valid:
            info["means_shape"] = (self._index.num_nodes, self.cfg.dim)
            info["vars_shape"] = info["means_shape"]
        return info

    def _blocked_index(self, exact: bool = False) -> index_mod.BlockedIndex:
        """The serving BlockedIndex in ``blocked_dtype``; ``exact``: an f32
        one, cached separately, for the rerank=0 path-score order."""
        if exact and self.blocked_dtype != "float32":
            if self._blocked_f32 is None:
                idx = self._flat_pred_index()
                with self._rebuild("blocked_f32"):
                    self._blocked_f32 = index_mod.build_blocked_index(idx)
            return self._blocked_f32
        if self._blocked is None:
            idx = self._flat_pred_index()
            with self._rebuild("blocked"):
                self._blocked = index_mod.build_blocked_index(
                    idx, dtype=getattr(torch, self.blocked_dtype))
        return self._blocked

    def _chunk(self, B: int, row_bytes: int) -> int:
        bmax = max(32, int(self.fused_score_budget) // max(row_bytes, 1))
        return B if bmax >= B else 1 << (bmax.bit_length() - 1)

    def _product_chunked(self, q, kk: int, pool: int, n_indexed: int,
                         q_store=None):
        """Sweep + exact pool [+ backstop pool, united] + exact re-rank,
        the query batch chunked so one chunk's working set stays under
        ``fused_score_budget``.  On the card: kernel 1's (NS, Bc, kappa)
        pools, of the fused index and of the whitened store (the f32
        store's backstop: its (Bc, Sw) scores); kernel 5 gathers row by
        row.  On the host: the plain versions' (Bc, Sp) and (Bc, Sw)
        scores, or the (Bc, pool + bs, D) re-rank gather if larger."""
        fidx = self._fused_index()
        emb = self._emb_device()
        qs = q if q_store is None else q_store
        bs = self._backstop_k(pool, n_indexed)
        wemb = half = None
        slab = index_mod._FUSED_ROW_BUCKET
        card = q.device.type != "cpu"
        row = (fidx.num_slots // slab * min(pool, slab) * 8 if card
               else fidx.num_slots * 12)
        gt = self.whitener is not None     # the backstop store's layout
        if bs:
            wemb, half = self._wemb_device()
            Sw = wemb.shape[1] if gt else wemb.shape[0]
            row += (Sw // slab * min(bs, slab) * 8 if card and gt
                    else Sw * 12)
        if not card:
            row = max(row, (pool + bs) * emb.shape[1] * 4)
        bmax = self._chunk(q.shape[0], row)
        pv = float(self.cfg.prior_var)
        nv = min(n_indexed, len(self.sentences))
        outs = [index_mod.fused_query_rerank(
            fidx, emb, q[s:s + bmax], qs[s:s + bmax], kk, pool, wemb=wemb,
            half_norm2=half, n_valid=nv, bs=bs, prior_var=pv, gt_layout=gt)
            for s in range(0, q.shape[0], bmax)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def _fused_chunked(self, fidx, q, k: int):
        """Exact top-k of the fused sweep (kernel 1), the batch chunked as
        the plain version's (Bc, Sp) score matrix needs."""
        bmax = self._chunk(q.shape[0], fidx.num_slots * 12)
        outs = [index_mod.fused_query_topk(fidx, q[s:s + bmax], k)
                for s in range(0, q.shape[0], bmax)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def _engine_topk(self, q, kk: int, rerank: int, tie_noise: bool = False,
                     q_store=None):
        """Dispatch to the engines: below ``blocked_threshold`` the path
        scores of the prediction index (a single tree; a forest never gets
        here), else the blocked sweep kernel (opt-in, above
        ``pallas_threshold``), else the fused engine, else the blocked
        sweep in PyTorch; each with the optional re-rank.  ``rerank=0``:
        the raw path-score order from an f32 index.  ``tie_noise``: the
        flat index's path scores plus 1e-6 Gaussian noise seeded from the
        sentence count, at any size and with no re-rank, as in the JAX
        package.  Pools are cut to the rows the serving index covers."""
        n_indexed = self._indexed_count()
        if len(self.sentences) < self.blocked_threshold or tie_noise:
            idx = self._flat_pred_index()
            if rerank and not tie_noise:
                c = min(max(rerank, kk), idx.num_sentences)
                cs, cand = index_mod.query_topk(idx, q, c)
                return self._rerank_step(idx, q, cand, cs, kk,
                                         q_store=q_store)
            gen = None
            if tie_noise:
                gen = torch.Generator(device=q.device)
                gen.manual_seed(len(self.sentences))
            return index_mod.query_topk(idx, q, kk, gen)
        if (self.use_pallas
                and len(self.sentences) >= self.pallas_threshold):
            return self._pallas_topk(self._blocked_index(), q, kk, rerank,
                                     q_store=q_store)
        if self.use_fused:
            if rerank:
                pool = min(max(rerank, kk), n_indexed)
                if self._emb_device() is not None:
                    return self._product_chunked(q, kk, pool, n_indexed,
                                                 q_store=q_store)
                cs, cand = self._fused_chunked(self._fused_index(), q, pool)
                return self._rerank_step(None, q, cand, cs, kk,
                                         q_store=q_store)
            return self._fused_chunked(self._fused_index(exact=True), q, kk)
        if rerank:
            cs, cand = index_mod.blocked_query_topk(
                self._blocked_index(), q, min(max(rerank, kk), n_indexed))
            return self._rerank_step(None, q, cand, cs, kk, q_store=q_store)
        return index_mod.blocked_query_topk(self._blocked_index(exact=True),
                                            q, kk)

    def _rerank_step(self, idx, q, cand, cand_scores, kk: int,
                     q_store=None):
        """Final candidate re-rank: EXACT (stored rows, the fresh-leaf
        closed form) when the vector store is kept, else leaf log-prob on
        the flat index (``idx``, built here when None).  The JAX package
        chunks the exact branch to bound its (B, C, D) gather; the card's
        re-rank kernel gathers row by row, so the batch goes in whole."""
        emb = self._emb_device()
        if emb is not None:
            qs = q if q_store is None else q_store
            return index_mod.exact_rerank(emb, qs, cand, cand_scores, kk,
                                          float(self.cfg.prior_var))
        if idx is None:
            idx = self._flat_pred_index()
        return index_mod._leaf_lp_rerank(idx, q, cand, cand_scores, kk)

    def _small_forest_topk(self, q, kk: int, rerank: Optional[int],
                           q_store=None):
        """A forest below ``blocked_threshold``: each lane's rows ranked by
        path score, the lanes merged by leaf log-prob
        (``parallel/vforest._vforest_query`` over the stacked index), then
        the exact stored-row re-rank (kernel 5).  Rows of one leaf share
        its log-prob, and content routing packs whole near-duplicate
        groups into one leaf, so the pool must cover the largest such tie
        group: ``rerank=None`` takes min(max(4 k, ``rerank_candidates``),
        n) rows when the store is kept, else 0; 0 serves the raw leaf-lp
        order."""
        idx = self.forest.build_index()
        store = self._emb_device() is not None
        n = len(self.sentences)
        pool = rerank
        if pool is None:
            pool = min(max(4 * kk, self.rerank_candidates), n) if store \
                else 0
        if pool and store:
            cs, cand = _vforest_query(idx, q, min(max(pool, kk), n))
            return self._rerank_step(None, q, cand, cs, kk, q_store=q_store)
        return _vforest_query(idx, q, kk)

    def _pallas_topk(self, bidx, q, kk: int, rerank: int, q_store=None):
        """Serve through the blocked sweep kernel (the counterpart of the
        JAX package's Pallas engine).  Its merged pool holds NB *
        ``pallas_block_k`` candidates; when that is below the re-rank pool
        (few blocks), each block gives its exact top-pool instead, so the
        merge is the exact top-pool of the blocked scores; there the JAX
        package gave way to another engine.  It also gave way when no query
        chunk fitted VMEM; the kernel streams M, and a wide D, through
        shared memory by query tile, so every batch and width fits and
        that branch has no counterpart."""
        bk = self.pallas_block_k
        if rerank and bidx.ivt_b.shape[0] * bk < max(kk, rerank):
            bk = 0          # blocked_topk: per-block candidates = the pool
        if rerank:
            cs, cand = blocked_topk.blocked_topk(bidx, q, max(kk, rerank),
                                                 block_k=bk)
            cs = torch.where(cs > blocked_topk.NEG / 2, cs,
                             torch.full_like(cs, float("-inf")))
            return self._rerank_step(None, q, cand, cs, kk, q_store=q_store)
        return blocked_topk.blocked_topk(bidx, q, kk)

    def _as_query_batch(self, input, is_embedding: bool,
                        with_store: bool = False):
        """A query input (embeddings, an array or a tensor, or text for
        ``encode_func``) as a (B, D) tree-space device batch, and whether
        it was one query; ``with_store``: the raw (store-space) batch
        beside it, from the same one upload."""
        if not is_embedding:
            single = isinstance(input, str)
            input = np.asarray(self.encode_func(
                [input] if single else list(input)), np.float32)
        with profiling.span("serve.upload", device=self.device):
            qs = torch.as_tensor(input, dtype=torch.float32,
                                 device=self.device)
        if is_embedding:
            single = qs.dim() == 1
        if qs.dim() == 1:
            qs = qs.unsqueeze(0)
        q = self._whiten(qs)
        return (q, qs, single) if with_store else (q, single)

    def _as_results(self, ids: torch.Tensor, return_ids: bool,
                    single: bool):
        """(B, k) ids -> a list a query of ids or sentences (None for an
        embedding-only row), -1 padding dropped; one query: its list."""
        out = [[i if return_ids else self.sentences[i] for i in row
                if i >= 0] for row in ids.cpu().tolist()]
        return out[0] if single else out

    def rank_scores(self, input, is_embedding: bool = False):
        """Per-sentence path scores (reference ``cobweb_rank_scores``): (B,
        D) -> (B, S), one query -> (S,); a forest's each from its lane
        (``VForest.rank_scores``).  Differentiable in the queries."""
        self._flush_pending()   # (B, S) scores must cover every sentence
        q, single = self._as_query_batch(input, is_embedding)
        if self.forest is not None:
            scores = self.forest.rank_scores(q)
        else:
            scores = index_mod.rank_scores(self.build_prediction_index(), q)
        return scores[0] if single else scores

    cobweb_rank_scores = rank_scores

    def _serve(self, q, qs, k: int, rerank: Optional[int],
               tie_noise: bool = False) -> torch.Tensor:
        """The one dispatch of ``query_ids`` and ``predict_fast``: whitened
        queries ``q`` and raw ``qs`` -> (B, k) sentence ids on the device.
        A forest below ``blocked_threshold`` goes to the small-forest engine
        (pending rows flushed first).  Otherwise ``_engine_topk``, with the
        rows pending merged from their tiers; ``rerank=0`` (the path-score
        order) and ``tie_noise`` need the exact index and flush first."""
        kk = min(k, len(self.sentences))
        if (self.forest is not None
                and len(self.sentences) < self.blocked_threshold):
            self._flush_pending()   # no stale tier serves here
            return self._small_forest_topk(q, kk, rerank, q_store=qs)[1]
        if self._unindexed_count() and (tie_noise or rerank == 0):
            self._flush_pending()
        if rerank is None:
            rerank = self._auto_rerank()
        if not self._unindexed_count():
            return self._engine_topk(q, kk, rerank, tie_noise,
                                     q_store=qs)[1]
        rerank = rerank or self.rerank_candidates
        top_s, top_ids = self._engine_topk(
            q, min(kk, self._indexed_count()), rerank, tie_noise, q_store=qs)
        return self._merge_pending(qs, top_s, top_ids, kk)

    def query_ids(self, queries, k: int, rerank: Optional[int] = None):
        """(B, D) raw embeddings -> (B, k) sentence ids, a device tensor
        (``predict_fast``'s dispatch without the host lists).  With rows
        pending, the stale engine's re-ranked pool is merged with the
        pending and delta tiers (``rerank=0``, the path-score order,
        rebuilds first)."""
        with profiling.span("serve.query", k=k, rerank=rerank) as sp:
            q, qs, _ = self._as_query_batch(queries, True, with_store=True)
            sp.set(B=qs.shape[0])
            return self._serve(q, qs, k, rerank)

    def predict_fast(self, input, k: int = 5, return_ids: bool = False,
                     is_embedding: bool = False, tie_noise: bool = False,
                     rerank: Optional[int] = None):
        """Indexed prediction (reference ``cobweb_predict_fast``, its
        default query): the engine dispatch of ``_serve``.  ``input``: one
        query or a batch, embeddings (``is_embedding``) or text for
        ``encode_func``.  ``rerank``: the candidate pool re-ranked before
        the top-k (None: auto, 0: the path-score order).  ``tie_noise``:
        path scores plus 1e-6 noise, no re-rank.  Returns a list a query
        of sentences (None for an embedding-only row) or, with
        ``return_ids``, of ids; one query: its list."""
        with profiling.span("serve.query", k=k, rerank=rerank) as sp:
            q, qs, single = self._as_query_batch(input, is_embedding,
                                                 with_store=True)
            sp.set(B=qs.shape[0])
            return self._as_results(
                self._serve(q, qs, k, rerank, tie_noise), return_ids,
                single)

    cobweb_predict_fast = predict_fast
    cobweb_predict_indexed = predict_fast

    def _beam_index(self) -> index_mod.BeamIndex:
        """The packed BeamIndex over the flat index (a forest's,
        ``VForest.beam_index``), cached until the index changes."""
        if self.forest is not None:
            return self.forest.beam_index()
        idx = self._flat_pred_index()
        if self._beam_cache is None or self._beam_src is not idx:
            with self._rebuild("beam"):
                self._beam_cache = index_mod.build_beam_index(idx)
            self._beam_src = idx
        return self._beam_cache

    def predict(self, input, k: int = 5, return_ids: bool = False,
                is_embedding: bool = False, beam_width: int = 64,
                beam_lanes: Optional[int] = None):
        """Tree-search prediction (reference ``cobweb_predict``): the
        packed beam search down the concept hierarchy, ranked by leaf
        log-prob, on the exact index (pending rows flushed first).  A
        single tree descends ``max_depth`` rounded up to a multiple of 4
        levels; a forest runs ``VForest.beam_topk`` (lane-fair; a
        content-routed forest descends ``beam_lanes`` nearest lanes a
        query, None: auto).  Returns as ``predict_fast``."""
        self._flush_pending()
        q, single = self._as_query_batch(input, is_embedding)
        if self.forest is not None:
            sids = self.forest.beam_topk(q, k, beam_width=beam_width,
                                         lanes_per_query=beam_lanes)
        else:
            # the index first: its build sets max_depth
            bidx = self._beam_index()
            sids = index_mod.beam_query_ids(
                bidx, q, k, beam_width=beam_width,
                max_depth=-(-max(self.max_depth, 1) // 4) * 4)
        return self._as_results(sids, return_ids, single)

    cobweb_predict = predict

    def get_node_path_stats(self, sentence_id: int):
        """Means and variances of the nodes on a sentence's root->leaf path
        (reference ``get_node_path_stats``), recovered from the index's
        GEMM terms; (None, None) for an id out of range."""
        self._require_single_tree("get_node_path_stats")
        self._flush_pending()
        idx = self.build_prediction_index()
        if not 0 <= sentence_id < len(self.sentences):
            return None, None
        path = idx.paths_h[sentence_id]
        path = torch.as_tensor(path[path >= 0], device=idx.const.device)
        var = 1.0 / idx.inv_var_T.T[path]
        mean = idx.mu_over_var_T.T[path] * var
        return mean.cpu().numpy(), var.cpu().numpy()

    # ---------------------------------------------------------------- #
    # level-weight schedules (reference :335-420)                      #
    # ---------------------------------------------------------------- #
    def set_level_weights(self, weights):
        """Weights of the path levels (root first) for a single tree's
        path scores; the indexes are rebuilt at the next query."""
        self._level_weights = list(weights)
        self._weight_schedule = None
        self._invalidate_index()

    def set_weight_schedule(self, schedule_type: str, max_depth: int = 10,
                            **kwargs):
        """Level weights from a schedule (``_generate_weight_schedule``)
        over ``max_depth`` levels, or over the built index's depth when
        one exists."""
        if self._index is not None:
            max_depth = max(self.max_depth, 1)
        self._weight_schedule = schedule_type
        self._schedule_params = kwargs
        self._level_weights = _generate_weight_schedule(
            schedule_type, max_depth, **kwargs)
        self._invalidate_index()

    def get_level_weights(self):
        return self._level_weights or [1.0, 1.0, 1.0, 1.0]

    def get_weight_schedule_info(self):
        return {"schedule_type": self._weight_schedule,
                "schedule_params": self._schedule_params,
                "current_weights": self.get_level_weights()}

    # ---------------------------------------------------------------- #
    # persistence                                                      #
    # ---------------------------------------------------------------- #
    def _require_single_tree(self, what: str):
        if self.forest is not None:
            raise ValueError(
                f"{what} requires single-tree mode (n_subtrees=1)")

    def _sids_by_leaf(self) -> dict:
        sids_by_leaf: dict = {}
        for sid, leaf in enumerate(self.leaf_of_sentence):
            sids_by_leaf.setdefault(leaf, []).append(sid)
        return sids_by_leaf

    def print_tree(self):
        """Print the tree, each node with its sentence ids and sentences
        (reference ``print_tree``)."""
        self._require_single_tree("print_tree")
        a = self.tree.host_arrays()
        sids_by_leaf = self._sids_by_leaf()

        def rec(n, depth):
            pad = "  " * depth
            sids = sids_by_leaf.get(n, [])
            print(f"{pad}- Node {n} sids={sids}")
            for sid in sids:
                s = self.sentences[sid]
                print(f"{pad}    {s!r}" if s is not None
                      else f"{pad}    [Embedding only]")
            for i in range(int(a["n_children"][n])):
                rec(int(a["children"][n, i]), depth + 1)

        print("\nCobweb Sentence Clustering Tree:")
        rec(int(a["root"]), 0)

    def visualize_subtrees(self, directory: str, num_leaves: int = 6):
        """Graphviz views of the grandparent subtrees (reference
        ``_visualize_grandparent_tree``): PNG with the ``dot`` binary, else
        the ``.dot`` sources; returns their paths."""
        self._require_single_tree("visualize_subtrees")
        return visualize_grandparent_subtrees(
            self.tree, self.sentences, self._sids_by_leaf(), directory,
            num_leaves=num_leaves)

    def dump_json(self, save_path: Optional[str] = None) -> str:
        """The reference-parity JSON: the tree in the nested schema with
        each leaf's sentence ids, the sentences and the tree width (no
        whitener, no vector store); loads in either package."""
        self._require_single_tree("dump_json")
        sids_by_leaf = self._sids_by_leaf()
        blob = json.dumps({
            "tree": json.loads(self.tree.dump_json(sids_by_leaf)),
            "sentences": self.sentences,
            "embedding_dim": self.cfg.dim,
        }, indent=2)
        if save_path:
            with open(save_path, "w") as f:
                f.write(blob)
        return blob

    @staticmethod
    def load_json(json_data, encode_func: Callable = _identity_encode,
                  device="cuda") -> "CobwebIndex":
        """An index from ``dump_json``'s output (a string or its parsed
        dict), of either package: no whitener and no vector store, so
        pools re-rank by leaf log-prob."""
        data = json.loads(json_data) if isinstance(json_data, str) \
            else json_data
        tree, leaf_sids = CobwebTree.load_json(json.dumps(data["tree"]),
                                               device=device)
        sentences = data.get("sentences", [])
        leaf_of = np.full((len(sentences),), -1, np.int64)
        for leaf, sids in leaf_sids.items():
            leaf_of[np.asarray(sids, np.int64)] = leaf
        obj = CobwebIndex.__new__(CobwebIndex)
        obj._setup(tree, None, sentences, [int(v) for v in leaf_of],
                   encode_func, None)
        return obj

    def save(self, path: str):
        """The npz checkpoint in the JAX package's layout, in either mode:
        the tree's or forest's ``save_npz`` state, the ``sentences`` object
        array ("" for an embedding-only row, flagged in
        ``sentence_is_none``), the raw ``vectors`` when the store covers
        every sentence, and ``whitener_pickle``, a stream the JAX package
        unpickles into its own whitener class
        (``files.whitener_pickle``).  Rows pending go in as the tree holds
        them; a loaded index indexes them at its first query."""
        extras = dict(
            sentences=np.asarray([s if s is not None else ""
                                  for s in self.sentences], dtype=object),
            sentence_is_none=np.asarray([s is None for s in self.sentences],
                                        bool))
        emb = self._emb_device()
        if emb is not None:       # the exact rows, whatever the store holds
            n = len(self.sentences)
            extras["vectors"] = (self._emb_host if self._emb_host is not None
                                 else emb)[:n].cpu().numpy()
        if self.whitener is not None:
            extras["whitener_pickle"] = np.frombuffer(
                files.whitener_pickle(self.whitener), np.uint8)
        if self.forest is not None:
            self.forest.save_npz(path, **extras)
        else:
            self.tree.save_npz(path, leaf_of_sentence=np.asarray(
                self.leaf_of_sentence, np.int64), **extras)

    @staticmethod
    def load(path: str, encode_func: Callable = _identity_encode,
             device="cuda") -> "CobwebIndex":
        """An index from a ``save`` file of either package, on ``device``:
        the whitener through the restricted unpickler
        (``files.whitener_from_pickle``: no JAX object is built), the
        device stores rebuilt from ``vectors`` (the raw rows, and in
        whitener mode the whitened bf16 store with its half-norms), so the
        backstop and the tiers serve as they did for the saved index."""
        with np.load(path, allow_pickle=False) as probe:
            is_forest = "__forest__" in probe.files
        tree = forest = None
        if is_forest:
            forest, extras = VForest.load_npz(path, device=device)
            leaf_of = []
        else:
            tree, extras = CobwebTree.load_npz(path, device=device)
            leaf_of = [int(v) for v in extras["leaf_of_sentence"]]
        whitener = None
        if "whitener_pickle" in extras:
            whitener = files.whitener_from_pickle(
                np.asarray(extras["whitener_pickle"], np.uint8).tobytes())
        sentences = [None if none else str(s) for s, none in
                     zip(extras["sentences"], extras["sentence_is_none"])]
        obj = CobwebIndex.__new__(CobwebIndex)
        obj._setup(tree, forest, sentences, leaf_of, encode_func, whitener)
        if "vectors" in extras:
            raw = torch.as_tensor(np.asarray(extras["vectors"], np.float32),
                                  device=obj.device)
            obj._store_rows(raw, whitener.transform_torch(raw)
                            if whitener is not None else raw)
        return obj


def _generate_weight_schedule(schedule_type: str, max_depth: int,
                              **kwargs) -> list:
    """Level-weight schedules (reference ``_generate_weight_schedule``):
    constant (``value``), linear (``start`` to ``end``; ``direction=
    "decrease"`` swaps them), quadratic (1 / (``start_n`` + i)^2) or
    exponential (``base``^i), over ``max_depth`` levels."""
    if schedule_type == "constant":
        return [kwargs.get("value", 1.0)] * max_depth
    if schedule_type == "linear":
        start = kwargs.get("start", 1.0)
        end = kwargs.get("end", 1.0)
        if kwargs.get("direction", "increase") == "decrease":
            start, end = end, start
        if max_depth == 1:
            return [start]
        step = (end - start) / (max_depth - 1)
        return [start + i * step for i in range(max_depth)]
    if schedule_type == "quadratic":
        start_n = kwargs.get("start_n", 1)
        return [1.0 / (max(start_n + i, 1) ** 2) for i in range(max_depth)]
    if schedule_type == "exponential":
        base = kwargs.get("base", 0.5)
        return [base ** i for i in range(max_depth)]
    raise ValueError(f"Unknown schedule type: {schedule_type}")
