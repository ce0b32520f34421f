"""CobwebIndex: a port of ``rag_cobweb_tpu/core/wrapper.py``.

Single-tree mode (``n_subtrees=1``, the default: one ``CobwebTree``, the
reference's ``CobwebWrapper``) or forest mode (``n_subtrees >= 2``,
round-robin lanes), optionally with a wrapper-owned whitener: embeddings
arrive RAW, the tree and the candidate pool run in whitened space, and
the raw float32 vector store feeds the exact re-rank, so the final
ranking is exact raw-space search whenever the gold row is in the pool.

Serving: ``query_ids`` -> ``_engine_topk``, which picks the engine as the
JAX package does:

* below ``blocked_threshold`` sentences (a single tree only): the path
  scores of the prediction index in PyTorch (``index.query_topk``), then
  the re-rank;
* ``use_pallas`` and at least ``pallas_threshold`` sentences: the blocked
  sweep kernel (``_pallas_topk`` -> ``ops/blocked_topk.blocked_topk``);
* ``use_fused`` (the default): ``_product_chunked`` ->
  ``index.fused_query_rerank`` (fused sweep kernel, exact top-c pool,
  exact re-rank kernel);
* otherwise the blocked sweep in PyTorch (``index.blocked_query_topk``).

A re-rank pool goes through ``_rerank_step``: the exact stored-row
re-rank, or the leaf log-prob re-rank when no vector store is kept.  A
single tree reaches the fused sweep through its prediction index
(``index.build_fused_index``), a forest straight from its state.  Not
carried yet (each raises ``NotImplementedError`` where it would run): the
small-forest engine that serves a forest below ``blocked_threshold``
sentences (and the forest's stacked index and rank scores), the
pending/delta tier (here an add drops the serving indexes and the next
query rebuilds them) and the whitened backstop pool.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
import torch

from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree, align_capacity
from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device
from rag_cobweb_tpu_torch.ops import blocked_topk
from rag_cobweb_tpu_torch.parallel.vforest import VForest


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
                 whitener=None, device="cuda"):
        self.device = resolve_device(device)
        # float32 products run in full float32 on the card (TF32 off): the
        # counterpart of the JAX package's Precision.HIGHEST
        full_f32_matmul()
        self.encode_func = encode_func
        self.whitener = whitener
        self.sentences: list = []
        self.leaf_of_sentence: list = []
        self.n_subtrees = int(n_subtrees)

        if corpus_embeddings is not None:
            corpus_embeddings = np.asarray(corpus_embeddings, np.float32)
            dim = corpus_embeddings.shape[1]
            if whitener is not None:
                dim = whitener.dim_out
        elif corpus:
            dim = np.asarray(self.encode_func([corpus[0]])).shape[-1]
            if whitener is not None:
                dim = whitener.dim_out
        elif config is not None:
            dim = config.dim
        else:
            raise ValueError(
                "need corpus, corpus_embeddings, or config to fix the dim")
        self.cfg = config or TreeConfig(dim=dim)
        n0 = len(corpus_embeddings) if corpus_embeddings is not None else (
            len(corpus) if corpus else 0)
        cap = capacity or max(1024, 4 * n0 + 16)
        if self.n_subtrees > 1:
            self.tree = None
            self.forest = VForest(
                self.cfg, n_subtrees=self.n_subtrees,
                capacity_per_tree=max(1024, cap // self.n_subtrees),
                seed=seed, routing=routing, device=self.device)
            self.cfg = self.forest.cfg
        else:
            self.forest = None
            self.tree = CobwebTree(self.cfg, capacity=cap, seed=seed,
                                   device=self.device)
        self._init_serving()

        if corpus_embeddings is not None:
            if corpus is None:
                corpus = [None] * len(corpus_embeddings)
            self.add_sentences(corpus, corpus_embeddings)
        elif corpus:
            self.add_sentences(corpus)

    def _init_serving(self):
        """Vector store, serving caches and engine settings of a new or
        loaded index."""
        self.store_embeddings = True
        self._vec_chunks: list = []
        self._emb_dev_cache = None
        self._emb_dev_n = 0
        self._emb_dev_cap = 0
        self._invalidate_index()
        self.blocked_threshold = 8192

    def __len__(self):
        return len(self.sentences)

    # ---------------------------------------------------------------- #
    # ingestion                                                        #
    # ---------------------------------------------------------------- #
    def add_sentences(self, new_sentences, new_vectors=None,
                      batch_size: int = 2048):
        """Insert sentences/embeddings; returns each row's leaf slot (one
        tree) or its global id (forest).  Any serving index is dropped and
        rebuilt by the next query."""
        if new_vectors is None:
            new_vectors = self.encode_func(new_sentences)
        store_vecs = np.asarray(new_vectors, np.float32)
        if store_vecs.ndim == 1:
            store_vecs = store_vecs[None, :]
        raw = torch.as_tensor(store_vecs, device=self.device)
        tree_vecs = (self.whitener.transform_torch(raw)
                     if self.whitener is not None else raw)
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
        self.sentences.extend(new_sentences)
        if self.store_embeddings:
            self._vec_chunks.append(store_vecs)
            self._emb_dev_cache = None
        self._invalidate_index()
        return out

    def _invalidate_index(self):
        self._index = None
        self._fused = None
        self._fused_f32 = None
        self._blocked = None
        self._blocked_f32 = None

    def _emb_device(self) -> Optional[torch.Tensor]:
        """(cap, D) raw store on the device, zero rows past the live count;
        the capacity grows 1.25x geometrically, as in the JAX package."""
        if not self.store_embeddings or not self._vec_chunks:
            return None
        n = len(self.sentences)
        if self._emb_dev_cache is None or self._emb_dev_n != n:
            if len(self._vec_chunks) > 1:
                self._vec_chunks = [np.concatenate(self._vec_chunks)]
            host = self._vec_chunks[0]
            if host.shape[0] != n:
                return None
            if self._emb_dev_cap < n:
                self._emb_dev_cap = align_capacity(
                    max(n, int(self._emb_dev_cap * 1.25), 4096))
            emb = torch.zeros((self._emb_dev_cap, host.shape[1]),
                              dtype=torch.float32, device=self.device)
            emb[:n] = torch.as_tensor(host, device=self.device)
            self._emb_dev_cache = emb
            self._emb_dev_n = n
        return self._emb_dev_cache

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
            if self.forest is not None:
                fidx = self.forest.fused_index(dtype=dtype)
            else:
                fidx = index_mod.build_fused_index(self._flat_pred_index(),
                                                   dtype=dtype)
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
        bs = self.backstop_pool
        if bs == "auto":
            if not (self.whitener is not None and self.store_embeddings
                    and len(self.sentences) >= self.backstop_threshold):
                return 0
            bs = pool
        if int(bs) > 0:
            raise NotImplementedError(
                "the whitened backstop pool (index.backstop_topk) is not "
                f"ported yet; it is on at {self.backstop_threshold}+ "
                "sentences in whitener mode (set backstop_pool=0)")
        return 0

    def _flat_pred_index(self) -> index_mod.PredictionIndex:
        """The flat PredictionIndex over global sentence ids: the whole
        forest flattened (``VForest.flat_index``, cached until an add), or
        a single tree's prediction index."""
        if self.forest is not None:
            return self.forest.flat_index()
        return self.build_prediction_index()

    def build_prediction_index(self) -> index_mod.PredictionIndex:
        """The single tree's PredictionIndex (``index.build_index``),
        cached until the next add."""
        if self.forest is not None:
            raise NotImplementedError(
                "a forest's prediction index is the small-forest engine's "
                "stacked index, which is not ported yet")
        if self._index is None:
            self._index = index_mod.build_index(
                self.tree, np.asarray(self.leaf_of_sentence, np.int64))
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
                self._blocked_f32 = index_mod.build_blocked_index(
                    self._flat_pred_index())
            return self._blocked_f32
        if self._blocked is None:
            self._blocked = index_mod.build_blocked_index(
                self._flat_pred_index(),
                dtype=getattr(torch, self.blocked_dtype))
        return self._blocked

    def _chunk(self, B: int, row_bytes: int) -> int:
        bmax = max(32, int(self.fused_score_budget) // max(row_bytes, 1))
        return B if bmax >= B else 1 << (bmax.bit_length() - 1)

    def _product_chunked(self, q, kk: int, pool: int, n_indexed: int,
                         q_store=None):
        """Sweep + exact pool + exact re-rank, the query batch chunked so
        one chunk's working set stays under ``fused_score_budget``: the
        kernel's (NS, Bc, kappa) pool, or on the host the plain versions'
        (Bc, Sp) scores and (Bc, C, D) gather."""
        fidx = self._fused_index()
        emb = self._emb_device()
        qs = q if q_store is None else q_store
        self._backstop_k(pool, n_indexed)
        kappa = min(pool, index_mod._FUSED_ROW_BUCKET)
        row = fidx.num_slots // index_mod._FUSED_ROW_BUCKET * kappa * 8
        if q.device.type == "cpu":
            row = max(row, fidx.num_slots * 12, pool * emb.shape[1] * 4)
        bmax = self._chunk(q.shape[0], row)
        pv = float(self.cfg.prior_var)
        outs = [index_mod.fused_query_rerank(fidx, emb, q[s:s + bmax],
                                             qs[s:s + bmax], kk, pool, pv)
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

    def _engine_topk(self, q, kk: int, rerank: int, q_store=None):
        """Dispatch to the engines: below ``blocked_threshold`` the path
        scores of the prediction index (a single tree; a forest never gets
        here), else the blocked sweep kernel (opt-in, above
        ``pallas_threshold``), else the fused engine, else the blocked
        sweep in PyTorch; each with the optional re-rank.  ``rerank=0``:
        the raw path-score order from an f32 index."""
        n_indexed = len(self.sentences)
        if n_indexed < self.blocked_threshold:
            idx = self._flat_pred_index()
            if rerank:
                c = min(max(rerank, kk), idx.num_sentences)
                cs, cand = index_mod.query_topk(idx, q, c)
                return self._rerank_step(idx, q, cand, cs, kk,
                                         q_store=q_store)
            return index_mod.query_topk(idx, q, kk)
        if self.use_pallas and n_indexed >= self.pallas_threshold:
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

    def _as_query_batch(self, input, is_embedding: bool):
        """A query input (embeddings, or text for ``encode_func``) as a
        (B, D) tree-space device batch, and whether it was one query."""
        if is_embedding:
            arr = np.asarray(input, np.float32)
            single = arr.ndim == 1
        else:
            single = isinstance(input, str)
            arr = np.asarray(self.encode_func([input] if single
                                              else list(input)), np.float32)
        qs = torch.as_tensor(np.atleast_2d(arr), device=self.device)
        q = (self.whitener.transform_torch(qs)
             if self.whitener is not None else qs)
        return q, single

    def rank_scores(self, input, is_embedding: bool = False):
        """Per-sentence path scores of the single tree (reference
        ``cobweb_rank_scores``): (B, D) -> (B, S), one query -> (S,)."""
        if self.forest is not None:
            raise NotImplementedError(
                "a forest's rank scores (vforest_rank_scores) are not "
                "ported yet")
        q, single = self._as_query_batch(input, is_embedding)
        scores = index_mod.rank_scores(self.build_prediction_index(), q)
        return scores[0] if single else scores

    def query_ids(self, queries, k: int, rerank: Optional[int] = None):
        """(B, D) raw embeddings -> (B, k) sentence ids, a device tensor."""
        qs = torch.as_tensor(np.asarray(queries, np.float32),
                             device=self.device)
        if qs.dim() == 1:
            qs = qs.unsqueeze(0)
        q = (self.whitener.transform_torch(qs)
             if self.whitener is not None else qs)
        kk = min(k, len(self.sentences))
        if (self.forest is not None
                and len(self.sentences) < self.blocked_threshold):
            raise NotImplementedError(
                f"{len(self.sentences)} sentences is below blocked_threshold"
                f"={self.blocked_threshold}: the small-forest engine "
                "(_small_forest_topk) that serves there is not ported yet")
        if rerank is None:
            rerank = self._auto_rerank()
        return self._engine_topk(q, kk, rerank, q_store=qs)[1]

    # ---------------------------------------------------------------- #
    # persistence                                                      #
    # ---------------------------------------------------------------- #
    def _require_single_tree(self, what: str):
        if self.forest is not None:
            raise ValueError(
                f"{what} requires single-tree mode (n_subtrees=1)")

    def dump_json(self, save_path: Optional[str] = None) -> str:
        """The reference-parity JSON: the tree in the nested schema with
        each leaf's sentence ids, the sentences and the tree width (no
        whitener, no vector store); loads in either package."""
        self._require_single_tree("dump_json")
        sids_by_leaf: dict = {}
        for sid, leaf in enumerate(self.leaf_of_sentence):
            sids_by_leaf.setdefault(leaf, []).append(sid)
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
        obj = CobwebIndex.__new__(CobwebIndex)
        obj.device = tree.device
        obj.encode_func = encode_func
        obj.whitener = None
        obj.sentences = data.get("sentences", [])
        obj.cfg = tree.cfg
        obj.tree = tree
        obj.forest = None
        obj.n_subtrees = 1
        leaf_of = np.full((len(obj.sentences),), -1, np.int64)
        for leaf, sids in leaf_sids.items():
            leaf_of[np.asarray(sids, np.int64)] = leaf
        obj.leaf_of_sentence = [int(v) for v in leaf_of]
        obj._init_serving()
        return obj
