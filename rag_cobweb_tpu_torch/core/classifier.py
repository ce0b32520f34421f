"""Labeled Cobweb: classification over the concept hierarchy (port of
``rag_cobweb_tpu/core/classifier.py``).

Labels ride with the sentences, not with the node updates: a node's label
counts are the label mass of the leaves under it, one bottom-up pass over
the host arrays in float64, smoothed by ``alpha``.  ``predict_probs``
scores every live node at once, the (B, N) diagonal-Gaussian log-probs as
two float32 products (TF32 off on the card, ``device.full_f32_matmul``),
optionally cut to each query's top ``max_nodes`` nodes (the k-th score by
``torch.topk``, every node at or above it kept, as in the JAX package),
then a logsumexp over nodes of ``log p(x|node) + log p(label|node)`` and a
softmax over labels.  ``dump_json``/``load_json`` use the JAX package's
schema, so either package loads the other's file.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.tree import CobwebTree
from rag_cobweb_tpu_torch.device import full_f32_matmul
from rag_cobweb_tpu_torch.ops.gaussian import (batched_node_log_probs,
                                               compute_var,
                                               node_log_prob_terms)


class CobwebClassifier:
    def __init__(self, cfg: TreeConfig, capacity: int = 4096, seed: int = 0,
                 alpha: Optional[float] = None, device="cuda"):
        self._setup(CobwebTree(cfg, capacity=capacity, seed=seed,
                               device=device),
                    cfg.alpha if alpha is None else alpha, {}, [], [])

    def _setup(self, tree: CobwebTree, alpha: float, reverse_labels: dict,
               sentence_labels: list, leaf_of_sentence: list):
        """Every attribute of a new or loaded classifier."""
        full_f32_matmul()
        self.tree = tree
        self.cfg = tree.cfg
        self.alpha = alpha
        self.reverse_labels = dict(reverse_labels)    # idx -> label
        self.labels = {v: k for k, v in self.reverse_labels.items()}
        self.sentence_labels = list(sentence_labels)
        self.leaf_of_sentence = list(leaf_of_sentence)
        self._cache = None

    @property
    def device(self) -> torch.device:
        return self.tree.device

    def _label_idx(self, label) -> int:
        if label not in self.labels:
            idx = len(self.labels)
            self.labels[label] = idx
            self.reverse_labels[idx] = label
        return self.labels[label]

    def fit(self, X, y: Sequence, iterations: int = 1,
            randomize_first: bool = True, seed: int = 0):
        """Batch fit: ``iterations`` passes, the first shuffled by ``seed``
        when ``randomize_first`` (repeated rows land on their exact-match
        leaves)."""
        X = np.asarray(X, np.float32)
        rng = np.random.default_rng(seed)
        for it in range(iterations):
            order = np.arange(len(X))
            if randomize_first and it == 0:
                rng.shuffle(order)
            self.partial_fit(X[order], [y[i] for i in order])
        return self

    def partial_fit(self, X, y: Sequence):
        leaves = self.tree.fit(np.asarray(X, np.float32))
        self.leaf_of_sentence.extend(int(v) for v in leaves)
        self.sentence_labels.extend(self._label_idx(v) for v in y)
        self._cache = None
        return self

    @property
    def n_labels(self) -> int:
        return len(self.labels)

    def _build_cache(self):
        """The live nodes in BFS order (parents first), their smoothed log
        label distribution (bottom-up label mass in float64) and their
        product terms, on the tree's device."""
        if self._cache is not None:
            return self._cache
        a = self.tree.host_arrays()
        children, n_children = a["children"], a["n_children"]
        order = [int(a["root"])]
        head = 0
        while head < len(order):
            n = order[head]
            head += 1
            order.extend(int(c) for c in children[n, :int(n_children[n])])
        counts = np.zeros((a["counts"].shape[0], self.n_labels), np.float64)
        np.add.at(counts, (np.asarray(self.leaf_of_sentence, np.int64),
                           np.asarray(self.sentence_labels, np.int64)), 1.0)
        for n in reversed(order):     # children accumulate into parents
            for c in children[n, :int(n_children[n])]:
                counts[n] += counts[int(c)]
        label_counts = counts[order] + self.alpha
        log_label = np.log(label_counts) - np.log(
            label_counts.sum(axis=1, keepdims=True))
        st = self.tree.state
        live = torch.as_tensor(order, device=self.device)
        ns = st.counts[0][live].float()
        var = compute_var(st.m2s[0][live].float(), ns[:, None], self.cfg)
        terms = node_log_prob_terms(st.means[0][live].float(), var)
        self._cache = (terms, torch.as_tensor(log_label, dtype=torch.float32,
                                              device=self.device))
        return self._cache

    def predict_probs(self, X, max_nodes: Optional[int] = None) -> np.ndarray:
        """(B, D) -> (B, L) label probabilities: the logsumexp over nodes
        of ``log p(x|node) + log p(label|node)``, over each query's top
        ``max_nodes`` nodes when given, then a softmax."""
        (ivt, movt, const), log_label = self._build_cache()
        X = torch.as_tensor(np.atleast_2d(np.asarray(X, np.float32)),
                            device=self.device)
        nlp = batched_node_log_probs(X, ivt, movt, const)      # (B, N)
        if max_nodes is not None and max_nodes < nlp.shape[1]:
            kth = torch.topk(nlp, max_nodes, dim=1).values[:, -1:]
            nlp = torch.where(nlp >= kth, nlp,
                              torch.full_like(nlp, float("-inf")))
        logp = torch.logsumexp(nlp[:, :, None] + log_label[None], dim=1)
        return torch.softmax(logp, dim=-1).cpu().numpy()

    def predict(self, X, max_nodes: Optional[int] = None) -> list:
        probs = self.predict_probs(X, max_nodes)
        return [self.reverse_labels[int(i)] for i in probs.argmax(axis=1)]

    def score(self, X, y) -> float:
        pred = self.predict(X)
        return float(np.mean([p == t for p, t in zip(pred, y)]))

    def dump_json(self) -> str:
        """The labeled-tree schema: the tree's JSON with each leaf's
        sentence ids, ``reverse_labels``, ``sentence_labels`` and
        ``alpha``."""
        sids: dict = {}
        for sid, leaf in enumerate(self.leaf_of_sentence):
            sids.setdefault(leaf, []).append(sid)
        return json.dumps({
            "tree": json.loads(self.tree.dump_json(sids)),
            "reverse_labels": {str(k): v for k, v in
                               self.reverse_labels.items()},
            "sentence_labels": self.sentence_labels,
            "alpha": self.alpha,
        })

    @classmethod
    def load_json(cls, blob: str, device="cuda") -> "CobwebClassifier":
        """A classifier from a ``dump_json`` string of either package."""
        data = json.loads(blob)
        tree, leaf_sids = CobwebTree.load_json(json.dumps(data["tree"]),
                                               device=device)
        sentence_labels = list(data["sentence_labels"])
        leaf_of = [0] * len(sentence_labels)
        for leaf, sids in leaf_sids.items():
            for sid in sids:
                leaf_of[sid] = leaf
        obj = cls.__new__(cls)
        obj._setup(tree, data.get("alpha", tree.cfg.alpha),
                   {int(k): v for k, v in data["reverse_labels"].items()},
                   sentence_labels, leaf_of)
        return obj
