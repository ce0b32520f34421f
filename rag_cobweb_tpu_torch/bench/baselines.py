"""Exact flat baseline (port of ``FlatIndex`` from
``rag_cobweb_tpu/bench/baselines.py``): one float32 product (TF32 off)
and ``torch.topk``."""

from __future__ import annotations

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device


class FlatIndex:
    """Exact IP / cosine / L2 search over a corpus held on the device."""

    def __init__(self, corpus_embs, metric: str = "ip", device="cuda"):
        if metric not in ("ip", "l2", "cosine"):
            raise ValueError(f"unknown metric {metric}")
        self.device = resolve_device(device)
        full_f32_matmul()
        self.metric = metric
        embs = torch.as_tensor(np.asarray(corpus_embs, np.float32),
                               device=self.device)
        if metric == "cosine":
            embs = embs / embs.norm(dim=1, keepdim=True).clamp(min=1e-12)
        self.embs = embs
        self._sq_norms = torch.sum(torch.square(embs), dim=1)

    def search_device(self, queries, k: int) -> torch.Tensor:
        """(B, D) -> (B, k) ids as a device tensor (no host sync)."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        if q.dim() == 1:
            q = q.unsqueeze(0)
        if self.metric == "cosine":
            q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
        scores = torch.matmul(q, self.embs.T)
        if self.metric == "l2":
            scores = 2.0 * scores - self._sq_norms   # 2qc - ||c||^2 ~ -d2
        return torch.topk(scores, min(k, self.embs.shape[0]), dim=1).indices

    def search(self, queries, k: int) -> np.ndarray:
        return self.search_device(queries, k).cpu().numpy()

    __call__ = search
