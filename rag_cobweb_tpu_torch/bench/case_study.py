"""Qualitative case study (port of ``rag_cobweb_tpu/bench/case_study.py``,
copied): find queries where whitened-Cobweb retrieval
succeeds but the exact flat baseline fails (or vice versa) and print them
(reference src/benchmarks/gpt_case_study.py:16-118, whose diff loop :108-117
compares per-query hits between methods)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from rag_cobweb_tpu_torch.bench.metrics import ranks_of_targets


def retrieval_diff(ids_a: np.ndarray, ids_b: np.ndarray,
                   target_ids: np.ndarray, k: int = 10) -> dict:
    """Queries (indices) hit by A but missed by B within top-k, and the
    reverse."""
    ra = ranks_of_targets(np.asarray(ids_a), np.asarray(target_ids))
    rb = ranks_of_targets(np.asarray(ids_b), np.asarray(target_ids))
    a_hit = (ra > 0) & (ra <= k)
    b_hit = (rb > 0) & (rb <= k)
    return {
        "a_only": np.where(a_hit & ~b_hit)[0],
        "b_only": np.where(b_hit & ~a_hit)[0],
        "both": np.where(a_hit & b_hit)[0],
        "neither": np.where(~a_hit & ~b_hit)[0],
    }


def print_case_study(diff: dict, queries: Sequence, targets: Sequence,
                     retrieved_a: np.ndarray, corpus: Optional[Sequence],
                     name_a: str = "Cobweb PCA+ICA",
                     name_b: str = "Flat exact", limit: int = 10):
    """Human-readable dump of the diff cases (reference :96-118)."""
    print(f"\n=== queries {name_a} retrieves but {name_b} misses "
          f"({len(diff['a_only'])}) ===")
    for qi in diff["a_only"][:limit]:
        print(f"\n[Q{qi}] {queries[qi]!r}\n  gold: {targets[qi]!r}")
        if corpus is not None:
            got = [corpus[i] for i in retrieved_a[qi][:3] if i >= 0]
            print(f"  {name_a} top-3: {got!r}")
    print(f"\n(also: {len(diff['b_only'])} {name_b}-only, "
          f"{len(diff['both'])} both, {len(diff['neither'])} neither)")
