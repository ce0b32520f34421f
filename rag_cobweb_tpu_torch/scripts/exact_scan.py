"""Chunked exact flat scan over a million-benchmark cache, on the card
(twin of ``scripts/exact_scan.py``): the exact-search recall ceiling at
scales where a one-shot scan's (B, S) scores do not fit beside a live
forest.

    python -m rag_cobweb_tpu_torch.scripts.exact_scan --cache CACHE.npz \\
        [--size N] [--k 10] [--chunk 131072] [--device cuda]

The corpus streams through the device in row chunks; each chunk is
scored by monotone L2, ``q.x - 0.5 ||x||^2`` (one float32 ``matmul``,
TF32 off: an XLA product in the JAX package, no Pallas kernel), and a
running top-k is folded on the device, the lower id first among equal
scores (``jax.lax.top_k``'s order); only the final (B, k) ids come back.
The JAX script pads the last chunk with 1e30 rows to keep one compiled
shape; PyTorch needs no fixed shape, so the last chunk is scored as it
is and no pad row exists to enter the top-k.  ``--cache``: whitened
(``corpus_w`` / ``queries_w``) or raw (``corpus`` / ``queries``), written
by either package.  Not carried over, as it exists only for the TPU: the
XLA compile cache.
"""

import argparse
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device


def scan(corpus: np.ndarray, queries: np.ndarray, k: int, chunk: int,
         device) -> torch.Tensor:
    """(B, k) ids of the exact monotone-L2 top-k, ``corpus`` streamed in
    ``chunk``-row slices through ``device``."""
    full_f32_matmul()
    from rag_cobweb_tpu_torch.core.index import topk_stable
    qd = torch.as_tensor(queries, device=device)
    B = qd.shape[0]
    best_s = torch.full((B, k), float("-inf"), device=device)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=device)
    for s in range(0, len(corpus), chunk):
        x = torch.as_tensor(corpus[s:s + chunk], device=device)
        sc = qd @ x.T - 0.5 * torch.sum(x * x, dim=1)[None, :]
        cs, ci = topk_stable(sc, min(k, x.shape[0]))
        ns, pos = topk_stable(torch.cat([best_s, cs], dim=1), k)
        best_i = torch.cat([best_i, ci + s], dim=1).gather(1, pos)
        best_s = ns
    return best_i


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", required=True,
                    help="mb_cache_*.npz (whitened: corpus_w/queries_w)")
    ap.add_argument("--size", type=int, default=None,
                    help="corpus prefix size (default: full cache)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=131072)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with np.load(args.cache) as z:
        corpus = z["corpus_w"] if "corpus_w" in z else z["corpus"]
        queries = z["queries_w"] if "queries_w" in z else z["queries"]
        target_ids = z["target_ids"]
    n = args.size or len(corpus)
    corpus = corpus[:n]
    mask = target_ids < n
    queries = queries[mask]
    gold = target_ids[mask]
    print(f"[exact] corpus {corpus.shape}, queries {queries.shape}",
          flush=True)

    B, k = len(queries), args.k
    t0 = time.perf_counter()
    ids = scan(corpus, queries, k, args.chunk, dev).cpu().numpy()
    dt = time.perf_counter() - t0
    recall = float(np.mean([g in row for g, row in zip(gold, ids)]))
    print(f"[exact] recall@{k} = {recall:.4f}  "
          f"({dt:.1f}s scan, {1e3 * dt / B:.4f} ms/q streamed)", flush=True)
    return {"ids": ids, "gold": gold, f"recall@{k}": recall, "scan_s": dt}


if __name__ == "__main__":
    main()
