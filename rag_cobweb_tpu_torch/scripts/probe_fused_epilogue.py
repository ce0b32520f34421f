"""Does the fused sweep's epilogue (+ bias, valid mask) cost memory time?
On the card (twin of ``scripts/probe_fused_epilogue.py``): a random
fused index at 1M slots in three forms, served (GEMM + bias + valid
mask + pool), folded (-3e38 in the bias at the pad, no mask) and
stripped (GEMM + pool).

    python -m rag_cobweb_tpu_torch.scripts.probe_fused_epilogue \\
        [--slots 1000000] [--dim 128] [--batch 1024] [--k 512] \\
        [--device cuda]

Kernel 1 (``index.fused_query_topk``: per-slab pools and their merge,
exact) runs the served index and the folded one (its valid mask all
true).  The library runs all three forms: ``torch.matmul`` of the bf16
values widened to f32 (exact products, f32 sums, TF32 off; a bf16 GEMM
in PyTorch rounds its scores to bf16), bias and mask, ``torch.topk``.
The JAX script's pools are ``approx_max_k``; PyTorch has none, so every
pool here is exact.  Times: the mean of 5 distinct batches issued back
to back and one synchronize, after a warm call (the JAX script's relay
round trip has no counterpart).  Each line carries kernel 1's bound,
twice: ``roofline_min_ms``, ``bench/roofline.fused_flat_model`` (its
unfused accounting, with the (B, Sp) scores written and read back), and
``bound_ms``, the inputs read once and the pools written once against
the bf16 peak.  The script holds kernel 1's served and folded pools
against the library's served form: the same ids but at ties (an id in
one pool only must score within 1e-3 + 1e-5 of its terms of the k-th
library score).  Not carried over, as it exists only for the TPU: the
XLA compile cache.
"""

import argparse
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import full_f32_matmul, resolve_device


def inputs(slots: int, dim: int, batch: int):
    """The JAX script's draws (``default_rng(0)``): GT (2D, Sp) bf16, c,
    the folded c, valid, 6 query batches (host arrays / tensors)."""
    Sp = -(-slots // 2048) * 2048
    rng = np.random.default_rng(0)
    GT = torch.from_numpy(rng.standard_normal((2 * dim, Sp))
                          .astype(np.float32)).to(torch.bfloat16)
    c = rng.standard_normal((Sp,)).astype(np.float32)
    c_folded = c.copy()
    c_folded[slots:] = -3e38
    valid = np.arange(Sp) < slots
    qs = [rng.standard_normal((batch, dim)).astype(np.float32)
          for _ in range(6)]
    return GT, c, c_folded, valid, qs


def hold_pool(ids, scores, terms_of, k_scores, what: str) -> int:
    """Kernel pool ``ids`` (B, k) against the library's served scores
    ``scores`` (B, Sp) and its k-th score a row ``k_scores``: every id in
    one pool only scores within 1e-3 + 1e-5 of its terms of the k-th.
    Returns the ids that differ (ties)."""
    lib = torch.topk(scores, ids.shape[1], dim=1).indices
    ties = 0
    for qi in range(ids.shape[0]):
        a, b = set(ids[qi].tolist()), set(lib[qi].tolist())
        if a == b:
            continue
        terms = terms_of(qi)
        for sid in a ^ b:
            gap = abs(float(scores[qi, sid] - k_scores[qi]))
            if gap > 1e-3 + 1e-5 * float(terms[sid]):
                raise AssertionError(
                    f"{what}: query {qi}, id {sid} is in one pool only and "
                    f"scores {gap:.3g} from the k-th")
            ties += 1
    return ties


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--slots", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--k", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32_matmul()

    from rag_cobweb_tpu_torch.bench import roofline as rl
    from rag_cobweb_tpu_torch.core.index import FusedIndex, fused_query_topk
    from rag_cobweb_tpu_torch.ops.fused_topk import query_terms
    from rag_cobweb_tpu_torch.scripts._sweeps import sync

    S, D, B, k = args.slots, args.dim, args.batch, args.k
    GT_h, c_h, cf_h, valid_h, qs_h = inputs(S, D, B)
    Sp = GT_h.shape[1]
    GT = GT_h.to(dev)
    c = torch.as_tensor(c_h, device=dev)
    c_folded = torch.as_tensor(cf_h, device=dev)
    valid = torch.as_tensor(valid_h, device=dev)
    qs = [torch.as_tensor(q, device=dev) for q in qs_h]
    served_idx = FusedIndex(GT=GT, c=c, valid=valid)
    folded_idx = FusedIndex(GT=GT, c=c_folded,
                            valid=torch.ones_like(valid))
    GT32 = GT.float()
    neg = torch.tensor(float("-inf"), device=dev)

    def lib_scores(q, form):
        s = torch.matmul(query_terms(q, torch.bfloat16).float(), GT32)
        if form == "served":
            return torch.where(valid, s + c, neg)
        return s + c_folded if form == "folded" else s

    def bench(fn, iters=5):
        fn(qs[0])
        sync(dev)
        t0 = time.perf_counter()
        for i in range(iters):
            fn(qs[1 + i])
        sync(dev)
        return 1e3 * (time.perf_counter() - t0) / iters

    ms = {
        "kernel_served": bench(lambda q: fused_query_topk(served_idx, q, k)),
        "kernel_folded": bench(lambda q: fused_query_topk(folded_idx, q, k)),
    }
    for form in ("served", "folded", "stripped"):
        ms[f"library_{form}"] = bench(
            lambda q, f=form: torch.topk(lib_scores(q, f), k, dim=1))
    model = rl.fused_flat_model(B, Sp, D, dtype_bytes=2)
    roof = 1e3 * model.min_time_s()
    nbytes = (B * 2 * D * 2 + 2 * D * Sp * 2 + Sp * 4 + Sp
              + B * k * 8)
    bound = 1e3 * max(nbytes / rl.H100_HBM_BW,
                      2.0 * B * 2 * D * Sp / rl.H100_PEAK_BF16)
    tail = f"(roofline_min_ms {roof:.4f}, bound_ms {bound:.4f})"
    print(f"Sp={Sp} D={D} B={B} k={k} (ms/batch, warm, 5-run mean)")
    print(f"  served  kernel 1 (GEMM + bias + mask + pool): "
          f"{ms['kernel_served']:8.2f} {tail}")
    print(f"  folded  kernel 1 (GEMM + bias(-inf pad) + pool): "
          f"{ms['kernel_folded']:8.2f} {tail}")
    print(f"  served  library (GEMM + bias + mask + topk): "
          f"{ms['library_served']:8.2f} {tail}")
    print(f"  folded  library (GEMM + bias(-inf pad) + topk): "
          f"{ms['library_folded']:8.2f} {tail}")
    print(f"  stripped library (GEMM + topk, no epilogue): "
          f"{ms['library_stripped']:8.2f} {tail}", flush=True)

    q = qs[0]
    scores = lib_scores(q, "served")
    kth = torch.topk(scores, k, dim=1).values[:, -1]
    qq = query_terms(q, torch.bfloat16).float().abs()
    abs_gt = []

    def terms_of(qi):
        if not abs_gt:
            abs_gt.append(GT32.abs())
        return qq[qi] @ abs_gt[0] + c.abs()

    ties, pools = {}, {}
    for name, idx in (("served", served_idx), ("folded", folded_idx)):
        ids = fused_query_topk(idx, q, k)[1].long()
        ties[name] = hold_pool(ids, scores, terms_of, kth,
                               f"kernel 1 {name} pool")
        pools[name] = ids.cpu().numpy()
    print(f"  kernel 1 pools vs the library's served pool: tied ids "
          f"{ties}", flush=True)
    return {"Sp": Sp, "D": D, "B": B, "k": k, "ms": ms,
            "roofline_min_ms": roof, "bound_ms": bound,
            "tied_ids": ties, "served_ids": pools["served"]}


if __name__ == "__main__":
    main()
