#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. card: the card's name and power limit (nvidia-smi), then every kernel
   of ``rag_cobweb_tpu_torch/csrc/`` built from source (one nvcc each,
   all at once) with the build seconds and ptxas register lines;
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes and at 1M-row scale, each timed beside its bound, its
   plain version and a library yardstick the port never calls;
3. the slice: ``rag_cobweb_tpu_torch.bench.headline`` at the flagship
   settings (c=10000, 1000 queries, 768-d, PCA 0.96, 32 lanes, k=10,
   pool 1024, batch 1024) on the card, with the kernels' launch counters
   set to 0 just before and read just after; recall@10 must be within
   0.005 of the exact scan's and every kernel must have launched;
4. one JSON line of per-kernel numbers, the nvidia-smi line, and the
   final ``{"ok": true, "device": {...}}`` line.

Without a CUDA device, or without the package beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, flops: float, peak_flops: float):
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_fused(fused_topk, B, twoD, Sp, kappa, S, reps, seed):
    """Kernel 1 against its plain version on random bf16 inputs with
    ``Sp - S`` padding rows.  Returns the record of this shape."""
    SLAB = fused_topk.SLAB
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((B, twoD // 2), generator=g, device=dev)
    qq = torch.cat([q, q * q], 1)
    if qq.shape[1] < twoD:
        qq = torch.cat([qq, torch.randn((B, twoD - qq.shape[1]),
                                        generator=g, device=dev)], 1)
    qq = qq.to(torch.bfloat16).contiguous()
    GT = (0.05 * torch.randn((twoD, Sp), generator=g, device=dev)) \
        .to(torch.bfloat16).contiguous()
    c = torch.randn((Sp,), generator=g, device=dev)
    valid = torch.arange(Sp, device=dev) < S

    ks, ki = fused_topk.slab_topk(qq, GT, c, valid, kappa)
    ps, pi = fused_topk.slab_topk_plain(qq, GT, c, valid, kappa)
    torch.cuda.synchronize()
    # the kernel leaves each slab's pool unordered; the plain one sorts it
    ks = torch.sort(ks, dim=2, descending=True).values
    fin = torch.isfinite(ps)
    if not torch.equal(fin, torch.isfinite(ks)):
        raise AssertionError("fused_topk: -inf pattern differs")
    torch.testing.assert_close(ks[fin], ps[fin], rtol=1e-3, atol=1e-3)
    err = float((ks[fin] - ps[fin]).abs().max())
    # pool ids: equal except among scores tied (within the tolerance) with
    # the slab's kappa-th score
    NS = Sp // SLAB
    mk = torch.zeros((NS, B, SLAB), dtype=torch.bool, device=dev)
    mp = torch.zeros_like(mk)
    base = (torch.arange(NS, device=dev) * SLAB).view(NS, 1, 1)
    mk.scatter_(2, (ki - base).long(), True)
    mp.scatter_(2, (pi - base).long(), True)
    diff = mk ^ mp
    n_diff = int(diff.sum())
    if n_diff:
        full = (torch.matmul(qq.float(), GT.float()) + c)
        full = torch.where(valid, full, torch.full_like(full, -math.inf))
        full = full.view(B, NS, SLAB).permute(1, 0, 2)
        kth = ps[:, :, -1:].expand_as(full)
        near = (full - kth).abs() <= 1e-3 + 1e-3 * kth.abs()
        if bool((diff & ~near).any()):
            raise AssertionError(f"fused_topk: {n_diff} pool ids differ "
                                 "beyond boundary ties")
        del full, kth, near
    del mk, mp, diff

    ms = cuda_ms(lambda: fused_topk.slab_topk(qq, GT, c, valid, kappa), reps)
    plain_ms = cuda_ms(
        lambda: fused_topk.slab_topk_plain(qq, GT, c, valid, kappa), reps)

    def library():
        s = torch.matmul(qq, GT).float() + c
        s.masked_fill_(~valid, -math.inf)
        return torch.topk(s.view(B, NS, SLAB), kappa, dim=2)

    lib_ms = cuda_ms(library, reps)
    nbytes = (qq.numel() * 2 + GT.numel() * 2 + Sp * 4 + Sp
              + NS * B * kappa * 8)
    b_ms, b_by = bound(nbytes, 2.0 * B * twoD * Sp, PEAK_BF16_FLOPS)
    log(f"[kernel] fused_topk B={B} 2D={twoD} Sp={Sp} kappa={kappa} "
        f"valid={S}: max_abs_err={err:.3g} boundary_tie_ids={n_diff} "
        f"ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_rerank(rerank, B, C, D, S, reps, seed):
    """Kernel 2 against its plain version; some candidates non-finite."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    emb = torch.randn((S, D), generator=g, device=dev)
    q = torch.randn((B, D), generator=g, device=dev)
    cand = torch.randint(0, S, (B, C), generator=g, device=dev,
                         dtype=torch.int32)
    cs = torch.randn((B, C), generator=g, device=dev)
    cs[:, -7:] = -math.inf
    pv = 1.0 / (2.0 * math.e * math.pi)

    lk = rerank.rerank_lp(emb, q, cand, cs, pv)
    lp = rerank.rerank_lp_plain(emb, q, cand, cs, pv)
    torch.cuda.synchronize()
    fin = torch.isfinite(lp)
    if not torch.equal(fin, torch.isfinite(lk)):
        raise AssertionError("rerank: -inf pattern differs")
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-5, atol=0.0)
    err = float((lk[fin] - lp[fin]).abs().max())
    tk = torch.sort(torch.topk(lk, 10, dim=1).indices, dim=1).values
    tp = torch.sort(torch.topk(lp, 10, dim=1).indices, dim=1).values
    if not torch.equal(tk, tp):
        raise AssertionError("rerank: top-10 ids differ")

    ms = cuda_ms(lambda: rerank.rerank_lp(emb, q, cand, cs, pv), reps)
    plain_ms = cuda_ms(lambda: rerank.rerank_lp_plain(emb, q, cand, cs, pv),
                       reps)
    lib_ms = cuda_ms(lambda: torch.sum(
        torch.square(q.unsqueeze(1) - emb[cand.long()]), dim=-1), reps)
    rows = int(torch.unique(cand[torch.isfinite(cs)]).numel())
    nbytes = rows * D * 4 + B * D * 4 + 3 * B * C * 4
    n_fin = int(fin.sum())
    b_ms, b_by = bound(nbytes, 3.0 * n_fin * D, PEAK_F32_FLOPS)
    log(f"[kernel] rerank_l2 B={B} C={C} D={D} S={S}: max_abs_err="
        f"{err:.3g} ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import rag_cobweb_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if Path(rag_cobweb_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: rag_cobweb_tpu_torch was imported from outside "
              "this checkout", file=sys.stderr)
        return 2
    from rag_cobweb_tpu_torch.bench import headline
    from rag_cobweb_tpu_torch.device import full_f32_matmul
    from rag_cobweb_tpu_torch.ops import _build, fused_topk, rerank

    full_f32_matmul()
    t_start = time.perf_counter()
    # -- 1. card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name}")
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[build] {len(build_logs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.2f}s")
    for kname, out in build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {kname}: {line.strip()}")

    # -- 2. kernels against their plain versions ------------------------
    main_f = check_fused(fused_topk, B=1024, twoD=496, Sp=10240, kappa=1024,
                         S=10240, reps=20, seed=0)
    check_fused(fused_topk, B=1000, twoD=250, Sp=10240, kappa=1024, S=9000,
                reps=5, seed=1)
    check_fused(fused_topk, B=1024, twoD=496, Sp=1 << 20, kappa=16,
                S=(1 << 20) - 1000, reps=3, seed=2)
    torch.cuda.empty_cache()
    main_r = check_rerank(rerank, B=1024, C=1024, D=768, S=10240, reps=20,
                          seed=3)
    check_rerank(rerank, B=1024, C=1024, D=768, S=1 << 20, reps=5, seed=4)
    torch.cuda.empty_cache()

    # -- 3. the slice -----------------------------------------------------
    counters = {"fused_topk": fused_topk.slab_topk,
                "rerank_l2": rerank.rerank_lp}
    for fn in counters.values():
        fn.launches = 0
    rec = headline.run(corpus_size=10000, queries=1000, dim=768,
                       pca_dim=0.96, k=10, batch=1024, dataset="hard",
                       n_lanes=32, rerank=1024, device="cuda",
                       log=lambda *a: log(*a))
    launches = {k: fn.launches for k, fn in counters.items()}
    log(json.dumps(rec))
    log(f"[slice] kernel launches on the main path: {launches}")
    if rec["device"] != name:
        raise AssertionError(f"headline ran on {rec['device']}")
    if not rec["recall@10"] >= rec["exact_recall@10"] - 0.005:
        raise AssertionError(
            f"recall@10 {rec['recall@10']} is more than 0.005 below the "
            f"exact scan's {rec['exact_recall@10']}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")

    # -- 4. result lines ----------------------------------------------------
    kernels = [
        dict(name="fused_topk", route="cuda",
             source="rag_cobweb_tpu_torch/csrc/fused_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:243",
             launches=launches["fused_topk"], **main_f),
        dict(name="rerank_l2", route="cuda",
             source="rag_cobweb_tpu_torch/csrc/rerank_l2.cu",
             replaces="scripts/gather_probe.py:55",
             launches=launches["rerank_l2"], **main_r),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
