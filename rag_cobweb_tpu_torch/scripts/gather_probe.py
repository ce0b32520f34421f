"""Row-gather rate on the card (twin of ``scripts/gather_probe.py``):
``emb[cand]`` and a squared-L2 reduction, against kernel 5
(``csrc/rerank_l2.cu``, the port of this script's Pallas kernel).

    python -m rag_cobweb_tpu_torch.scripts.gather_probe [--corpus 1000000] \\
        [--batch 1024] [--cand 512] [--dims 128,768] [--nbuf 8] [--reps 5] \\
        [--device cuda]

For each D: the JAX script's draws (``default_rng(0)``: the (S, D)
corpus, (B, D) queries, ``--reps`` distinct (B, C) candidate sets), then
one line for the plain gather (``emb[cand]``, the squared L2 to the
query summed over D) and one for kernel 5: rows/s and ms per (B, C)
gather and reduction, the mean over the distinct sets issued back to
back and one synchronize.  Kernel 5 returns the re-rank key
``-0.5 (d2 / pv + D log pv)``; at prior variance 1 that is ``-d2 / 2``,
so ``d2 = -2 key``.  Its ``d2`` is held against the plain version's on
the first set at the JAX script's tolerance (relative 1e-4 of the
largest): a mismatch raises, where the JAX script prints ``FAILED``.
``--nbuf`` (the Pallas kernel's DMA buffers) has no counterpart: kernel
5 is a warp a (query, candidate) pair, no buffers to size.  Not carried
over, as it exists only for the TPU: the XLA compile cache.
"""

import argparse
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device


def plain_d2(emb, q, cand):
    """(B, C) squared L2 of each candidate row to its query."""
    return torch.sum(torch.square(q.unsqueeze(1) - emb[cand.long()]), -1)


def kernel_d2(emb, q, cand):
    """The same through kernel 5 (its key at prior variance 1)."""
    from rag_cobweb_tpu_torch.ops import rerank
    key = rerank.rerank_lp(emb, q, cand, torch.zeros(cand.shape,
                                                     device=cand.device), 1.0)
    return -2.0 * key


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--cand", type=int, default=512)
    ap.add_argument("--dims", type=str, default="128,768")
    ap.add_argument("--nbuf", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from rag_cobweb_tpu_torch.bench import roofline as rl
    from rag_cobweb_tpu_torch.scripts._sweeps import sync

    S, B, C = args.corpus, args.batch, args.cand
    rng = np.random.default_rng(0)
    rec = {}

    def rate(fn, emb, q, cands):
        fn(emb, q, cands[0])
        sync(dev)
        t0 = time.perf_counter()
        for cand in cands:                       # distinct sets
            fn(emb, q, cand)
        sync(dev)
        return (time.perf_counter() - t0) / len(cands)

    for D in (int(d) for d in args.dims.split(",")):
        emb = torch.as_tensor(rng.normal(size=(S, D)).astype(np.float32),
                              device=dev)
        q = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32),
                            device=dev)
        cands = [torch.as_tensor(rng.integers(0, S, size=(B, C),
                                              dtype=np.int32), device=dev)
                 for _ in range(args.reps)]
        ref = plain_d2(emb, q, cands[0])
        dt = rate(plain_d2, emb, q, cands)
        r = {"plain_ms": 1e3 * dt, "plain_rows_per_s": B * C / dt}
        print(f"[gather] D={D} torch:   {B*C/dt/1e6:7.1f}M rows/s "
              f"({1e3*dt:.2f} ms / {B}x{C})", flush=True)
        out = kernel_d2(emb, q, cands[0])
        err = float((out - ref).abs().max() / ref.abs().max().clamp(
            min=1e-9))
        if not err < 1e-4:
            raise AssertionError(f"kernel 5 mismatch at D={D}: rel={err}")
        dt = rate(kernel_d2, emb, q, cands)
        print(f"[gather] D={D} kernel5: {B*C/dt/1e6:7.1f}M rows/s "
              f"({1e3*dt:.2f} ms / {B}x{C}, a warp a pair)", flush=True)
        r.update(kernel_ms=1e3 * dt, kernel_rows_per_s=B * C / dt,
                 max_rel_err=err,
                 bound_ms=1e3 * rl.gather_time_s(B * C, D * 4),
                 d2_first=ref.cpu().numpy(), kernel_d2_first=out.cpu().numpy())
        rec[D] = r
        del emb, q, cands, ref, out
    return rec


if __name__ == "__main__":
    main()
