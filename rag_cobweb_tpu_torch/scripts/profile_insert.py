"""Insert-path profile of the forest on the card (twin of
``scripts/profile_insert.py``): where a forest's round time goes.

For each lane count K in ``--ks``: a ``VForest`` of K lanes of capacity
``--cap`` is prefilled with ``--prefill`` rows a lane (64 Gaussian
clusters, ``--dim`` wide), then ``--rounds`` rounds are inserted once to
warm and once timed, on the port's own path (``VForest._rounds``: one
lockstep descent a round, every lane at once, its step a CUDA graph on
the card, at the primary budget of 16 steps).  It counts the descents
that budget cut (leaf -1; such a descent applies nothing) in the prefill
and in the timed rounds, then inserts every cut row alone on the exact
path (``VForest._insert_exact``), so that every row is inserted, and
times one single-lane exact insert cold and warm.

    python -m rag_cobweb_tpu_torch.scripts.profile_insert \\
        [--dim 128 --cap 8192 --ks 64,256] [--device cuda]

The JAX script's ``--cpu`` is ``--device cpu``.  Its "descend-only"
figure prints as ``null``: the port's descent applies each step to the
state in place (``core/tree.descend``), so a descent without its
updates is not a path the port has.  One line a K, as the JAX script's,
and ``main`` returns the records.
"""

import argparse
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--cap", type=int, default=8192)
    p.add_argument("--rounds", type=int, default=64)
    p.add_argument("--prefill", type=int, default=128,
                   help="instances per lane inserted before timing")
    p.add_argument("--ks", type=str, default="64,256")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.parallel import vforest as vf_mod
    from rag_cobweb_tpu_torch.scripts._sweeps import sync

    cfg = TreeConfig(dim=args.dim)
    D, R = args.dim, args.rounds
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(64, D)).astype(np.float32)

    def data(n):
        c = rng.integers(0, 64, size=n)
        return (centers[c] + 0.3 * rng.normal(size=(n, D))
                ).astype(np.float32)

    out = []
    for K in (int(x) for x in args.ks.split(",")):
        f = vf_mod.VForest(cfg, n_subtrees=K, capacity_per_tree=args.cap,
                           seed=1, device=dev)

        def rounds(xs):
            """The rounds of (K, n, D) rows, every lane every round ->
            (leaves (K, n), seconds)."""
            n = xs.shape[1]
            f._ensure_capacity(n)
            sync(dev)
            t0 = time.perf_counter()
            lv = f._rounds(xs, np.ones((K, n), bool), n, vf_mod._MAX_STEPS)
            sync(dev)
            f._alloc_hi += 2 * n
            return lv, time.perf_counter() - t0

        def finish(xs, lv):
            """The rows whose descent the budget cut, inserted alone on
            the exact path."""
            f._ensure_capacity(int((lv < 0).sum()))
            f._insert_exact(xs, lv < 0, lv)
            f._alloc_hi += 2 * int((lv < 0).sum())
            return lv

        # prefill, so the timed rounds descend a grown tree
        xs_p = torch.as_tensor(data(K * args.prefill).reshape(
            K, args.prefill, D), device=dev)
        lv_p, _ = rounds(xs_p)
        n_retry_p = int((lv_p < 0).sum())
        finish(xs_p, lv_p)

        xs = torch.as_tensor(data(K * R).reshape(K, R, D), device=dev)
        lv1, _ = rounds(xs)                  # warm (the graph captured)
        finish(xs, lv1)
        lv2, full_s = rounds(xs)
        n_retry = int((lv2 < 0).sum())
        finish(xs, lv2)
        inserted = int(sum((lv >= 0).sum() for lv in (lv_p, lv1, lv2)))

        # one single-lane exact insert, cold then warm
        one = np.zeros((K, 1), bool)
        one[0, 0] = True
        sink = np.full((K, 1), -1, np.int64)
        f._ensure_capacity(2)
        sync(dev)
        t0 = time.perf_counter()
        f._insert_exact(xs[:, :1], one, sink)
        sync(dev)
        retry1_cold = time.perf_counter() - t0
        one = np.roll(one, 1, axis=0) if K > 1 else one
        t0 = time.perf_counter()
        f._insert_exact(xs[:, :1], one, sink)
        sync(dev)
        retry1 = time.perf_counter() - t0

        rec = {"K": K, "cap": args.cap, "R": R, "full_ms": full_s * 1e3,
               "ms_per_round": full_s / R * 1e3,
               "inserts_per_s": K * R / full_s, "descend_only_ms": None,
               "retries_prefill": n_retry_p, "retries_timed": n_retry,
               "exact_retry_ms": retry1 * 1e3,
               "exact_retry_cold_ms": retry1_cold * 1e3,
               "rows": K * (args.prefill + 2 * R),
               "inserted_after_retries": inserted}
        out.append(rec)
        print(f"K={K:4d} cap={args.cap} R={R}: "
              f"full {full_s*1e3:8.1f} ms ({full_s/R*1e3:6.2f} ms/round, "
              f"{K*R/full_s:7.0f} ins/s) | descend-only "
              f"    null ms | retries prefill={n_retry_p} "
              f"timed={n_retry} | 1-lane exact retry {retry1*1e3:.1f} ms "
              f"(cold {retry1_cold*1e3:.0f})", flush=True)
        del f
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
