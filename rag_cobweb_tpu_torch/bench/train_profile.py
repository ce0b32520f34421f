"""Where a training step's time goes on the card.

    python -m rag_cobweb_tpu_torch.bench.train_profile \
        [--tree build/train/single_tree.npz] [--steps 10]

For each trainer at the settings of ``chip_smoke.py`` phase 3i (the query
trainers on the single tree saved at ``--tree``, which phase 3i writes,
with seeded random 768-d queries and texts; VICReg and FactorVAE at
their defaults on seeded random 768-d rows): ``--steps`` steps after a
warm-up step, timed between CUDA events and traced by
``torch.profiler``.  Prints a JSON line per trainer: ms a step, the
kernels launched a step, the device's busy ms a step (the kernels' own
time) and idle share, and the operators with the most device time; for
the query trainers also the index's sentences, nodes and path depth
(the levels ``rank_scores`` gathers, forward and backward).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rag_cobweb_tpu_torch.bench import train_steps
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.device import full_f32_matmul
from rag_cobweb_tpu_torch.training import (CobwebQueryTrainer,
                                           EndToEndQueryTrainer, FactorVAE,
                                           VICRegWhitener)


def profile_steps(tr, step, n: int, top: int = 8) -> dict:
    """ms a step (CUDA events) and the profiler's account of ``n`` runs of
    ``step`` on ``tr`` after a warm-up run."""
    step.run(tr)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0.record()
        for _ in range(n):
            step.run(tr)
        t1.record()
        torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / n
    rows = prof.key_averages()
    kernels = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in kernels) / 1e3 / n
    ops = sorted((r for r in rows if r.device_type == DeviceType.CPU
                  and r.key.startswith("aten::")),
                 key=lambda r: r.self_device_time_total, reverse=True)
    return {"ms_per_step": ms,
            "kernels_per_step": sum(r.count for r in kernels) / n,
            "device_busy_ms_per_step": busy if kernels else None,
            "device_idle_share": 1 - busy / ms if kernels else None,
            "top_ops_self_device_ms_per_step": {
                r.key: r.self_device_time_total / 1e3 / n
                for r in ops[:top]},
            "top_ops_calls_per_step": {r.key: r.count / n
                                       for r in ops[:top]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default="build/train/single_tree.npz")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA device", file=sys.stderr)
        return 2
    full_f32_matmul()
    rng = np.random.default_rng(0)
    db = CobwebIndex.load(args.tree, device="cuda")
    idx = db.build_prediction_index()
    shape = {"sentences": int(idx.paths.shape[0]),
             "nodes": int(idx.inv_var_T.shape[1]),
             "path_levels": int(idx.paths.shape[1])}
    S = shape["sentences"]
    q = rng.normal(size=(16, 768)).astype(np.float32)
    gold = rng.integers(0, S, 16)
    texts = [" ".join(f"w{int(i)}" for i in rng.integers(0, 500, 6))
             for _ in range(16)]
    rows = rng.normal(size=(256, 768)).astype(np.float32)
    vae = FactorVAE(768)
    cases = {
        "query": (CobwebQueryTrainer(db, in_dim=768, hidden_dim=512,
                                     lr=1e-3),
                  train_steps.query_steps(q, gold, n=1)[0]),
        "e2e": (EndToEndQueryTrainer(db),
                train_steps.e2e_steps(texts, gold, 8192, 32, n=1)[0]),
        "vicreg": (VICRegWhitener(768),
                   train_steps.VICRegStep(rows, rows[::-1].copy())),
        "factorvae": (vae, train_steps.factorvae_steps(vae, rows, n=1)[0]),
    }
    for name, (tr, step) in cases.items():
        rec = {"trainer": name, "device": torch.cuda.get_device_name(0),
               **profile_steps(tr, step, args.steps)}
        if name in ("query", "e2e"):
            rec.update(shape)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
