"""Build rate and device idle share of the tree and forest builds.

    python -m rag_cobweb_tpu_torch.bench.build_idle [--corpus-size N]
        [--lanes K ...] [--profile-rows R]

The flagship data and whitener of ``bench/headline.py``; for each ``K`` a
``CobwebIndex`` (one tree for K = 1, else a K-lane forest) takes all but
the last ``2R`` rows (timed: inserts/s), then ``R`` rows under
``torch.profiler`` (the union of the card's kernel and copy intervals:
device busy ms per insert), then the last ``R`` rows without it (wall ms
per insert).  The idle share is the share of the build the device spends
waiting on the host: 1 - busy / wall, once with the profiled add's own
wall time (the profiler's host overhead counted as idle) and once with
the unprofiled add's (the estimate to read; the two adds see trees of
nearly the same size).  One JSON line per ``K``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel


def busy_us(prof) -> tuple:
    """(union of device event intervals in us, number of device events)
    of a finished ``torch.profiler.profile``."""
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    total, end = 0.0, float("-inf")
    for s, t in spans:
        if t <= end:
            continue
        total += t - max(s, end)
        end = t
    return total, len(spans)


def run(corpus_size=10000, queries=100, dim=768, lanes=(1, 32),
        profile_rows=256, log=None) -> list:
    log = log or (lambda *a: None)
    data = synthetic_retrieval_hard(corpus_size, queries, dim)
    whitener = PCAICAWhiteningModel.fit(
        data.corpus_embs, pca_dim=0.96, ica_max_iter=500, seed=0,
        ica_sample_size=10000)
    corpus = data.corpus_embs
    n0 = len(corpus) - 2 * profile_rows
    n1 = n0 + profile_rows
    out = []
    for K in lanes:
        db = CobwebIndex(config=TreeConfig(dim=whitener.dim_out),
                         capacity=4 * len(corpus) + 16, n_subtrees=K,
                         whitener=whitener, device="cuda")
        t0 = time.perf_counter()
        db.add_sentences([None] * n0, corpus[:n0])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            db.add_sentences([None] * profile_rows, corpus[n0:n1])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.add_sentences([None] * (len(corpus) - n1), corpus[n1:])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        busy, n_ev = busy_us(prof)
        busy_ms = busy / 1e3
        rec = {"n_subtrees": K, "rows": n0, "build_s": build_s,
               "inserts_per_s": n0 / build_s,
               "profiled_rows": profile_rows,
               "profiled_wall_ms": wall_s * 1e3,
               "profiled_inserts_per_s": profile_rows / wall_s,
               "unprofiled_wall_ms": plain_s * 1e3,
               "unprofiled_inserts_per_s": (len(corpus) - n1) / plain_s,
               "device_busy_ms": busy_ms, "device_events": n_ev,
               "device_busy_ms_per_insert": busy_ms / profile_rows,
               "idle_share_profiled": 1.0 - busy_ms / (wall_s * 1e3),
               "idle_share": 1.0 - busy_ms / (plain_s * 1e3),
               "device": torch.cuda.get_device_name(0)}
        if K == 1:
            rec["tree"] = db.tree.analyze_structure()
            rec["tree"].pop("level_counts")
            rec["tree"].pop("fanout_histogram")
        log(f"[build_idle] {json.dumps(rec)}")
        out.append(rec)
        del db
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus-size", type=int, default=10000)
    ap.add_argument("--lanes", type=int, action="append")
    ap.add_argument("--profile-rows", type=int, default=256)
    args = ap.parse_args(argv)
    for rec in run(args.corpus_size, lanes=tuple(args.lanes or (1, 32)),
                   profile_rows=args.profile_rows,
                   log=lambda *a: print(*a, file=sys.stderr, flush=True)):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
