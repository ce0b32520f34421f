#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero.
Each phase prints its seconds on a line of its own (``[phase] <name>
<s>s``):

1. card: the card's name and power limit (nvidia-smi), then every kernel
   of ``rag_cobweb_tpu_torch/csrc/`` built from source (one nvcc each,
   all at once) with the build seconds and ptxas register lines;
2. kernels against their plain PyTorch versions on the card, each timed
   beside its bound, its plain version and a library yardstick the port
   never calls (device time: the timed calls queue behind a sleeping
   kernel, so the host's launch time is not counted): the fused pool at
   the flagship shape, a ragged one, 1M rows (kappa 16) and 2D = 1536 (the
   query boxes carried through the ring), its pruned pool at the batch
   cell's shapes (1M rows, 2D = 256, pool 512, B = 32, 256 and 1024; the
   backstop's 605 slabs at 2D = 128, B = 1024) against its plain version
   and beside the per-slab pools it replaces there, and the serving path's
   two pools in a launch window, the re-rank at the flagship
   shape and at 1M rows, the blocked sweep on a dyadic index of the 100k
   cell's recorded shape at B = 1, 8, 32, 1024 and 4096 (exact scores: no
   id may differ; untimed), one of TS=1024 (each block split over a
   cluster) and one of D=768 (query segments carried through the ring), a
   small f32 index, and the group pool at the flagship shape (per_group 1
   and 2); kernels 1, 2 and 5 also at B=1 and B=32, the batches of the
   flagship's latency probes; kernel 5's bf16-row entry at 1M rows;
3. the flagship slice: ``rag_cobweb_tpu_torch.bench.headline`` at the
   flagship settings (c=10000, 1000 queries, 768-d, PCA 0.96, 32 lanes,
   k=10, pool 1024, batch 1024) with the kernels' launch counters set to
   0 just before the serving and read just after; recall@10 must be
   within 0.005 of the exact scan's and both kernels must have launched.
   Then, outside that window: kernel 5 held and timed on the served pools
   (the 1000 queries' exact top-1024 from kernel 1), the stream time of
   each stage of one served batch by CUDA events (upload, whitening,
   kernel 1, pool merge, kernel 5, final top-k, to host), and the group
   pool over the serving FusedIndex with the whitened queries, in its own
   counter window, held against its plain version;
3b. the blocked slice: the 100k cell (c=100000, 4096 queries, 768-d,
   PCA to 128, 64 lanes, k=10, pool 512, batch 1024) built once and
   served by the engines ``blocked_kernel``, ``blocked`` and ``fused``,
   each in its own counter window and each within 0.005 recall@10 of the
   exact scan; ``blocked_kernel`` must launch the blocked and re-rank
   kernels and not the fused one.  The blocked kernel is then held
   against its plain version on the served index with the whitened
   queries and timed there at each batch size the serving gives it
   (1, 8, 32, 1024) and at 4096; kernels 1 (kappa 512) and 2 (per_group
   2) likewise on the served fused index at B = 1, 32 and 1024;
3c. the single-tree slice: ``headline --vforest 1`` at the flagship
   settings but c=8448 (1000 queries, 768-d, PCA 0.96, one tree built on
   the card, a warm first 2048 rows then the rest, kept above
   ``blocked_threshold`` (8192) so kernel 1 serves it; k=10, pool 1024, batch
   1024), its build rate printed, served through kernels 1 and 5 (both
   counted in its window, no f32 launch), the stage split of one served
   batch as for the flagship.  Its served ids are held
   against the same pipeline in plain PyTorch on the card (equal except
   at ties the script shows as ties) and its recall@10 must be within
   0.005 of that pipeline's; its recall against the exact scan and the
   golds its 1024-row path-score pool leaves out are printed (a single
   tree's pool misses golds the forest's keeps, in the JAX package as in
   the port).  Then, outside that window: kernels 1 and 5 held and timed
   on the tree's served index and pools; ``rerank=0`` (the exact
   path-score order) served in its own window through kernel 1's f32
   entry on the tree's f32 FusedIndex, its ids held against the plain
   f32 path-score order on the card (the id at each place carries the
   plain score of that place within 1e-3 + 1e-5 of its terms) and its
   recall@10 within 0.005 of the plain order's; the entry then held
   against its plain version and timed at B = 1, 32 and 1024 (kappa 10),
   each line
   with its bound and library call (``matmul`` + ``topk``, TF32 off); the
   f32 group pool over that index, held and timed at B = 1, 8, 32 and
   1024 with its bound and library call, and the blocked kernel's f32
   entry (an f32 blocked index, ``rerank=0``), held and timed at B = 1,
   8, 32 and 1024 (its library call: 3 ``bmm`` + ``topk``, TF32 off),
   each in its own window;
3d. the scale slice (``rag_cobweb_tpu_torch.bench.scale_slice``): the
   100k cell's settings at 131072 indexed rows (data over 131072 + 9216
   rows, 4096 queries), where the backstop pool turns on: served with
   the backstop (kernel 1 twice a chunk, once counted by the backstop
   pool, kernel 5 once, no f32 launch; recall@10 within 0.005 of the
   exact scan; ids held against the same pipeline in plain PyTorch on the
   card, ``bench/probes.py``) and without; the backstop's kernel 1 held
   against its plain version on the served whitened store and timed at
   B = 1, 32 and 1024 with its bound and library call; adds of 2048, 6144
   and 1024 rows served from the pending and delta tiers on the index
   built before them (kernel 5 once more a chunk, counted by the pending
   tier; recall@10 within 0.005 of the exact scan over all rows; ids held
   against the plain pipeline over the raw rows; every added row found
   first as itself); kernel 5 held and timed at the pending tier's shape;
   add-then-query timed with the stale index and with a rebuild;
3g. the memory tools (``memory_tools_slice``, the scale slice's last hook
   step, on its build after the adds, every query served in a counter
   window each step): (a) the bf16 re-rank store, served through kernel
   5's bf16 entry (once a chunk, no f32 launch), recall@10 at least the
   f32 store's - 0.02, the store's bytes halved, the entry held against
   its plain version on the served pools and timed there beside the f32
   entry on the same pools; (b)
   ``compress_stats()``, recall@10 at least (a)'s - 0.01 and top-10
   overlap at least 0.9; (c) ``offload_state()``: device memory falls by
   the state's bytes, the ids equal (b)'s and the state stays on the
   host; 1024 added rows each found first as itself; (d) a 32-lane
   forest of phase 3e's first 4096 rows built on the host
   (``build_device="cpu"``), promoted to the card and served by the fused
   engine, its ids held against the plain pipeline, its structure
   compared with a card build of the same rows; where a lane differs,
   ``bench/build_divergence.py``'s case (a) prints each differing lane's
   first parted decision, and fails unless each is a tie or a near tie
   (within the float32 rounding of its terms) and its recorded card build
   equals the CUDA-graph build;
3e. the small-forest slice: ``configs/synthetic_scale_5k.json``'s corpus
   (c=5000, 750 queries, 768-d), PCA+ICA at 0.96, a 32-lane forest below
   ``blocked_threshold``, k=10, pool 1024, batch 1024, served by the
   small-forest engine round-robin and content-routed (absorb_depth 24),
   each in its own counter window: kernel 5 launched and no other kernel,
   ids held against the engine's plain pipeline on the card
   (``probes.small_forest_plain``: equal except at ties it shows),
   recall@10 within 0.005 of that pipeline's; its build rate, ms/query at
   B = 750, 1 and 32, the golds the pool leaves out, the stage split of
   one served batch, kernel 5 held and timed on the served pools; then 64
   rows added and each found first as itself, and (round-robin) a forest
   of 8191 rows served once at the branch's edge;
3f. the query API (``query_api``), inside the hooks of phases 3, 3c and
   3e on the indexes they build (the flagship forest, the single tree,
   the content-routed small forest), no new build:
   ``predict_fast(k=10, return_ids=True)`` on every query in its own
   counter window (kernels 1 and 5 on the two fused-engine indexes,
   kernel 5 alone on the small forest), its ids equal to ``query_ids``';
   ``predict(k=10)`` (the packed beam, width 64; lane-fair over the 32
   lanes, or each query's 8 nearest when content-routed) in its own
   window, where no kernel may launch; both timed at the full batch, B=1
   and B=32 and their recall@10 printed beside the exact scan's; the beam
   engine alone timed beside its bound; ``save`` into ``build/query_api/``
   and ``load(device="cuda")``, whose ``predict_fast`` and ``predict``
   ids must equal the original's; ``load(device="cpu")``, whose
   ``predict`` ids on the first 32 queries must equal the card's but at
   ties it shows.  On the single tree also ``predict_fast(tie_noise=
   True)``, held against the plain f32 path-score order (the order
   ``rerank=0`` serves; noise of 1e-6 moves only ties), and
   ``set_weight_schedule`` exponential (base 0.5) and linear (1.0 to
   0.25), each served at pool 1024 with its recall@10 and the golds its
   pool leaves out printed, then ``set_level_weights`` of the defaults,
   whose ids must equal the first serving's;
3h. the last single-chip modules (``whitener_forests``,
   ``classifier_slice``, ``blocked_rerank_hold``, ``grouped_pool_probe``):
   (a) the flagship settings on a ZCA whitener and on a PCA+ZCA whitener
   (0.96), each fitted on the host (its time printed), built on the card
   (inserts/s) with the tree as wide as the rows (768, so kernel 1
   sweeps 2D = 1536), served by the fused engine in a counter window
   (kernels 1 and 5 must launch, no f32 entry), its ids held against the
   same pipeline in plain PyTorch (``probes.plain_check``) and its
   recall@10 within 0.005 of that pipeline's; recall@10 beside the exact
   scan's, ms/query at B = 1000, 1 and 32, the stage split of one batch,
   kernel 1 held and timed on the served index and kernel 5 on the served
   pools; each index saved (its whitener pickle under the JAX class name)
   and loaded back on the card, serving the same ids; on the ZCA forest
   ``vforest_beam_topk`` at B=32 held against a host copy; (b) the
   labeled classifier (16 Gaussian classes at 768-d, 1024 rows fitted on
   the card, 512 held out): inserts/s, ``predict_probs`` with and without
   ``max_nodes`` within 1e-5 of its host copy, held-out accuracy at least
   0.9; (c) ``blocked_query_topk_rerank`` on phase 3b's served blocked
   index at B=1024 (run inside 3b's hook), timed and held against a host
   copy on 64 queries, and ``grouped_pool_topk`` on random (256, 2^20)
   scores: each score its id's, overlap with the exact top-512 above
   0.995, timed beside ``torch.topk``;
3i. training on the card (``training_slice``, after phase 3c, on its
   single tree and the flagship's 1000 raw queries, gold rows and 10 000
   raw corpus rows): (a) ``CobwebQueryTrainer`` (768 -> the tree's width,
   hidden 512, batch 16, lr 1e-3, 2 epochs), (b) ``EndToEndQueryTrainer``
   at the JAX defaults (vocab 8192, d_model 128, 2 layers, max_len 32,
   hidden 512, lr 1e-3, 2 epochs) on texts whose words name each gold row
   and its tree cluster among filler words, every 10th empty, (c)
   ``VICRegWhitener`` (768 -> 128, hidden 1024, lr 1e-3, batch 256, 2
   epochs), (d) ``FactorVAE`` (z_dim 392, hidden 1024, gamma 10, lr 1e-4,
   batch 256, 2 epochs).  Each: its first 5 steps on the card and on a
   host copy in lockstep (the same parameters and optimizer state before
   each step, the same batches and draws; the tree saved and loaded on
   the host) held by ``bench/train_steps.hold`` (the CPU tests'
   tolerances), ms a step and steps/s (CUDA events, after a warm-up step)
   beside the nvidia-smi line, the first and last epoch's loss; it fails
   unless (a) and (b)'s last epoch loss is below the first, (b)'s encoder
   gradient norms are finite and positive, (a)'s recall@10 does not fall,
   (c)'s covariance term and (d)'s recon_mse fall;
3k. the reference's benchmark harness and the encoder (before 3j): (a)
   ``bench/harness.BenchmarkRunner("synthetic")``, run by the twin of
   ``scripts/synthetic_benchmark.py`` (``rag_cobweb_tpu_torch.scripts.
   synthetic_benchmark.main`` with the JAX script's arguments, writing
   under ``build/harness/``), at the reference's flagship QQP size (c=10000, 1000 queries, 768-d, top_k 10, seed 42; at
   its default 7500 the single tree serves below ``blocked_threshold`` by
   path scores, without kernel 1) through the "extra" matrix, in one
   counter window: flat IP and L2 on the card, the native flat IP and
   HNSW rows (raw and PCA+ICA), the beam and fast rows of one whitened
   single tree; Annoy skips.  It fails unless every row but Annoy is
   there, kernels 1 and 5 launched, the fast row's ids equal the same
   pipeline in plain PyTorch (``probes.plain_check``) but at ties, the
   card's flat IP ids equal the native library's but at ties (exact
   scores within 1e-5), and the results file parses back
   (``report.parse_results_file``) to each row's recall@10 (5e-5) and
   latency (5e-4); (b) a BERT at bert-base-uncased's widths (768, 12
   layers, 12 heads, 3072, vocab 30522, 512 positions; random weights
   from seed 0, the hash tokenizer, max_length 128): 64 texts held
   against a host copy (rtol 1e-4, atol 1e-5, TF32 off); 10000 texts
   (the sample corpora's sentences shuffled, 1-3 words substituted)
   encoded, texts/s and tokens/s by CUDA events; PCA+ICA (0.96) fitted
   on them; ``encode_whiten_insert`` into a 32-lane forest, the
   whitening on the card; 1000 queries (corpus texts less one word)
   served by ``query_ids`` in a counter window (kernels 1 and 5 must
   launch), recall@10 within 0.005 of the exact scan over the same
   whitened rows; (c) (b)'s stages in a ``utils.profiling.PhaseTimer``,
   one served batch traced by ``utils.profiling.trace`` into
   ``build/trace/`` (the trace must hold its annotation; whether
   ``key_averages()`` shows device time for kernels 1 and 5 is printed);
   (d) ``bench/roofline.product_path_model`` of phase 3's served batch
   against its measured time, and the card's row-gather rate
   (``emb[idx]``, 1024 x 512 distinct rows of 1M, D = 128 and 768).
   Kernels 1 and 5 are then held and timed at (a)'s and (b)'s served
   shapes;
3l. the last modules (after 3k): (a) ``families_phase``: RoBERTa, GPT-2
   and T5's encoder at the published base widths of roberta-base, gpt2
   and t5-base (``torch_encoder.PUBLISHED``; random weights from seed 0,
   the hash tokenizer at each vocabulary, max_length 128), each through
   (b)'s steps: 64 texts held against a host copy (rtol 1e-4, atol
   1e-5), 10000 texts encoded (texts/s, tokens/s), PCA+ICA (0.96) fused
   on the card, ``encode_whiten_insert`` into a 32-lane forest, 1000
   queries served in a counter window (kernels 1 and 5 must launch, no
   f32 entry), recall@10 within 0.005 of the exact scan's, the ids held
   by ``probes.plain_check``; kernels 1 and 5 then held and timed on each
   forest's index and served pools; (b) ``twins_phase``: the twins of
   ``train_query_encoder``, ``train_factorvae`` and
   ``compare_whitening`` at small sizes on the card, each returned
   trainer then held for 2 steps against a host copy
   (``bench/train_steps.hold``, phase 3i's rule), and
   ``case_study``, ``visualize_tree`` (DOT files under ``build/twins/``)
   and ``run_experiments --dry-run`` (its commands name the twins) once
   each;
3j. multi-device on ``torch.distributed`` (``multichip_phase``, last):
   ``min(cards, 4)`` ranks, a card each over NCCL, or with one card 2
   ranks on it over gloo (the card count, world size, backend, the rank
   to card map printed), started by ``bench/multichip.spawn`` on inputs
   phases 3 and 3c wrote
   to ``build/multichip/``, each rank's checks in
   ``bench/multichip_slice``: (a) ``TPFusedPredictionIndex`` over the
   flagship's served bf16 index with its raw store, 1000 queries at pool
   1024 in a counter window (kernels 1 and 5 must launch on every rank),
   recall@10 within 0.005 of the exact scan's, ids equal to the same
   pipeline in plain PyTorch on one card but at ties, the batch timed at
   B = 1000, 1, 32 and split into sweep and pool, re-rank and merge;
   kernels 1 and 5 held and timed at rank 0's slab and pools; (b)
   ``TPPredictionIndex`` over phase 3c's tree with its raw store, ids
   equal to the exact re-rank of the shards' pools but at ties, its
   all-reduce timed; (c) a 32-lane ``MeshVForest`` over the flagship's
   whitened rows, every lane slot for slot equal to one card's
   ``VForest(n_subtrees=32)`` (a lane that differs must show a near tie
   in a recorded build, ``bench/build_divergence``), ids equal but at
   ties, inserts/s by rank; (d) 5 ``fit_dp`` steps of
   ``CobwebQueryTrainer`` at the global batch 16 a rank held in lockstep
   against single-process steps on a host copy, a step and its gradient
   all-reduce timed, then an epoch of ``fit_dp``; (e) ``CobwebForest`` on
   the first 1024 rows: every row finds itself, each shard's leaves equal
   a single-process build of its rows; (f) 2 ``fit_dp`` steps of
   ``EndToEndQueryTrainer`` held likewise;
3m. the experiment scripts' twins (``rag_cobweb_tpu_torch/scripts/``,
   each called as a user calls it, ``main([...])`` with ``--device
   cuda``, in its own counter window; after 3j): (a)
   ``caches_phase``: phase 3d's rows (131072 + 9216, 4096 queries, its
   whitener) written as a raw cache in ``bench/million``'s layout under
   ``build/experiments/`` (git ignores it); ``derive_caches`` (the
   whitened cache, within one float32 ulp of ``transform_torch`` of the
   same rows; a 65536-row raw slice, bit-equal); ``exact_scan`` at
   131072 rows (ids equal to a one-shot ``matmul`` + ``topk`` but at ties
   it shows); ``incremental_benchmark --cache --size 50000`` (default
   100k; 1000 adds, 64 lanes: self-hit@10 1.0, stale served, the
   overflow moved to the delta tier, kernels 1 and 5 launched, kernel 5
   also for the pending tier); (b) ``sweeps_phase``: ``pool_sweep_10k``,
   ``pcadim_sweep_10k`` (c=10000, 768-d, 32 lanes), ``tuning_sweep
   --corpus-size 10000 --pools 0,64,256,1024 --widths 2,8`` (kernels 1
   and 5 in each window; every recall@10 served at a pool of 1024 or
   more within 0.005 of the exact scan over the same whitened rows) and
   ``beam_diag --corpus-size 2500`` (default 10000; the beam engine, no
   kernel: its window must show none); (c) ``scale_phase``:
   ``scale_benchmark --vforest 64 --max-size 10000 --checkpoints
   5000,10000`` and one tree to 1024 rows (``--checkpoints 512,1024``;
   it builds at ~80 inserts/s): every
   row at every checkpoint, the flat exact row's recall@10 equal to a
   host flat scan's; (d) ``roofline_benchmark.rows`` inside phase 3b's
   hook on its served 100k index at B = 32 and 1024 (the blocked kernel
   launched; no roofline share above 1.05); (e) ``profile_insert`` at its
   defaults (D = 128, cap 8192, K = 64 and 256; every row inserted after
   the cut descents are retried);
3n. the twins of the reference's TPU probes (``probes_phase``; last,
   after 3m; each called as a user calls it with ``--device cuda``, in
   its own counter window; the cuts in ``PROBE_CUTS``): (a)
   ``rerank_stage_probe.stages`` on phase 3's served flagship forest
   (its four rows; ``query_ids``' ids equal its stages' and the plain
   pipeline's, ``probes.plain_check``, but at ties); (b)
   ``raw_rerank_probe.probe`` with phase 3's whitener (a raw-mode
   32-lane forest, ``rerank=0`` pools of 256, 1024, 4096 through kernel
   1's f32 entry, the raw re-rank through kernel 5); (c)
   ``transfer_probe`` (every transfer exact), ``probe_fused_epilogue`` at
   1M slots (kernel 1's served and folded pools equal the library's
   served pool but at ties), ``beam_microbench`` at its defaults,
   ``gather_probe`` on 262144 rows (default 1M; kernel 5 within 1e-4
   relative of ``emb[idx]`` + sum); (d) ``pipeline_probe`` on the first
   131072 rows of 3m (a)'s whitened cache (default 1M), 512 lanes, B =
   1024, pool 1024: kernel 2 must launch in its grouped arm, its served
   ids equal the plain pipeline's but at ties; (e) ``ingress_rehearsal
   --subset-size 400 --target-size 60`` (default 2000 / 200): the
   benchmark twin cold in a subprocess exits 0 and the rows parsed from
   its results file equal those it printed; (f) ``run_8m`` on the same
   cache at 131072 rows in two halves of 65536 (default 8M): kernel 1
   (sweep and backstop) and kernel 5's bf16-row entry launch, the served
   ids equal the plain pipeline's on the composed index in sentence
   order but at ties, recall@10 within one query of the exact scan's
   over the same bf16 whitened store (the scan over the f32 rows
   printed beside it);
4. one JSON line of per-kernel numbers, a row per CUDA kernel entry
   (kernel 1 at the flagship shape, with its single-tree record under
   ``single_tree``; kernel 5 on the flagship's served pools, likewise; the
   blocked kernel on the 100k served index at B=1024, replacing TPU
   kernels 3 and 4, whose bodies are one, with its record at B=4096 under
   ``B4096``; the group pool at the flagship shape; the f32 entries of
   kernel 1 (B=1024, with ``B1``, ``B32``), of the group pool and of the
   blocked kernel (B=1024, with ``B1``, ``B8``, ``B32``) on the single
   tree's f32 indexes; kernel 1's backstop record under ``backstop``,
   kernel 5's at the pending tier under ``pending``, on the small
   forest's served pools under ``small_forest``, its content-routed record
   inside that, and its bf16-row entry under ``bf16``: phase 3g's served
   pools, with 1M random rows under ``M1``; kernels 1 and 5 on phase 3h's
   ZCA forest under ``zca``, its PCA+ZCA twin inside that; kernels 1 and
   5 of phase 3j's fused TP engine under ``tp``, their launches summed
   over the ranks and by rank; kernels 1 and 5 on phase 3k's harness
   tree under ``harness`` and its encoder forest under ``encoder``, and
   on phase 3l's forests under ``families``, by name; the launches of
   kernels 1, 5 and the blocked kernel in phase 3m's windows under
   ``twins``, and of kernels 1 (both entries), 2 and 5 (both entries)
   in phase 3n's windows under ``probes``, by twin), the nvidia-smi
   line, and the
   final
   ``{"ok": true, "device": {...}}`` line.

Without a CUDA device, or without the package beside it, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

try:    # the card's published peaks, from their one source
    from rag_cobweb_tpu_torch.bench.roofline import (
        H100_HBM_BW as PEAK_BYTES_PER_S,
        H100_PEAK_BF16 as PEAK_BF16_FLOPS,
        H100_PEAK_F32 as PEAK_F32_FLOPS)
except ImportError:     # the script alone: main() reports it and exits 2
    PEAK_BYTES_PER_S = PEAK_BF16_FLOPS = PEAK_F32_FLOPS = None


def log(*a):
    print(*a, flush=True)


def phase_done(name: str, t0: float) -> float:
    """Print phase ``name``'s seconds since ``t0`` on a line of its own;
    returns the time now, the next phase's start."""
    t = time.perf_counter()
    log(f"[phase] {name} {t - t0:.1f}s")
    return t


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).  The
    calls queue behind a sleeping kernel, so the device runs them back to
    back and the host's time to launch them is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e5 * reps))   # ~0.2 ms a call of host lead
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


def peak_flops(t: torch.Tensor) -> float:
    """The card's peak rate for products of ``t``'s type (bf16 on the
    tensor cores; f32 on the CUDA cores, TF32 off)."""
    return PEAK_BF16_FLOPS if t.dtype == torch.bfloat16 else PEAK_F32_FLOPS


def fused_inputs(B, twoD, Sp, S, seed):
    """Random bf16 sweep inputs with ``Sp - S`` padding rows."""
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
    return qq, GT, c, torch.arange(Sp, device=dev) < S


def check_fused(fused_topk, qq, GT, c, valid, kappa, reps, label="",
                real=False):
    """Kernel 1 against its plain version: scores within 1e-3 + 1e-3
    |score|, ids equal except among scores tied within that with a slab's
    kappa-th.  ``real``: a served index, whose scores are small sums of
    large terms that cancel; the tolerance adds 1e-5 of each score's
    terms, sum_d |qq_d GT_dt| + |c_t| (float32 sums taken in another
    order), and the record gives the largest error in units of the terms.
    Returns the record of this shape."""
    SLAB = fused_topk.SLAB
    dev = qq.device
    B, twoD = qq.shape
    Sp = GT.shape[1]
    S = int(valid.sum())
    NS = Sp // SLAB
    ks, ki = fused_topk.slab_topk(qq, GT, c, valid, kappa)
    ps, pi = fused_topk.slab_topk_plain(qq, GT, c, valid, kappa)
    torch.cuda.synchronize()
    base = (torch.arange(NS, device=dev) * SLAB).view(NS, 1, 1)
    terms = None
    if real:
        terms = (torch.matmul(qq.float().abs(), GT.float().abs())
                 + c.abs()).view(B, NS, SLAB).permute(1, 0, 2)
    # the kernel leaves each slab's pool unordered; the plain one sorts it
    ks = torch.sort(ks, dim=2, descending=True).values
    fin = torch.isfinite(ps)
    if not torch.equal(fin, torch.isfinite(ks)):
        raise AssertionError("fused_topk: -inf pattern differs")
    d = (ks - ps).abs()[fin]
    tol = 1e-3 + 1e-3 * ps.abs()[fin]
    rec_terms = {}
    if real:
        at = terms.gather(2, (pi - base).long())[fin]
        tol = tol + 1e-5 * at
        rec_terms = {"max_err_over_terms": float((d / at).max())}
    if bool((d > tol).any()):
        raise AssertionError(f"fused_topk{label}: scores differ beyond the "
                             f"tolerance (max {float(d.max()):.3g})")
    err = float(d.max())
    # pool ids: equal except among scores tied (within the tolerance) with
    # the slab's kappa-th score
    mk = torch.zeros((NS, B, SLAB), dtype=torch.bool, device=dev)
    mp = torch.zeros_like(mk)
    mk.scatter_(2, (ki - base).long(), True)
    mp.scatter_(2, (pi - base).long(), True)
    diff = mk ^ mp
    n_diff = int(diff.sum())
    if n_diff:
        full = (torch.matmul(qq.float(), GT.float()) + c)
        full = torch.where(valid, full, torch.full_like(full, -math.inf))
        full = full.view(B, NS, SLAB).permute(1, 0, 2)
        kth = ps[:, :, -1:].expand_as(full)
        band = 1e-3 + 1e-3 * kth.abs()
        if real:
            band = band + 1e-5 * terms
        near = (full - kth).abs() <= band
        if bool((diff & ~near).any()):
            raise AssertionError(f"fused_topk: {n_diff} pool ids differ "
                                 "beyond boundary ties")
        del full, kth, near, band
    del mk, mp, diff, ks, ki, ps, pi, terms

    ms = cuda_ms(lambda: fused_topk.slab_topk(qq, GT, c, valid, kappa), reps)
    plain_ms = cuda_ms(
        lambda: fused_topk.slab_topk_plain(qq, GT, c, valid, kappa), reps)

    def library():
        s = torch.matmul(qq, GT).float() + c
        s.masked_fill_(~valid, -math.inf)
        return torch.topk(s.view(B, NS, SLAB), kappa, dim=2)

    lib_ms = cuda_ms(library, reps)
    esz = GT.element_size()
    nbytes = (qq.numel() * esz + GT.numel() * esz + Sp * 4 + Sp
              + NS * B * kappa * 8)
    b_ms, b_by = bound(nbytes, 2.0 * B * twoD * Sp, peak_flops(GT))
    log(f"[kernel] fused_topk{label} B={B} 2D={twoD} Sp={Sp} "
        f"kappa={kappa} valid={S} {GT.dtype}: max_abs_err={err:.3g} "
        f"{rec_terms} boundary_tie_ids={n_diff} ms={ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            **rec_terms}


def check_pruned(fused_topk, qq, GT, c, valid, k, reps, label=""):
    """Kernel 1's pruned pool (``pool_sweep`` and ``pool_select``, the
    pruned path forced) against its plain version (``pruned_sweep_plain``
    then ``pruned_select``, 128 queries at a time): scores within 1e-3 +
    1e-3 |score|, ids equal except among scores tied within that with the
    k-th; and against the per-slab kernel's pools on the same card, which
    share its sweep: the same top k, scores and ids, bit for bit (both
    break ties to the lower id).  Timed beside the per-slab path
    (``merge(*slab_topk(...))``), the function's bound (one sweep, a pool
    of k out), the plain version and ``matmul`` + ``topk``; the survivors a
    query (``probes.pool_survivors``).  Returns the record."""
    from rag_cobweb_tpu_torch.bench import probes
    SLAB = fused_topk.SLAB
    B, twoD = qq.shape
    Sp = GT.shape[1]
    kappa = min(k, SLAB)
    cap = fused_topk.prune_cap(k)
    step = 128

    def pruned():
        # the path's device work: its passes and final selection (the
        # overflow count's read to the host left out)
        return fused_topk.pruned_select(fused_topk.pruned_sweep(
            qq, GT, c, valid, k))

    def per_slab():
        return fused_topk.merge(*fused_topk.slab_topk(qq, GT, c, valid,
                                                      kappa), k)

    def plain(r0):
        return fused_topk.pruned_select(fused_topk.pruned_sweep_plain(
            qq[r0:r0 + step], GT, c, valid, k, cap))[0]

    pend = fused_topk.pool_sweep(qq, GT, c, valid, k, pruned=True)
    ts, ti = fused_topk.pool_select(pend)
    surv = probes.pool_survivors(pend)
    del pend
    err, n_diff = 0.0, 0
    for r0 in range(0, B, step):
        ps, pi = plain(r0)
        gs, gi = ts[r0:r0 + step], ti[r0:r0 + step]
        fin = torch.isfinite(ps)
        if not torch.equal(fin, torch.isfinite(gs)):
            raise AssertionError(f"pruned pool{label} B={B}: -inf pattern "
                                 "differs from the plain version's")
        d = (gs - ps).abs()[fin]
        if bool((d > 1e-3 + 1e-3 * ps.abs()[fin]).any()):
            raise AssertionError(f"pruned pool{label} B={B}: scores differ "
                                 "from the plain version's beyond the "
                                 f"tolerance (max {float(d.max()):.3g})")
        err = max(err, float(d.max()) if d.numel() else 0.0)
        n = len(ps)
        mk = torch.zeros((n, Sp + 1), dtype=torch.bool, device=qq.device)
        mp = torch.zeros_like(mk)
        mk.scatter_(1, torch.where(gi < 0, Sp, gi).long(), True)
        mp.scatter_(1, torch.where(pi < 0, Sp, pi).long(), True)
        diff = (mk ^ mp)[:, :Sp]
        if bool(diff.any()):
            full = fused_topk.slab_scores_plain(
                qq[r0:r0 + step], GT, c, valid, -math.inf).reshape(n, Sp)
            kth = ps[:, -1:]
            near = (full - kth).abs() <= 1e-3 + 1e-3 * kth.abs()
            if bool((diff & ~near).any()):
                raise AssertionError(f"pruned pool{label} B={B}: ids differ "
                                     "from the plain version's beyond ties "
                                     "with the k-th")
            n_diff += int(diff.sum())
            del full, kth, near
        del mk, mp, diff, ps, pi
    ks, ki = fused_topk.slab_topk(qq, GT, c, valid, kappa)
    rs, ri = fused_topk.select_keys(ks.permute(1, 0, 2).reshape(B, -1),
                                    ki.permute(1, 0, 2).reshape(B, -1), k)
    del ks, ki
    torch.cuda.synchronize()
    if not (torch.equal(ts, rs) and torch.equal(ti, ri)):
        raise AssertionError(f"pruned pool{label} B={B}: not the per-slab "
                             "pools' top k")
    del rs, ri, ts, ti
    torch.cuda.empty_cache()
    ms = cuda_ms(pruned, reps)
    slab_ms = cuda_ms(per_slab, reps)
    plain_ms = cuda_ms(lambda: [plain(r0) for r0 in range(0, B, step)], 1,
                       warmup=0)

    def library():
        s = torch.matmul(qq, GT).float() + c
        s.masked_fill_(~valid, -math.inf)
        return torch.topk(s, k, dim=1)

    lib_ms = cuda_ms(library, reps)
    esz = GT.element_size()
    nbytes = (qq.numel() * esz + GT.numel() * esz + Sp * 4 + Sp
              + B * k * 8)
    b_ms, b_by = bound(nbytes, 2.0 * B * twoD * Sp, peak_flops(GT))
    rec = {"ms": ms, "per_slab_ms": slab_ms, "bound_ms": b_ms,
           "bound_by": b_by, "plain_ms": plain_ms, "library_ms": lib_ms,
           "max_abs_err": err, "boundary_tie_ids": n_diff,
           "survivors": surv}
    log(f"[kernel] pruned pool{label} B={B} 2D={twoD} Sp={Sp} k={k} "
        f"NS={Sp // SLAB} {GT.dtype}: " + json.dumps(rec))
    torch.cuda.empty_cache()
    return rec


def pruned_window(sweep_in, store_in, k, probes):
    """The serving path's two pools of ``k`` (the batch cell's: 512, at B =
    1024) in a launch window of their own:
    ``index.fused_query_topk`` over a fused index of ``sweep_in``'s GT and
    ``index.backstop_topk`` over ``store_in``'s as a whitened store in GT
    layout.  Both take the pruned path by the shape rule (two counts on
    ``launch.slab_topk_pruned``) and no query overflows.  Returns the
    window's counters."""
    from types import SimpleNamespace
    from rag_cobweb_tpu_torch.core import index as index_mod
    qq, GT, c, valid = sweep_in
    sq, W, wc, wvalid = store_in
    fidx = SimpleNamespace(GT=GT, c=c, valid=valid)
    q = qq[:, :GT.shape[0] // 2].float()
    probes.zero_counters()
    index_mod.fused_query_topk(fidx, q, k)
    index_mod.backstop_topk(W, -wc, sq.float(), k, int(wvalid.sum()), True)
    torch.cuda.synchronize()
    w = probes.read_counters()
    if (w["fused_topk_pruned"], w["pool_overflow"]) != (2, 0):
        raise AssertionError(f"pruned window: {w}")
    log(f"[kernel] pruned pool window (the serving path's pools, B={len(q)}): "
        f"{json.dumps(w)}")
    return w


def rerank_inputs(B, C, D, S, seed, dtype=torch.float32):
    """Random store (in ``dtype``), queries and uniform candidates, the
    last 7 -inf."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    emb = torch.randn((S, D), generator=g, device=dev).to(dtype)
    q = torch.randn((B, D), generator=g, device=dev)
    cand = torch.randint(0, S, (B, C), generator=g, device=dev,
                         dtype=torch.int32)
    cs = torch.randn((B, C), generator=g, device=dev)
    cs[:, -7:] = -math.inf
    return emb, q, cand, cs


def check_rerank(rerank, emb, q, cand, cs, reps, label="",
                 pv=1.0 / (2.0 * math.e * math.pi)):
    """Kernel 5 against its plain version (its f32 or bf16-row entry, by
    the store's dtype; the library call gathers the rows upcast).
    Returns the record of this shape."""
    (S, D), (B, C) = emb.shape, cand.shape
    lk = rerank.rerank_lp(emb, q, cand, cs, pv)
    lp = rerank.rerank_lp_plain(emb, q, cand, cs, pv)
    torch.cuda.synchronize()
    fin = torch.isfinite(lp)
    if not torch.equal(fin, torch.isfinite(lk)):
        raise AssertionError("rerank: -inf pattern differs")
    # float32 sums in another order: 1e-5 of the larger term of
    # lp = -0.5 d2 / pv - 0.5 D log pv (on real pools the two nearly cancel)
    err_all = (lk[fin] - lp[fin]).abs()
    tol = 1e-5 * (lp[fin].abs() + 0.5 * D * abs(math.log(pv)))
    if bool((err_all > tol).any()):
        raise AssertionError(f"rerank{label}: lp differs beyond 1e-5 of its "
                             f"terms (max {float(err_all.max()):.3g})")
    err = float(err_all.max())
    del err_all, tol
    tk = torch.sort(torch.topk(lk, 10, dim=1).indices, dim=1).values
    tp = torch.sort(torch.topk(lp, 10, dim=1).indices, dim=1).values
    if not torch.equal(tk, tp):
        raise AssertionError("rerank: top-10 ids differ")
    del lk, lp

    ms = cuda_ms(lambda: rerank.rerank_lp(emb, q, cand, cs, pv), reps)
    plain_ms = cuda_ms(lambda: rerank.rerank_lp_plain(emb, q, cand, cs, pv),
                       reps)
    lib_ms = cuda_ms(lambda: torch.sum(
        torch.square(q.unsqueeze(1) - emb[cand.long()].float()), dim=-1),
        reps)
    rows = int(torch.unique(cand[torch.isfinite(cs)]).numel())
    nbytes = rows * D * emb.element_size() + B * D * 4 + 3 * B * C * 4
    n_fin = int(fin.sum())
    b_ms, b_by = bound(nbytes, 3.0 * n_fin * D, PEAK_F32_FLOPS)
    log(f"[kernel] rerank_l2{label} B={B} C={C} D={D} S={S} {emb.dtype} "
        f"distinct_rows={rows}: max_abs_err={err:.3g} ms={ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def hold(name, ks, ki, ps, pi, full, tol):
    """Kernel candidates ``ks``/``ki`` (G, B, K) against the plain
    version's ``ps``/``pi``, both in round order: scores within ``tol``
    elementwise, and every kernel id (local to its row of ``full``, the
    plain version's (G, B, W) scores) carries the kernel's score within
    ``tol`` there (NEG rounds aside).  So ids differ only among rows tied
    within the tolerance.  Returns (max_abs_err, ids that differ)."""
    err = (ks - ps).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: scores differ beyond the tolerance "
                             f"(max {float(err.max()):.3g})")
    at = full.gather(2, ki.long())
    real = ks > -1e38       # exhausted rounds (NEG) name the lowest row
    if bool((((at - ks).abs() > tol) & real).any()):
        raise AssertionError(f"{name}: a kernel id does not carry its score")
    return float(err.max()), int((ki != pi).sum())


def dyadic_blocked(B, NB, M, D, TS, S_last, dtype, seed):
    """A random blocked index whose scores are exact in float32 in any
    order: q, movt, ivt and const are small multiples of powers of two, so
    the kernel and the plain version round the same nlp (a multiple of
    2^-11 below 256) to the W dtype (with arbitrary data, a sum that lands
    next to a bf16 rounding boundary may round the other way in one of
    them), and W holds ~12 weights of 0.5 or 1 per slot, as a path does,
    so every score fits float32's 24 bits: equal scores tie exactly and go
    to the lower slot in both.  The last block has ``S_last`` valid
    slots."""
    from rag_cobweb_tpu_torch.core.index import BlockedIndex
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    q = (ints(-8, 9, (B, D)) / 8).to(dtype)
    W = ints(1, 3, (NB, M, TS)) / 2
    W = torch.where(torch.rand((NB, M, TS), generator=g, device=dev)
                    < 12.0 / M, W, torch.zeros_like(W))
    valid = torch.ones((NB, TS), dtype=torch.bool, device=dev)
    valid[-1, S_last:] = False
    bidx = BlockedIndex(
        ivt_b=(ints(1, 17, (NB, M, D)) / 16).to(dtype),
        movt_b=(ints(-8, 9, (NB, M, D)) / 16).to(dtype),
        const_b=ints(-64, 65, (NB, M)) / 4,
        W=W.to(dtype).contiguous(), valid=valid,
        sid_of_slot=torch.arange(NB * TS, device=dev,
                                 dtype=torch.int32).view(NB, TS))
    return q, bidx


def check_blocked(bt, q, bidx, kk, reps, real=False):
    """The blocked sweep kernel against its plain version.  Tolerance
    1e-3 + 1e-3 |score|, and on a dyadic index no id may differ; on real
    data plus, per (block, query), one bf16 step of every nlp term
    weighted by |W| (the f32 sums run in another order and may round to
    the neighbouring bf16 value), or on an f32 index 1e-5 of the nlp
    terms weighted by |W| (f32 sums of cancelling terms in another
    order).  Returns the record of this shape."""
    qd, q2 = bt._queries(bidx, q)
    B, D = qd.shape
    NB, M, _ = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    ks, ki = bt._block_candidates(qd, q2, bidx, kk)
    ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid, kk)
    full, nlp = bt.block_scores_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                      bidx.const_b, bidx.W, bidx.valid)
    torch.cuda.synchronize()
    tol = 1e-3 + 1e-3 * ps.abs()
    if real and bidx.W.dtype == torch.bfloat16:
        step = torch.matmul(nlp.abs() * 2.0 ** -7, bidx.W.float().abs())
        tol = tol + step.amax(dim=2, keepdim=True)
        del step
    elif real:
        tn = (torch.einsum("bd,smd->sbm", qd.float().abs(),
                           bidx.movt_b.float().abs())
              + 0.5 * torch.einsum("bd,smd->sbm", q2.float().abs(),
                                   bidx.ivt_b.float().abs())
              + bidx.const_b.abs().unsqueeze(1))
        step = torch.matmul(tn * 1e-5, bidx.W.float().abs())
        tol = tol + step.amax(dim=2, keepdim=True)
        del tn, step
    err, n_diff = hold(f"blocked_topk B={B}", ks, ki, ps, pi, full, tol)
    del full, nlp, tol
    if n_diff and not real:
        raise AssertionError(f"blocked_topk B={B}: {n_diff} ids differ on "
                             "a dyadic index")
    esz = bidx.W.element_size()
    lo = bidx.W.dtype == torch.bfloat16
    nbytes = (2 * B * D * esz + 2 * NB * M * D * esz + NB * M * 4
              + NB * M * TS * esz + NB * TS + NB * B * kk * 8)
    flops = 2.0 * B * NB * M * (2 * D + TS)
    b_ms, b_by = bound(nbytes, flops,
                       PEAK_BF16_FLOPS if lo else PEAK_F32_FLOPS)
    if reps == 0:
        log(f"[kernel] blocked_topk B={B} NB={NB} M={M} D={D} TS={TS} "
            f"kk={kk} {bidx.W.dtype}: max_abs_err={err:.3g} "
            f"boundary_tie_ids={n_diff}")
        return None

    def library():
        qT = qd.T.unsqueeze(0).expand(NB, D, B)
        q2T = q2.T.unsqueeze(0).expand(NB, D, B)
        nl = (torch.bmm(bidx.movt_b, qT) - 0.5 * torch.bmm(bidx.ivt_b, q2T)
              + bidx.const_b.unsqueeze(2).to(qd.dtype))
        sc = torch.bmm(bidx.W.transpose(1, 2), nl).float()
        sc.masked_fill_(~bidx.valid.unsqueeze(2), bt.NEG)
        return torch.topk(sc, kk, dim=1)

    ms = cuda_ms(lambda: bt._block_candidates(qd, q2, bidx, kk), reps)
    plain_ms = cuda_ms(lambda: bt.block_candidates_plain(
        qd, q2, bidx.ivt_b, bidx.movt_b, bidx.const_b, bidx.W, bidx.valid,
        kk), reps)
    lib_ms = cuda_ms(library, reps)
    log(f"[kernel] blocked_topk{' (served index)' if real else ''} B={B} "
        f"NB={NB} M={M} D={D} TS={TS} kk={kk} {bidx.W.dtype}: "
        f"max_abs_err={err:.3g} boundary_tie_ids={n_diff} "
        f"ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def group_inputs(B, twoD, Sp, S, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((B, twoD // 2), generator=g, device=dev)
    qq = torch.cat([q, q * q], 1).to(torch.bfloat16).contiguous()
    GT = (0.05 * torch.randn((twoD, Sp), generator=g, device=dev)) \
        .to(torch.bfloat16).contiguous()
    c = torch.randn((Sp,), generator=g, device=dev)
    return qq, GT, c, torch.arange(Sp, device=dev) < S


def check_group(fused_topk, qq, GT, c, valid, per_group, reps, label="",
                real=False):
    """The group-pool entry against its plain version: f32 sums in another
    order only, so scores within 1e-3 + 1e-3 |score| (``real``: plus 1e-5
    of each score's terms, as in ``check_fused``) and ids equal except
    among rows tied within that.  Returns the record of this shape."""
    SLAB, NG, GROUP = fused_topk.SLAB, fused_topk.NG, fused_topk.GROUP
    B, twoD = qq.shape
    Sp = GT.shape[1]
    NS = Sp // SLAB
    ks, ki = fused_topk.slab_group_topk(qq, GT, c, valid, per_group)
    ps, pi = fused_topk.slab_group_topk_plain(qq, GT, c, valid, per_group)
    full = fused_topk.slab_scores_plain(qq, GT, c, valid, fused_topk.NEG) \
        .permute(1, 0, 2)
    torch.cuda.synchronize()
    base = (torch.arange(NS, device=qq.device) * SLAB).view(NS, 1, 1)
    tol = 1e-3 + 1e-3 * ps.abs()
    if real:
        terms = (torch.matmul(qq.float().abs(), GT.float().abs())
                 + c.abs()).view(B, NS, SLAB).permute(1, 0, 2)
        tol = tol + 1e-5 * terms.gather(2, (pi - base).long())
        del terms
    err, n_diff = hold(f"fused_group_topk per_group={per_group}", ks,
                       ki - base, ps, pi - base, full, tol)
    del full, tol
    KO = per_group * NG
    esz = GT.element_size()
    nbytes = (qq.numel() * esz + GT.numel() * esz + Sp * 4 + Sp
              + NS * B * KO * 8)
    b_ms, b_by = bound(nbytes, 2.0 * B * twoD * Sp, peak_flops(GT))
    if reps == 0:
        log(f"[kernel] fused_group_topk{label} B={B} 2D={twoD} "
            f"Sp={Sp} per_group={per_group}: max_abs_err={err:.3g} "
            f"boundary_tie_ids={n_diff}")
        return None

    def library():
        s = torch.matmul(qq, GT).float() + c
        s.masked_fill_(~valid, fused_topk.NEG)
        return torch.topk(s.view(B, NS * NG, GROUP), per_group, dim=2)

    ms = cuda_ms(lambda: fused_topk.slab_group_topk(qq, GT, c, valid,
                                                    per_group), reps)
    plain_ms = cuda_ms(lambda: fused_topk.slab_group_topk_plain(
        qq, GT, c, valid, per_group), reps)
    lib_ms = cuda_ms(library, reps)
    log(f"[kernel] fused_group_topk{label} B={B} 2D={twoD} Sp={Sp} "
        f"per_group={per_group} {GT.dtype}: max_abs_err={err:.3g} "
        "boundary_tie_ids="
        f"{n_diff} ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def plain_path_order(db, qw, served: np.ndarray, targets,
                     k: int = 10) -> dict:
    """``rerank=0``'s served ids (kernel 1's f32 entry over the f32
    FusedIndex) against the plain f32 path-score order of the same index
    on the card: the served id at each place must carry the plain score of
    that place within 1e-3 + 1e-5 of its terms (so ids differ only among
    ties).  Returns the record."""
    from rag_cobweb_tpu_torch.ops import fused_topk
    f32 = db._fused_index(exact=True)
    qq = fused_topk.query_terms(qw, torch.float32)
    full = fused_topk.slab_scores_plain(qq, f32.GT, f32.c, f32.valid,
                                        float("-inf")).reshape(len(qq), -1)
    terms = torch.matmul(qq.abs(), f32.GT.abs()) + f32.c.abs()
    top, plain = torch.topk(full, k, dim=1)
    got = torch.as_tensor(served, device=full.device).long()
    at = full.gather(1, got)
    tol = 1e-3 + 1e-5 * terms.gather(1, got)
    if bool(((at - top).abs() > tol).any()):
        raise AssertionError(
            "rerank=0: a served id does not carry the plain path-score "
            f"order's score at its place (max off {(at - top).abs().max()})")
    plain = plain.cpu().numpy()
    return {"plain_recall@10": float(np.mean(
        [t in row for t, row in zip(targets, plain)])),
        "queries_differing_from_plain": int(
            (plain != served).any(axis=1).sum())}


def median_ms(fn, reps: int = 7) -> float:
    """Median host ms of ``fn()`` (which returns host data, so the device
    is done) over ``reps`` calls, after one warm call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def recall10(ids, targets) -> float:
    return float(np.mean([t in row[:10] for t, row in zip(targets, ids)]))


def query_api(db, data, zero, read, what: str, out_dir: Path,
              card: bool = True) -> dict:
    """Phase 3f on a served index ``db`` (``data``: its raw corpus,
    queries and golds): ``predict_fast(k=10)`` on every query in its own
    counter window, its ids equal to ``query_ids``'; ``predict(k=10)``
    (beam width 64) in its own window, where no kernel may launch; both
    timed at the full batch (ms/query), at B=1 (ms) and B=32 (ms/query);
    the beam engine alone timed against its bound; ``save`` into
    ``out_dir`` and ``load`` on the same device, whose ``predict_fast``
    and ``predict`` ids must equal the original's; ``load`` on the host,
    whose ``predict`` ids on the first 32 queries must equal the card's
    but at ties it shows (``probes.hold_beam``).  ``card`` False (a host
    rehearsal) leaves out the counter checks.  Returns the record."""
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import hold_beam
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    q, targets = data.query_embs, data.target_ids
    rec = {"B": len(q)}

    def fast(x):
        return db.predict_fast(x, k=10, return_ids=True, is_embedding=True)

    def beam(x):
        return db.predict(x, k=10, return_ids=True, is_embedding=True)

    zero()
    ids_fast = fast(q)
    rec["fast_window"] = read()
    if ids_fast != to_host(db.query_ids(q, 10)).tolist():
        raise AssertionError(f"{what}: predict_fast and query_ids differ")
    zero()
    ids_beam = beam(q)
    rec["predict_window"] = read()
    if card and any(rec["predict_window"].values()):
        raise AssertionError(f"{what}: predict launched a kernel: "
                             f"{rec['predict_window']}")
    for name, fn, ids in (("predict", beam, ids_beam),
                          ("predict_fast", fast, ids_fast)):
        rec[name] = {
            "recall@10": recall10(ids, targets),
            "ms/query": median_ms(lambda: fn(q), reps=3) / len(q),
            "B1_ms": median_ms(lambda: fn(q[:1])),
            "B32_ms/query": median_ms(lambda: fn(q[:32])) / 32}
    rec["predict"]["overlap_with_predict_fast"] = float(np.mean(
        [len(set(a) & set(b)) / max(len(b), 1)
         for a, b in zip(ids_beam, ids_fast)]))
    # the beam engine alone, on the whitened batch, against its bound: the
    # pack, the queries and the ids moved once, and 2 x 2D flops for each
    # scored candidate slot (queries x lanes x levels x budget)
    qw = db._as_query_batch(q, True)[0]
    bidx = db._beam_index()
    W = 64
    if db.forest is not None:
        F = db.forest
        depth = -(-max(F._beam_depth, 1) // 4) * 4
        L = min(F.K, 8) if F.routing == "content" else F.K
        C = min(16 * max(1, -(-4 * W // 16)), W * 16)

        def engine():
            return to_host(F.beam_topk(qw, 10, beam_width=W))
    else:
        depth = -(-max(db.max_depth, 1) // 4) * 4
        L, C = 1, min(64 * max(1, -(-4 * W // 64)), W * 16)

        def engine():
            return to_host(index_mod.beam_query_ids(
                bidx, qw, 10, beam_width=W, max_depth=depth))
    twoD = bidx.pack.shape[1]
    flops = 2.0 * twoD * len(q) * L * depth * C
    nbytes = (bidx.pack.numel() * bidx.pack.element_size()
              + 4 * bidx.num_nodes + 4 * qw.numel() + 8 * 10 * len(q))
    b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOPS)
    rec["beam"] = {"ms": median_ms(engine, reps=3), "bound_ms": b_ms,
                   "bound_by": b_by, "gathered_GB": 1e-9 * 4 * twoD * len(q)
                   * L * depth * C, "lanes": L, "levels": depth,
                   "budget": C}
    # save, then load on the card and on the host
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / f"{what.replace(' ', '_')}.npz")
    db.save(path)
    loaded = CobwebIndex.load(path, device=db.device)
    if loaded.predict_fast(q, k=10, return_ids=True,
                           is_embedding=True) != ids_fast:
        raise AssertionError(f"{what}: the loaded copy's predict_fast ids "
                             "differ")
    if loaded.predict(q, k=10, return_ids=True,
                      is_embedding=True) != ids_beam:
        raise AssertionError(f"{what}: the loaded copy's predict ids "
                             "differ")
    del loaded
    host = CobwebIndex.load(path, device="cpu")
    rec["host_hold"] = hold_beam(db, q[:32], ids_beam[:32], host.predict(
        q[:32], k=10, return_ids=True, is_embedding=True))
    return rec


def log_query_api(what: str, rec: dict, exact_recall: float) -> None:
    for name in ("predict", "predict_fast"):
        r = rec[name]
        log(f"[api] {what} {name}: recall@10 {r['recall@10']} (exact scan "
            f"{exact_recall}); {r['ms/query']:.6f} ms/query at B={rec['B']}, "
            f"B=1 {r['B1_ms']:.4f} ms, B=32 {r['B32_ms/query']:.6f} "
            "ms/query" + (f"; overlap with predict_fast "
                          f"{r['overlap_with_predict_fast']:.4f}"
                          if name == "predict" else ""))
    log(f"[api] {what} beam engine alone: {json.dumps(rec['beam'])}")
    log(f"[api] {what} windows: predict_fast {rec['fast_window']}, predict "
        f"{rec['predict_window']}; host copy vs card: "
        f"{json.dumps(rec['host_hold'])}")


def single_tree_api(db, data, qw, ids0, served, zero, read, out_dir: Path,
                    pool: int = 1024, card: bool = True) -> dict:
    """Phase 3f on the single tree ``db``: ``query_api``; then
    ``predict_fast(tie_noise=True)`` held against the plain f32
    path-score order of the f32 FusedIndex (``plain_path_order``; ``qw``
    the whitened queries, ``ids0`` the ids ``rerank=0`` served); then each
    level-weight schedule served at pool ``pool`` with its recall@10 and
    the golds its pool leaves out (``probes.golds_outside_pool``; the
    served ids are not held against the plain pipeline here: a schedule
    that all but drops the deep levels ties whole subtrees at the pool's
    edge, where kernel 1 and ``torch.topk`` may keep different members);
    then the default weights restored, whose ids must equal ``served``,
    the first serving's at that pool.  Returns the records."""
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import golds_outside_pool
    from rag_cobweb_tpu_torch.core.index import DEFAULT_LEVEL_WEIGHTS
    q = data.query_embs
    out = {"api": query_api(db, data, zero, read, "single tree", out_dir,
                            card=card)}
    noisy = np.asarray(db.predict_fast(q, k=10, return_ids=True,
                                       is_embedding=True, tie_noise=True))
    out["tie_noise"] = plain_path_order(db, qw, noisy, data.target_ids)
    out["tie_noise"]["queries_differing_from_rerank0"] = int(
        (noisy != ids0).any(axis=1).sum())
    for kind, kw in (("exponential", dict(base=0.5)),
                     ("linear", dict(start=1.0, end=0.25))):
        db.set_weight_schedule(kind, **kw)
        ids = to_host(db.query_ids(q, 10, rerank=pool))
        out[f"schedule {kind}"] = {
            "weights": db.get_level_weights(),
            "recall@10": recall10(ids, data.target_ids),
            "golds_outside_pool": golds_outside_pool(db, q, data.target_ids,
                                                     pool)}
    db.set_level_weights(DEFAULT_LEVEL_WEIGHTS)
    if not np.array_equal(to_host(db.query_ids(q, 10, rerank=pool)),
                          served):
        raise AssertionError("the single tree's ids after the schedule was "
                             "restored differ from its first serving's")
    return out


def single_tree_slice(headline, zero, read, windows, launches,
                      name: str, out_dir: Path, corpus_size=8448,
                      queries=1000, dim=768, device="cuda") -> tuple:
    """Phase 3c: the single tree at the flagship settings, built on the
    card and served through kernels 1 and 5 in a counter window; then the
    kernels held and timed on its indexes and the f32 entries, each in its
    own window.  Returns (the headline record, the kernel records)."""
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import plain_check, stage_split
    from rag_cobweb_tpu_torch.core.index import fused_query_topk
    from rag_cobweb_tpu_torch.ops import blocked_topk, fused_topk, rerank
    single = {}

    def single_hook(event, engine, db, data):
        if event == "start":
            zero()
            return
        windows["single"] = read()
        single["db"], single["data"] = db, data    # phase 3i trains on it
        served = to_host(db.query_ids(data.query_embs, 10, rerank=1024))
        single["plain"] = plain_check(db, data.query_embs, served, 10,
                                      1024, 0, 1024, data.corpus_embs,
                                      data.target_ids)
        single["plain"]["served_recall@10"] = float(np.mean(
            [t in row for t, row in zip(data.target_ids, served)]))
        single["split"] = stage_split(db, data.query_embs, 10, 1024)
        raw = torch.as_tensor(data.query_embs[:1024], device=device)
        qw = db.whitener.transform_torch(raw)
        # kernels 1 and 5 on the single tree's served index and pools
        fidx = db._fused_index()
        single["fused"] = check_fused(
            fused_topk, fused_topk.query_terms(qw, fidx.GT.dtype), fidx.GT,
            fidx.c, fidx.valid, 1024, reps=10, label=" (single tree)",
            real=True)
        cs, cand = fused_query_topk(fidx, qw, 1024)
        single["rerank"] = check_rerank(
            rerank, db._emb_device(), raw, cand.to(torch.int32).contiguous(),
            cs.contiguous(), reps=10, label=" (single tree, served pools)",
            pv=float(db.cfg.prior_var))
        del cs, cand
        # rerank=0: the exact path-score order, through kernel 1's f32
        # entry on the f32 FusedIndex, in its own window
        zero()
        ids0 = to_host(db.query_ids(data.query_embs, 10, rerank=0))
        windows["single_f32"] = read()
        single["recall_rerank0"] = float(np.mean(
            [t in row for t, row in zip(data.target_ids, ids0)]))
        single["rerank0_plain"] = plain_path_order(db, qw, ids0,
                                                   data.target_ids)
        f32 = db._fused_index(exact=True)
        if f32.GT.dtype != torch.float32:
            raise AssertionError(f"rerank=0 served a {f32.GT.dtype} index")
        qq = fused_topk.query_terms(qw, torch.float32)
        for B, reps in ((1, 50), (32, 50), (1024, 10)):
            single[f"fused_f32 B={B}"] = check_fused(
                fused_topk, qq[:B], f32.GT, f32.c, f32.valid, 10, reps,
                label=" f32 (single tree, rerank=0)", real=True)
        # the f32 group pool over the same index, its own window
        zero()
        fused_topk.fused_group_topk(f32, qw, 1024, per_group=2)
        torch.cuda.synchronize()
        windows["single_group_f32"] = read()
        single["group_f32"] = check_group(
            fused_topk, qq, f32.GT, f32.c, f32.valid, 2, reps=10,
            label=" f32 (single tree)", real=True)
        for B in (1, 8, 32):
            single[f"group_f32 B={B}"] = check_group(
                fused_topk, qq[:B], f32.GT, f32.c, f32.valid, 2, reps=50,
                label=" f32 (single tree)", real=True)
        # the blocked kernel over an f32 blocked index (blocked_dtype
        # float32) at rerank=0: its f32 entry, its own window
        db.use_fused, db.use_pallas, db.pallas_threshold = False, True, 0
        db.blocked_dtype, db._blocked = "float32", None
        zero()
        to_host(db.query_ids(data.query_embs, 10, rerank=0))
        windows["single_blocked_f32"] = read()
        bf32 = db._blocked_index()
        for B, reps in ((1, 50), (8, 50), (32, 50), (1024, 10)):
            single[f"blocked_f32 B={B}"] = check_blocked(
                blocked_topk, qw[:B], bf32, 10, reps=reps, real=True)
        db.use_fused, db.use_pallas = True, False
        # 3f: the query API on the tree, then tie noise and the schedules
        single.update(single_tree_api(db, data, qw, ids0, served, zero, read,
                                      out_dir))

    rec1 = headline.run(corpus_size=corpus_size, queries=queries, dim=dim,
                        pca_dim=0.96, k=10, batch=1024, dataset="hard",
                        n_lanes=1, rerank=1024, device=device,
                        log=lambda *a: log(*a), hook=single_hook)[0]
    log(json.dumps(rec1))
    log(f"[single] tree build {rec1['build_inserts_per_s']:.1f} inserts/s "
        f"after the first 2048 rows ({rec1['compile_warmup_s']:.1f}s); "
        f"{rec1['build_total_s']:.1f}s in all")
    for w in ("single", "single_f32", "single_group_f32",
              "single_blocked_f32"):
        log(f"[single] {w} launches: {windows[w]}")
    log(f"[single] recall@10 at rerank=0 (path-score order): "
        f"{single['recall_rerank0']}; the plain f32 order on the card: "
        f"{single['rerank0_plain']}")
    if abs(single["recall_rerank0"]
           - single["rerank0_plain"]["plain_recall@10"]) > 0.005:
        raise AssertionError(
            f"single tree, rerank=0: recall@10 {single['recall_rerank0']} "
            "is more than 0.005 from the plain path-score order's")
    log("[single] stage split, stream ms between CUDA events, one batch: "
        + json.dumps(single["split"]) + f" | headline batch ms "
        f"{rec1['value'] * single['split']['B']:.4f}")
    log(f"[single] served vs the plain pipeline on the card and vs the "
        f"exact scan: {single['plain']} exact_recall@10="
        f"{rec1['exact_recall@10']}")
    if rec1["n_subtrees"] != 1 or rec1["device"] != name:
        raise AssertionError(f"the single-tree headline ran as {rec1}")
    # the gate: serving through the kernels loses nothing against the
    # single tree's own pipeline in plain PyTorch (its pool of the top
    # 1024 path scores leaves golds out, in the JAX package too, so the
    # exact scan's recall is not the single tree's)
    if not rec1["recall@10"] >= single["plain"]["plain_recall@10"] - 0.005:
        raise AssertionError(
            f"single tree: recall@10 {rec1['recall@10']} is more than "
            f"0.005 below its plain pipeline's "
            f"{single['plain']['plain_recall@10']}")
    ws = windows["single"]
    if not (ws["fused_topk"] > 0 and ws["rerank_l2"] > 0
            and ws["fused_topk_f32"] == 0):
        raise AssertionError(f"the single tree did not serve through "
                             f"kernels 1 and 5: {ws}")
    checks = (("single_f32", "fused_topk_f32"),
              ("single_group_f32", "fused_group_topk_f32"),
              ("single_blocked_f32", "blocked_topk_f32"))
    for w, k in checks:
        if windows[w][k] <= 0:
            raise AssertionError(f"{k} never launched in its window: "
                                 f"{windows[w]}")
        launches[k] = windows[w][k]
    for name in ("fused_f32", "group_f32", "blocked_f32"):
        log(f"[single] {name} ms / bound ms / library ms by batch size: "
            + json.dumps({k: [r["ms"], r["bound_ms"], r["library_ms"]]
                          for k, r in single.items()
                          if k.startswith(name + " ")}))
    # 3f on the single tree
    api = single["api"]
    log_query_api("single tree", api, rec1["exact_recall@10"])
    fast_window(api["fast_window"], "single tree")
    log(f"[api] single tree predict_fast(tie_noise=True) against the plain "
        f"f32 path-score order: {single['tie_noise']}")
    for kind in ("exponential", "linear"):
        log(f"[api] single tree schedule {kind}: "
            + json.dumps(single[f"schedule {kind}"]))
    return rec1, single


def step_ms(step, reps: int, card: bool) -> float:
    """Mean ms of one training step over ``reps`` steps after one warm-up
    step: between CUDA events on the card (the device waits on the host
    between launches, so this is the step as the trainer runs it), the
    host clock on the CPU."""
    step()
    if not card:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        step()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def query_texts(db, gold, seed: int = 0) -> list:
    """A text per query whose words determine its gold row: the row's id
    and its tree cluster (its leaf's parent node), among 2-6 filler words
    in random order; every 10th text empty."""
    rng = np.random.default_rng(seed)
    parent = db.tree.host_arrays()["parent"]
    filler = [f"w{i}" for i in range(48)]
    out = []
    for i, g in enumerate(gold):
        if i % 10 == 9:
            out.append("")
            continue
        leaf = db.leaf_of_sentence[int(g)]
        words = [f"concept{int(parent[leaf])}", f"row{int(g)}"] + list(
            rng.choice(filler, size=int(rng.integers(2, 7))))
        rng.shuffle(words)
        out.append(" ".join(words))
    return out


def training_slice(db, data, out_dir: Path, smi: str, device="cuda",
                   epochs=3, whitener_epochs=2, reps=20, rows=None) -> dict:
    """Phase 3i: single-device training on phase 3c's single tree ``db``
    (its raw queries and gold rows in ``data``).  (a) ``CobwebQueryTrainer``
    (768 -> the tree's width, hidden 512, batch 16, lr 1e-3), (b)
    ``EndToEndQueryTrainer`` at the JAX defaults on texts made from the
    gold rows (``query_texts``), (c) ``VICRegWhitener`` and (d)
    ``FactorVAE`` at their defaults on the corpus rows.  Each: its first 5
    steps on ``device`` against a host copy (``bench/train_steps.hold``;
    the query trainers' index is ``db`` saved and loaded on the host), ms
    a step after a warm-up step, then its ``fit`` from fresh parameters
    and the checks of the module docstring; a line each (``smi``: the
    card's nvidia-smi line).  ``rows``: the rows (c) and (d) train on
    (None: ``data``'s corpus rows)."""
    from rag_cobweb_tpu_torch.bench import train_steps
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.training import (CobwebQueryTrainer,
                                               EndToEndQueryTrainer,
                                               FactorVAE, VICRegWhitener)
    card = torch.device(device).type == "cuda"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    db.save(str(out_dir / "single_tree.npz"))
    host_db = CobwebIndex.load(str(out_dir / "single_tree.npz"),
                               device="cpu")
    out = {"host_copy_s": time.perf_counter() - t0}
    q, gold = data.query_embs, data.target_ids
    rows = data.corpus_embs if rows is None else rows
    texts = query_texts(db, gold)
    rng = np.random.default_rng(0)
    views_b = (rows + 0.1 * rows.std(0) * rng.normal(size=rows.shape)
               ).astype(np.float32)

    def fail(what, rec):
        raise AssertionError(f"3i {what}: {rec}")

    def one(name, make, steps_of, fit):
        t = time.perf_counter()
        tr = make()
        rec = {"hold": train_steps.hold(
            tr, train_steps.host_copy(tr, host_db), steps_of(tr))}
        if not rec["hold"]["ok"]:
            fail(f"({name}) card against host", rec["hold"])
        tr = make()
        timed = steps_of(tr)
        rec["ms_per_step"] = step_ms(
            lambda: [s.run(tr) for s in timed[:1]], reps, card)
        rec["steps_per_s"] = 1e3 / rec["ms_per_step"]
        rec.update(fit(make()))
        rec["s"] = time.perf_counter() - t
        out[name] = rec
        log_trainer(name, rec, smi)

    def query_fit(tr):
        before = tr.evaluate(q, gold)
        losses = tr.fit(q, gold, epochs=epochs, batch_size=16)
        after = tr.evaluate(q, gold)
        if not (losses[-1] < losses[0]
                and after["recall@10"] >= before["recall@10"]):
            fail("(a) training", (losses, before, after))
        return {"losses": losses, "before": before, "after": after}

    one("query", lambda: CobwebQueryTrainer(db, in_dim=q.shape[1],
                                            hidden_dim=512, lr=1e-3),
        lambda tr: train_steps.query_steps(q, gold), query_fit)

    def e2e_fit(tr):
        losses, norms = tr.fit(texts, gold, epochs=epochs, batch_size=16)
        if not (losses[-1] < losses[0] and all(
                math.isfinite(n) and n > 0 for n in norms)):
            fail("(b) training", (losses, norms))
        return {"losses": losses, "encoder_grad_norms": norms,
                "empty_texts": sum(not t for t in texts)}

    one("e2e", lambda: EndToEndQueryTrainer(db),
        lambda tr: train_steps.e2e_steps(texts, gold, tr.vocab_size,
                                         tr.max_len), e2e_fit)

    def vicreg_fit(tr):
        hist = tr.fit(rows, epochs=whitener_epochs, batch_size=256)
        if not hist[-1]["covariance"] < hist[0]["covariance"]:
            fail("(c) training", hist)
        return {"history": hist}

    one("vicreg", lambda: VICRegWhitener(rows.shape[1], device=device),
        lambda tr: train_steps.vicreg_steps(rows, views_b), vicreg_fit)

    def vae_fit(tr):
        hist = tr.fit(rows, epochs=whitener_epochs, batch_size=256)
        if not hist[-1]["recon_mse"] < hist[0]["recon_mse"]:
            fail("(d) training", hist)
        return {"history": [{k: v for k, v in h.items() if k != "top_pairs"}
                            for h in hist]}

    one("factorvae", lambda: FactorVAE(rows.shape[1], device=device),
        lambda tr: train_steps.factorvae_steps(tr, rows), vae_fit)
    return out


def log_trainer(name: str, r: dict, smi: str) -> None:
    """Phase 3i's line of one trainer: its hold, ms a step, its losses."""
    seq = ([h[{"vicreg": "loss", "factorvae": "vae"}[name]]
            for h in r["history"]] if "history" in r else r["losses"])
    h = r["hold"]
    log(f"[train] {name}: {r['ms_per_step']:.4f} ms/step, "
        f"{r['steps_per_s']:.1f} steps/s ({smi}); first / last epoch loss "
        f"{seq[0]:.6f} / {seq[-1]:.6f}; card vs host over {h['steps']} "
        f"lockstep steps: worst metric rel {h['worst_metric_rel']:.3g}, "
        f"worst gradient rel {h['worst_grad_rel']:.3g}, worst parameter "
        f"excess {h['worst_param_excess']:.3g}, unsettled / parted entries "
        f"{h['unsettled']} / {h['parted']} of {h['entries']}; "
        f"{r['s']:.1f}s")


def log_training(rec: dict) -> None:
    """Phase 3i's summary line."""
    log(f"[train] query recall before / after: "
        f"{json.dumps(rec['query']['before'])} / "
        f"{json.dumps(rec['query']['after'])}; e2e encoder grad norms "
        f"{rec['e2e']['encoder_grad_norms']}; vicreg covariance "
        f"{[h['covariance'] for h in rec['vicreg']['history']]}; factorvae "
        f"recon_mse {[h['recon_mse'] for h in rec['factorvae']['history']]}"
        f"; host copy of the tree {rec['host_copy_s']:.1f}s")


def fast_window(w: dict, what: str) -> None:
    """``predict_fast`` on a fused-engine index: kernels 1 and 5."""
    if not (w["fused_topk"] > 0 and w["rerank_l2"] > 0):
        raise AssertionError(f"{what}: predict_fast did not serve through "
                             f"kernels 1 and 5: {w}")


SMALL_FOREST_WINDOW = ("fused_topk", "fused_group_topk", "blocked_topk",
                       "fused_topk_f32", "fused_group_topk_f32",
                       "blocked_topk_f32", "backstop", "pending")


def small_forest_window(w: dict, what: str) -> None:
    """A counter window of the small-forest engine: kernel 5 launched,
    nothing else (no kernel 1, 2 or 3/4 entry, no tier)."""
    if w["rerank_l2"] <= 0 or any(w[k] for k in SMALL_FOREST_WINDOW):
        raise AssertionError(f"{what}: the small-forest engine did not "
                             f"serve through kernel 5 alone: {w}")


def small_forest_slice(headline, zero, read, out_dir: Path, device="cuda",
                       corpus_size=5000, queries=750, dim=768,
                       threshold=8192, card=True) -> dict:
    """Phase 3e: ``configs/synthetic_scale_5k.json``'s corpus (c=5000,
    750 queries, 768-d) whitened by PCA+ICA at 0.96 into a 32-lane forest,
    below ``blocked_threshold``, so the small-forest engine serves it (k=10,
    pool 1024, batch 1024): once round-robin, once content-routed
    (absorb_depth 24), each in its own counter window and held against
    its plain pipeline on the card (``probes.small_forest_plain``).  Then,
    outside the windows: the stage split of one served batch, kernel 5
    held and timed on the served pools; an add of 64 new rows and a query
    that must find each first as itself; and (round-robin) a forest of
    ``threshold - 1`` rows served once at the branch's edge.  ``card``
    False leaves out what only the card has (the kernels' launch counts,
    CUDA events, kernel 5 itself): a host rehearsal at small sizes.
    Returns a record per routing."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import (small_forest_plain,
                                                   small_forest_split)
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import rerank
    from rag_cobweb_tpu_torch.parallel.vforest import _vforest_query
    def window(w, what):
        if card:
            small_forest_window(w, what)

    out = {}
    for routing in ("round_robin", "content"):
        sf = out[routing] = {}

        def hook(event, engine, db, data, sf=sf, routing=routing):
            if event == "start":
                zero()
                return
            sf["window"] = read()
            if len(db) >= db.blocked_threshold or engine != "small_forest":
                raise AssertionError(f"{len(db)} rows served as {engine}")
            served = to_host(db.query_ids(data.query_embs, 10, rerank=1024))
            sf["plain"] = small_forest_plain(
                db, data.query_embs, served, 10, 1024, 1024,
                data.corpus_embs, data.target_ids)
            sf["plain"]["served_recall@10"] = float(np.mean(
                [t in row for t, row in zip(data.target_ids, served)]))
            sf["max_depth"] = db.forest.max_depth()
            sf["lane_rows"] = [min(map(len, db.forest._leaf_of_local)),
                               max(map(len, db.forest._leaf_of_local))]
            if card:
                sf["split"] = small_forest_split(db, data.query_embs, 10,
                                                 1024)
                raw = torch.as_tensor(data.query_embs, device=device)
                cs, cand = _vforest_query(db.forest.build_index(),
                                          db.whitener.transform_torch(raw),
                                          1024)
                sf["rerank"] = check_rerank(
                    rerank, db._emb_device(), raw,
                    cand.to(torch.int32).contiguous(), cs.contiguous(),
                    reps=10, label=f" (small forest, {routing}, served "
                    "pools)", pv=float(db.cfg.prior_var))
                del cs, cand
            if routing == "content":
                # 3f: the query API, predict over each query's 8 nearest
                # of the 32 lanes
                sf["api"] = query_api(db, data, zero, read,
                                      "small forest content", out_dir,
                                      card=card)
                window(sf["api"]["fast_window"], "content predict_fast")
            # 64 new rows added, then a query: each comes back first as
            # itself (the add drops the stacked index; the query rebuilds)
            new = synthetic_retrieval_hard(64, 1, dim, seed=7).corpus_embs
            n0 = len(db)
            db.add_sentences([None] * len(new), new)
            zero()
            got = to_host(db.query_ids(new, 1))
            sf["add_window"] = read()
            window(sf["add_window"], f"{routing} add")
            if not np.array_equal(got[:, 0], np.arange(n0, n0 + len(new))):
                raise AssertionError(f"{routing}: an added row did not come "
                                     f"back first as itself: {got[:, 0]}")
            if routing != "round_robin":
                return
            # the branch's edge: threshold - 1 rows, served once
            d2 = synthetic_retrieval_hard(threshold - 1, queries, dim,
                                          seed=1)
            db2 = CobwebIndex(config=TreeConfig(dim=db.whitener.dim_out),
                              capacity=4 * (threshold - 1) + 16,
                              n_subtrees=32, whitener=db.whitener,
                              device=device)
            db2.blocked_threshold = threshold
            db2.add_sentences([None] * (threshold - 1), d2.corpus_embs)
            zero()
            ids2 = to_host(db2.query_ids(d2.query_embs, 10, rerank=1024))
            sf["edge_window"] = read()
            window(sf["edge_window"], "the edge forest")
            sf["edge"] = small_forest_plain(
                db2, d2.query_embs, ids2, 10, 1024, 1024, d2.corpus_embs,
                d2.target_ids)
            sf["edge"]["rows"] = len(db2)
            sf["edge"]["served_recall@10"] = float(np.mean(
                [t in row for t, row in zip(d2.target_ids, ids2)]))
            if abs(sf["edge"]["served_recall@10"]
                   - sf["edge"]["plain_recall@10"]) > 0.005:
                raise AssertionError(f"the edge forest: {sf['edge']}")

        sf["rec"] = headline.run(
            corpus_size=corpus_size, queries=queries, dim=dim, pca_dim=0.96,
            k=10, batch=1024, dataset="hard", n_lanes=32, rerank=1024,
            routing=routing, device=device, log=lambda *a: log(*a),
            hook=hook)[0]
        rec = sf["rec"]
        log(json.dumps(rec))
        window(sf["window"], f"{routing} serving")
        if rec["routing"] != routing or rec["engine"] != "small_forest":
            raise AssertionError(f"the small forest ran as {rec}")
        if abs(rec["recall@10"] - sf["plain"]["plain_recall@10"]) > 0.005:
            raise AssertionError(
                f"small forest, {routing}: recall@10 {rec['recall@10']} is "
                "more than 0.005 from its plain pipeline's "
                f"{sf['plain']['plain_recall@10']}")
    return out


def memory_tools_slice(db, data, zero, read, device="cuda", batch=1024,
                       pool=512, small_corpus=5000, small_queries=750,
                       cpu_rows=4096, dim=768, card=True) -> dict:
    """Phase 3g: the memory tools of a large index on the scale slice's
    whitener-mode forest ``db`` (its queries ``data``; backstop on), each
    step served in its own counter window:

    (a) ``emb_store_dtype = "bfloat16"``: every query served through
        kernel 5's bf16 entry (once a chunk, no f32 launch), recall@10 at
        least the f32 store's - 0.02, the store's bytes halved; the entry
        held against its plain version and timed on one batch's served
        pools (the sweep's and the backstop's, united), beside the f32
        entry on the same pools;
    (b) ``compress_stats()``: the index rebuilt from bf16 stats, recall@10
        at least (a)'s - 0.01 and top-10 overlap with (a) at least 0.9;
    (c) ``offload_state()``: device memory falls by the state's bytes,
        the ids equal (b)'s exactly and the state stays on the host; then
        1024 new rows added (the state back on the device first), each
        found first as itself;
    (d) a forest of the first ``cpu_rows`` rows of phase 3e's corpus built
        with ``build_device="cpu"`` and ``promote_build_device()``, served
        on ``device`` by the fused engine, its ids held against the plain
        pipeline (``probes.plain_check``); whether its structure equals a
        build on ``device`` from the same rows is recorded.

    ``card`` False leaves out what only the card has (launch counts, the
    kernel, device memory): a host rehearsal at small sizes.  Returns the
    record."""
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import plain_check
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.core import tree as tree_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import rerank
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

    qall = data.query_embs
    calls = -(-len(qall) // batch)
    out = {}

    def serve(rows, k=10):
        return np.concatenate([to_host(db.query_ids(rows[s:s + batch], k))
                               for s in range(0, len(rows), batch)])

    def recall(ids):
        return float(np.mean([t in r for t, r in zip(data.target_ids, ids)]))

    def mem():
        if not card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def fail(what, rec):
        raise AssertionError(f"3g {what}: {rec}")

    # (a) the bf16 re-rank store; on the card the served pools of one
    # batch (the sweep's and the backstop's, united) first, for kernel 5's
    # two entries on the same pools
    ids32 = serve(qall)
    store0 = db._emb_dev.nbytes
    pv = float(db.cfg.prior_var)
    if card:
        qs = torch.as_tensor(qall[:batch], device=device)
        qw = db.whitener.transform_torch(qs)
        nv = db._indexed_count()
        cs, cand = index_mod.fused_query_topk(db._fused_index(), qw,
                                              min(pool, nv))
        bs = db._backstop_k(pool, nv)
        if bs:
            bcs, bcand = index_mod.backstop_topk(*db._wemb_device(), qw, bs,
                                                 nv, gt_layout=True)
            cand, cs = index_mod.union_candidates(cand, cs, bcand, bcs)
        cand, cs = cand.to(torch.int32).contiguous(), cs.contiguous()
        rerank_f32 = check_rerank(
            rerank, db._emb_device(), qs, cand, cs, reps=10,
            label=" f32 store (3g served pools)", pv=pv)
    db.emb_store_dtype = "bfloat16"
    zero()
    ids_a = serve(qall)
    a = out["a"] = {"window": read(), "recall@10_f32_store": recall(ids32),
                    "recall@10": recall(ids_a),
                    "store_bytes": [store0, db._emb_dev.nbytes],
                    "host_copy_bytes": db._emb_host.nbytes}
    w = a["window"]
    if card and not (w["rerank_l2_bf16"] == calls and w["rerank_l2"] == 0
                     and w["fused_topk"] == 2 * calls):
        fail("(a) the bf16 store did not serve through kernel 5's bf16 "
             "entry once a chunk", a)
    if (db._emb_dev.dtype != torch.bfloat16
            or 2 * db._emb_dev.nbytes != store0
            or a["recall@10"] < a["recall@10_f32_store"] - 0.02):
        fail("(a)", a)
    if card:
        a["rerank"] = check_rerank(
            rerank, db._emb_device(), qs, cand, cs, reps=10,
            label=" bf16 store (3g served pools)", pv=pv)
        a["rerank"]["f32_entry_same_pools"] = rerank_f32
        del qs, qw, cs, cand
    log(f"[tools] (a) bf16 store: {json.dumps(a)}")

    # (b) compressed stats
    st0 = tree_mod.state_bytes(db.forest.state)
    db.compress_stats()
    zero()
    ids_b = serve(qall)
    b = out["b"] = {"window": read(), "recall@10": recall(ids_b),
                    "overlap_with_a": float(np.mean([
                        len(set(x) & set(y)) / len(x)
                        for x, y in zip(ids_a.tolist(), ids_b.tolist())])),
                    "state_bytes": [st0,
                                    tree_mod.state_bytes(db.forest.state)]}
    w = b["window"]
    if card and not (w["rerank_l2_bf16"] == calls
                     and w["fused_topk"] == 2 * calls):
        fail("(b) window", b)
    if (db.forest.state.means.dtype != torch.bfloat16
            or b["recall@10"] < a["recall@10"] - 0.01
            or b["overlap_with_a"] < 0.9):
        fail("(b)", b)
    log(f"[tools] (b) compressed stats: {json.dumps(b)}")

    # (c) the state offloaded, then an add
    m0, sb = mem(), tree_mod.state_bytes(db.forest.state)
    db.offload_state()
    c = out["c"] = {"state_bytes": sb, "device_bytes_freed": m0 - mem()}
    zero()
    ids_c = serve(qall)
    c["window"] = read()
    c["ids_equal_b"] = bool(np.array_equal(ids_c, ids_b))
    c["state_on_after_serving"] = db.forest.state.device.type
    if (not c["ids_equal_b"] or (card and (c["device_bytes_freed"] < sb
            or c["state_on_after_serving"] != "cpu"))):
        fail("(c) offload", c)
    new = synthetic_retrieval_hard(1024, 1, dim, seed=13).corpus_embs
    n0 = len(db)
    db.add_sentences([None] * len(new), new)
    c["state_on_after_add"] = db.forest.state.device.type
    zero()
    got = serve(new, 1)[:, 0]
    c["add_window"] = read()
    c["added_rows_found_first"] = int(np.sum(got == np.arange(
        n0, n0 + len(new))))
    w = c["add_window"]
    if (c["added_rows_found_first"] != len(new)
            or c["state_on_after_add"] != db.forest.device.type
            or (card and not (w["rerank_l2_bf16"] == w["pending"] ==
                              w["rerank_l2"] == 1))):
        fail("(c) add after the offload", c)
    log(f"[tools] (c) offloaded state: {json.dumps(c)}")

    # (d) a forest built on the host, promoted to the device
    d3 = synthetic_retrieval_hard(small_corpus, small_queries, dim)
    rows = d3.corpus_embs[:cpu_rows]
    wh = PCAICAWhiteningModel.fit(rows, pca_dim=0.96, ica_max_iter=500,
                                  seed=0, ica_sample_size=10000)

    def build(bdev):
        x = CobwebIndex(config=TreeConfig(dim=wh.dim_out),
                        capacity=4 * cpu_rows + 16, n_subtrees=32,
                        whitener=wh, device=device, build_device=bdev)
        t0 = time.perf_counter()
        x.add_sentences([None] * cpu_rows, rows)
        if card:
            torch.cuda.synchronize()
        return x, time.perf_counter() - t0

    hdb, host_s = build("cpu")
    d = out["d"] = {"rows": cpu_rows, "cpu_build_s": host_s,
                    "cpu_inserts_per_s": cpu_rows / host_s,
                    "built_on": hdb.forest.state.device.type}
    t0 = time.perf_counter()
    hdb.promote_build_device()
    d["promote_s"] = time.perf_counter() - t0
    d["served_on"] = hdb.device.type
    hdb.blocked_threshold = min(1024, cpu_rows // 2)   # the fused engine
    pool_d = min(1024, cpu_rows)
    mask = d3.target_ids < cpu_rows
    q, gold = d3.query_embs[mask], d3.target_ids[mask]
    zero()
    served = to_host(hdb.query_ids(q, 10, rerank=pool_d))
    d["window"] = read()
    d["plain"] = plain_check(hdb, q, served, 10, pool_d, 0, batch, rows,
                             gold)
    d["recall@10"] = float(np.mean([t in r for t, r in zip(gold, served)]))
    ddb, d["device_build_s"] = build(None)
    d["leaves_equal_device_build"] = bool(np.array_equal(
        hdb.forest._leaf_global(), ddb.forest._leaf_global()))
    d["lanes_differing_from_device_build"] = [
        i for i in range(32)
        if hdb.forest.lane_signature(i) != ddb.forest.lane_signature(i)]
    d["structure_equal_device_build"] = (
        d["leaves_equal_device_build"]
        and not d["lanes_differing_from_device_build"])
    if card and not d["structure_equal_device_build"]:
        # where each differing lane's first decision parted, and whether
        # within the float32 rounding of its terms (bench/build_divergence)
        from rag_cobweb_tpu_torch.bench import build_divergence
        probe = build_divergence.summary(build_divergence.run_case(
            "a", rows=cpu_rows, device=device))
        d["probe"] = probe
        for f in probe["first_differences"]:
            log(f"[tools] (d) lane {f['lane']}: {json.dumps(f)}")
        if not (probe["recorded_equals_graph_build"]
                and all(f["verdict"] in ("exact tie", "near tie")
                        for f in probe["first_differences"])):
            fail("(d) card build against host build", probe)
    w = d["window"]
    if (d["served_on"] != db.device.type or hdb.forest.device != db.device
            or (card and not (w["fused_topk"] > 0 and w["rerank_l2"] > 0))):
        fail("(d) promotion", d)
    log(f"[tools] (d) host build promoted: {json.dumps(d)}")
    return out


WHITENER_KINDS = ("zca", "pcazca")
# The JAX package's recall@10 at phase 3h's settings where it is below the
# exact scan's (0.906): full-rank ZCA lifts the low-variance directions to
# unit variance, and the 1024-row path-score pool of the ZCA forest leaves
# out 83 golds in both packages, the same queries
# (scripts/torch_whitener_recall.py --whitener zca, on the CPU: JAX 0.885,
# port 0.885).  ZCA does not depend on the host's numpy (its matrix does
# not depend on the eigenvectors' signs), so the card's build is the same.
JAX_RECALL = {"zca": (0.885, "the JAX package's")}


def whitener_forests(headline, zero, read, out_dir: Path, device="cuda",
                     corpus_size=10000, queries=1000, dim=768, pool=1024,
                     threshold=8192, card=True) -> dict:
    """Phase 3h (a): the flagship settings (hard corpus, 32 lanes, k=10,
    pool 1024, fused engine) on a ZCA whitener (full rank) and on a
    PCA+ZCA whitener (``pca_dim=0.96``): the tree as wide as the raw rows,
    so kernel 1 sweeps 2D = 2 ``dim``.  Each is fitted on the host, built
    on ``device`` and served in a counter window (kernels 1 and 5 must
    launch), its ids held against the same pipeline in plain PyTorch
    (``probes.plain_check``: equal but at ties it shows); then, outside
    the window, the stage split of one batch, kernel 1 held and timed on
    the served index and kernel 5 on the served pools (``card``); the
    index saved (its whitener pickle under the JAX class name) and loaded
    back, whose ids must equal the original's; on the ZCA forest
    ``vforest_beam_topk`` at B=32, held against a host copy of the stacked
    index.  ``threshold`` is the forest's ``blocked_threshold`` (lowered
    for a host rehearsal at a small size, so the fused engine serves);
    ``card`` False leaves out the counters, CUDA events and kernels.
    Returns a record per whitener."""
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import plain_check, stage_split
    from rag_cobweb_tpu_torch.core.index import fused_query_topk
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.files import JAX_WHITENER_MODULE
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    out = {}
    for kind in WHITENER_KINDS:
        wf = out[kind] = {}

        def hook(event, engine, db, data, wf=wf, kind=kind):
            if event == "start":
                db.blocked_threshold = threshold
                zero()
                return
            wf["window"] = read()
            q = data.query_embs
            wf["B"] = len(q)
            served = to_host(db.query_ids(q, 10, rerank=pool))
            # the served ids' digest, as scripts/torch_whitener_recall.py
            # prints the host builds'
            wf["ids_sha256"] = hashlib.sha256(
                np.ascontiguousarray(served, np.int64).tobytes()
            ).hexdigest()[:16]
            wf["plain"] = plain_check(db, q, served, 10, pool, 0, 1024,
                                      data.corpus_embs, data.target_ids)
            wf["plain"]["served_recall@10"] = recall10(served,
                                                       data.target_ids)
            wf["fused_shape"] = list(db._fused_index().GT.shape)
            raw = torch.as_tensor(q, device=device)
            qw = db.whitener.transform_torch(raw)
            if card:
                wf["split"] = stage_split(db, q, 10, pool)
                fidx = db._fused_index()
                wf["fused"] = check_fused(
                    fused_topk, fused_topk.query_terms(qw, fidx.GT.dtype),
                    fidx.GT, fidx.c, fidx.valid, pool, reps=10,
                    label=f" ({kind} forest, served index)", real=True)
                cs, cand = fused_query_topk(fidx, qw, pool)
                wf["rerank"] = check_rerank(
                    rerank, db._emb_device(), raw,
                    cand.to(torch.int32).contiguous(), cs.contiguous(),
                    reps=10, label=f" ({kind} forest, served pools)",
                    pv=float(db.cfg.prior_var))
                del cs, cand
            # the file: the whitener pickle under the JAX class's name
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"{kind}_forest.npz"
            t0 = time.perf_counter()
            db.save(str(path))
            wf["save_s"] = time.perf_counter() - t0
            with np.load(path) as f:
                stream = bytes(f["whitener_pickle"])
            name = type(db.whitener).__name__
            if f"{JAX_WHITENER_MODULE}\n{name}\n".encode() not in stream:
                raise AssertionError(f"{kind}: the saved whitener is not "
                                     f"pickled as the JAX {name}")
            loaded = CobwebIndex.load(str(path), device=db.device)
            loaded.blocked_threshold = threshold
            if type(loaded.whitener) is not type(db.whitener):
                raise AssertionError(f"{kind}: loaded a "
                                     f"{type(loaded.whitener).__name__}")
            if not np.array_equal(to_host(loaded.query_ids(
                    q, 10, rerank=pool)), served):
                raise AssertionError(f"{kind}: the loaded copy serves "
                                     "other ids")
            del loaded
            if kind == "zca":
                wf["beam"] = vforest_beam_hold(db, qw[:32])

        wf["rec"] = headline.run(
            corpus_size=corpus_size, queries=queries, dim=dim, pca_dim=0.96,
            k=10, batch=1024, dataset="hard", n_lanes=32, rerank=pool,
            device=device, whitener=kind, log=lambda *a: log(*a),
            hook=hook)[0]
        rec = wf["rec"]
        log(json.dumps(rec))
        if card and not (wf["window"]["fused_topk"] > 0
                         and wf["window"]["rerank_l2"] > 0
                         and wf["window"]["fused_topk_f32"] == 0):
            raise AssertionError(f"{kind}: the forest did not serve "
                                 f"through kernels 1 and 5: {wf['window']}")
        if rec["tree_dim"] != dim or rec["whitener"] != kind:
            raise AssertionError(f"{kind}: the forest ran as {rec}")
        if abs(rec["recall@10"] - wf["plain"]["plain_recall@10"]) > 0.005:
            raise AssertionError(
                f"{kind}: recall@10 {rec['recall@10']} is more than 0.005 "
                f"from its plain pipeline's "
                f"{wf['plain']['plain_recall@10']}")
    return out


def vforest_beam_hold(db, qw) -> dict:
    """``vforest_beam_topk`` (the per-lane oracle beam, plain PyTorch) on
    a served forest's stacked index and on a host copy of it: the same
    ids, or the row's beam scores show a tie within 1e-5 of the largest
    |score| (rows of one leaf tie, and the two devices sum in other
    orders).  Returns the record, with the card's time."""
    from rag_cobweb_tpu_torch.parallel.vforest import (_vforest_beam,
                                                       vforest_beam_topk)
    stacked = db.forest.build_index()
    host = stacked._replace(**{f: getattr(stacked, f).cpu()
                               for f in stacked._fields})
    got = vforest_beam_topk(stacked, qw, 10)
    want = vforest_beam_topk(host, qw.cpu(), 10)
    differ = np.nonzero((want != got).any(axis=1))[0]
    if len(differ):
        scores = _vforest_beam(host, qw.cpu(), 10, 32, 16)[0]
        for b in differ:
            s = torch.sort(scores[:, b].reshape(-1), descending=True).values
            s = s[s > -1e38]
            if not bool(((s[:-1] - s[1:]) <= 1e-5 * s.abs().max()).any()):
                raise AssertionError(f"vforest_beam_topk, query {b}: ids "
                                     "differ from the host's at no tie")
    return {"B": len(qw), "queries_differing_from_host": len(differ),
            "ms": median_ms(lambda: vforest_beam_topk(stacked, qw, 10),
                            reps=3)}


def classifier_slice(device="cuda", n_classes=16, dim=768, n_fit=1024,
                     n_test=512, max_nodes=64, card=True) -> dict:
    """Phase 3h (b): the labeled classifier on the JAX test's recipe at
    the encoder's width (``n_classes`` Gaussian clusters, centres at
    scale 4, noise 0.4; ``n_fit`` rows fitted, ``n_test`` held out), a
    single-tree build on ``device`` with its inserts/s, ``predict_probs``
    with and without the ``max_nodes`` cut held within 1e-5 of the same
    classifier's host copy (its state moved to the CPU, the plain path),
    and held-out accuracy of at least 0.9.  Returns the record."""
    from rag_cobweb_tpu_torch.core.classifier import CobwebClassifier
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.tree import CobwebTree, state_to
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(n_classes, dim))
    per = -(-(n_fit + n_test) // n_classes)
    X = np.concatenate([c + 0.4 * rng.normal(size=(per, dim))
                        for c in centers]).astype(np.float32)
    y = [f"class_{i // per}" for i in range(len(X))]
    order = rng.permutation(len(X))[:n_fit + n_test]
    X, y = X[order], [y[i] for i in order]
    clf = CobwebClassifier(TreeConfig(dim=dim), capacity=4 * n_fit,
                           seed=0, device=device)
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.fit(X[:n_fit], y[:n_fit])
    if card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    host_tree = CobwebTree(clf.cfg, capacity=8, device="cpu")
    host_tree.state = state_to(clf.tree.state, "cpu")
    host = CobwebClassifier.__new__(CobwebClassifier)
    host._setup(host_tree, clf.alpha, clf.reverse_labels,
                clf.sentence_labels, clf.leaf_of_sentence)
    Xt, yt = X[n_fit:], y[n_fit:]
    rec = {"rows": n_fit, "dim": dim, "classes": n_classes,
           "inserts_per_s": n_fit / fit_s, "fit_s": fit_s,
           "nodes": int(clf.tree.state.n_alloc[0])}
    for cut in (None, max_nodes):
        got, want = clf.predict_probs(Xt, cut), host.predict_probs(Xt, cut)
        err = float(np.abs(got - want).max())
        if not err <= 1e-5:
            raise AssertionError(f"classifier max_nodes={cut}: the card's "
                                 f"probabilities differ from the host copy's "
                                 f"by {err}")
        rec[f"max_abs_err max_nodes={cut}"] = err
        rec[f"accuracy max_nodes={cut}"] = float(np.mean(
            [clf.reverse_labels[int(i)] == t
             for i, t in zip(got.argmax(axis=1), yt)]))
        rec[f"predict_probs_ms max_nodes={cut}"] = median_ms(
            lambda: clf.predict_probs(Xt, cut), reps=3)
    if not rec["accuracy max_nodes=None"] >= 0.9:
        raise AssertionError(f"classifier: held-out accuracy "
                             f"{rec['accuracy max_nodes=None']} < 0.9")
    return rec


def blocked_rerank_hold(db, qw, k=10, rerank=512, n_host=64,
                        reps=3) -> dict:
    """Phase 3h (c), on a served blocked index (phase 3b's):
    ``blocked_query_topk_rerank`` (the blocked sweep in PyTorch, as XLA
    computes it in the JAX package, then the leaf log-prob re-rank) timed
    at the batch of ``qw``, and its ids on the first ``n_host`` queries
    held against a host copy of the two indexes: equal, or the two ids'
    leaf log-probs within 1e-5 of their terms of each other (ties of rows
    of one leaf, or of a bf16 sweep summed in another order).  Returns the
    record (``reps`` 0, a host rehearsal: untimed)."""
    from rag_cobweb_tpu_torch.core.index import blocked_query_topk_rerank
    bidx, idx = db._blocked_index(), db._flat_pred_index()

    def run():
        return blocked_query_topk_rerank(bidx, idx, qw, k, rerank)

    gs, gi = (t[:n_host].cpu() for t in run())
    hb = bidx._replace(**{f: getattr(bidx, f).cpu() for f in bidx._fields})
    hi = idx._replace(**{f: getattr(idx, f).cpu() for f in idx._fields
                         if isinstance(getattr(idx, f), torch.Tensor)})
    q = qw[:n_host].cpu()
    ws, wi = blocked_query_topk_rerank(hb, hi, q, k, rerank)
    ids = torch.cat([wi, gi], dim=1)
    leaf = (hi.paths.gather(1, ((hi.paths >= 0).sum(1) - 1).clamp(min=0)
                            .unsqueeze(1))[:, 0])[ids.long()]
    x = q.float().unsqueeze(1)
    terms = (torch.sum(x.abs() * hi.mu_over_var_T.T[leaf].abs(), -1)
             + 0.5 * torch.sum(x * x * hi.inv_var_T.T[leaf], -1)
             + hi.const[leaf].abs()).amax(dim=1, keepdim=True)
    differ = wi != gi
    if bool(((ws - gs).abs() > 1e-5 * terms).any()):
        raise AssertionError("blocked_query_topk_rerank: a key differs from "
                             "the host copy's beyond 1e-5 of its terms")
    return {"B": len(qw), "NB": bidx.ivt_b.shape[0],
            "M": bidx.ivt_b.shape[1], "TS": bidx.W.shape[2],
            "dtype": str(bidx.W.dtype), "rerank": rerank,
            "host_queries": n_host,
            "tied_ids_differing_from_host": int(differ.sum()),
            "ms": cuda_ms(run, reps) if reps else None}


def grouped_pool_probe(B=256, S=1 << 20, k=512, reps=5) -> dict:
    """Phase 3h (c): ``grouped_pool_topk`` on random (B, S) f32 scores on
    the card: every (score, id) pair consistent (the score is the id's,
    bit for bit), overlap with the exact top-k above 0.995, timed beside
    ``torch.topk``."""
    from rag_cobweb_tpu_torch.core.index import grouped_pool_topk
    g = torch.Generator(device="cuda").manual_seed(15)
    sc = torch.randn((B, S), generator=g, device="cuda")
    top, ids = grouped_pool_topk(sc, k)
    if not torch.equal(top, sc.gather(1, ids)):
        raise AssertionError("grouped_pool_topk: a score is not its id's")
    exact = torch.topk(sc, k, dim=1).indices
    row = torch.arange(B, device="cuda").view(-1, 1) * S
    overlap = float(torch.isin(ids + row, exact + row).float().mean())
    if not overlap > 0.995:
        raise AssertionError(f"grouped_pool_topk: overlap {overlap} with "
                             "the exact top-k")
    rec = {"B": B, "S": S, "k": k, "overlap_with_exact": overlap,
           "ms": cuda_ms(lambda: grouped_pool_topk(sc, k), reps),
           "topk_ms": cuda_ms(lambda: torch.topk(sc, k, dim=1), reps)}
    del sc
    torch.cuda.empty_cache()
    return rec

MESH_STRUCT = ("counts", "parent", "children", "n_children", "root",
               "n_alloc", "free_top")


def write_multichip_flagship(db, data, out_dir: Path) -> None:
    """Phase 3j's flagship inputs (from phase 3's served forest ``db``):
    the served index, the raw store, the rows and queries whitened as
    the forest took them."""
    from rag_cobweb_tpu_torch.bench import multichip_slice
    raw = torch.as_tensor(data.corpus_embs, device=db.device)
    qs = torch.as_tensor(data.query_embs, device=db.device)
    multichip_slice.write_flagship(
        out_dir, db._fused_index(), data.corpus_embs,
        db.whitener.transform_torch(raw).cpu().numpy(),
        db.whitener.transform_torch(qs).cpu().numpy(), data.query_embs,
        data.target_ids, db.cfg)


def write_multichip_single(db, data, out_dir: Path) -> tuple:
    """Phase 3j's single tree (phase 3c's ``db``) saved beside the
    flagship's inputs; returns (its end-to-end texts, queries, gold
    rows), the rest of ``multichip_phase``'s arguments."""
    from rag_cobweb_tpu_torch.bench import multichip_slice
    out_dir.mkdir(parents=True, exist_ok=True)
    db.save(str(out_dir / multichip_slice.SINGLE))
    return (query_texts(db, data.target_ids), data.query_embs,
            data.target_ids)


def multichip_phase(exact_recall: float, in_dir: Path, texts, queries,
                    targets, device="cuda", lanes=32, k=10, pool=1024,
                    forest_rows=2048, batch_per_rank=16, reps=20,
                    capacity_per_lane=1024, timeout=600.0) -> dict:
    """Phase 3j: the multi-device port (``bench/multichip_slice``) on
    ``min(cards, 4)`` ranks, a card each over NCCL, or with one card 2
    ranks on it over gloo.  ``in_dir`` holds the flagship's inputs and
    the single tree (written in phases 3 and 3c); ``queries``/``targets``
    are the single slice's raw queries and gold rows, ``texts`` its
    end-to-end texts.  Before the ranks start, (c)'s reference: one
    ``VForest(n_subtrees=lanes)`` on this device over the same rows and
    its ids.  After: (a)'s recall within 0.005 of ``exact_recall``, and on
    the card kernels 1 and 5 held and timed at rank 0's slab and pools;
    (c) every lane slot for slot equal to the reference's (a lane that
    differs must show a near tie in a recorded build of the reference,
    ``bench/build_divergence``) and the ids equal but at ties; (e) every
    row found as itself.  Returns the record."""
    from rag_cobweb_tpu_torch.bench import build_divergence as bd
    from rag_cobweb_tpu_torch.bench import multichip, multichip_slice, probes
    from rag_cobweb_tpu_torch.core import tree as tree_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.index import FusedIndex
    from rag_cobweb_tpu_torch.files import read_npz
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    from rag_cobweb_tpu_torch.parallel import tp
    from rag_cobweb_tpu_torch.parallel.vforest import VForest
    t_phase = time.perf_counter()
    card = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if card else 0
    n = min(cards, 4) if cards >= 2 else 2
    backend, _ = multichip.rank_layout(n, device)
    F = read_npz(str(in_dir / multichip_slice.FLAGSHIP))
    cfg = TreeConfig.from_json_dict(json.loads(bytes(F["cfg"]).decode()))
    rows_w, qw = F["rows_w"], F["queries_w"]

    def sync():
        if card:
            torch.cuda.synchronize()

    # (c)'s reference, before the ranks start
    vf = VForest(cfg, n_subtrees=lanes, capacity_per_tree=capacity_per_lane,
                 seed=0, device=device)
    sync()
    t0 = time.perf_counter()
    vf.add(rows_w)
    sync()
    ref_s = time.perf_counter() - t0
    ref_scores, ref_ids = (t.cpu().numpy() for t in vf.query_topk(qw, k))
    ref = tree_mod.state_to_numpy(vf.state)
    ref_leaves = [list(x) for x in vf._leaf_of_local]
    del vf
    if card:
        torch.cuda.empty_cache()

    spec = dict(dir=str(in_dir), k=k, pool=pool, lanes=lanes,
                capacity_per_lane=capacity_per_lane,
                batch_per_rank=batch_per_rank, forest_rows=forest_rows,
                texts=list(texts), single_queries=np.asarray(queries),
                single_targets=np.asarray(targets))
    t0 = time.perf_counter()
    recs = multichip_slice.run(spec, n, device, timeout=timeout)
    out = {"cards": cards, "world": n, "backend": backend,
           "ranks_s": time.perf_counter() - t0,
           "rank_s": [r["s"] for r in recs],
           "rank_devices": [f"rank {r['rank']} -> {r['device']} "
                            f"({r['card']})" for r in recs]}

    # (a)
    a0 = recs[0]["a"]
    if not a0["recall@10"] >= exact_recall - 0.005:
        raise AssertionError(f"3j (a): recall@10 {a0['recall@10']} is more "
                             f"than 0.005 below the exact scan's "
                             f"{exact_recall}")
    out["a"] = {"recall@10": a0["recall@10"], "exact": exact_recall,
                "slab": a0["slab"], "plain": a0["plain"],
                "windows": [r["a"]["window"] for r in recs],
                "ms": [r["a"]["ms"] for r in recs],
                "split": [r["a"].get("split") for r in recs]}
    if card:
        GT = torch.as_tensor(F["GT"])
        if bool(F["GT_bf16"]):
            GT = GT.to(torch.bfloat16)
        fidx = FusedIndex(GT=GT, c=torch.as_tensor(F["c"]),
                          valid=torch.as_tensor(F["valid"]))
        slab = tp.rank_slab(tp.shard_fused_index(fidx, n, F["raw"]), 0,
                            device)
        qq = fused_topk.query_terms(torch.as_tensor(qw, device=device),
                                    slab.GT.dtype)
        kk = min(max(k, pool), slab.width)
        kappa = min(kk, fused_topk.SLAB)
        out["a"]["fused"] = check_fused(
            fused_topk, qq, slab.GT, slab.c, slab.valid, kappa, reps,
            label=" (TP rank 0 slab)", real=True)
        top, rows = fused_topk.merge(*fused_topk.slab_topk(
            qq, slab.GT, slab.c, slab.valid, kappa), kk)
        live = top > fused_topk.NEG / 2
        cand = torch.where(live, rows, torch.zeros_like(rows)).to(
            torch.int32).contiguous()
        cs = torch.where(live, top, torch.full_like(top, -math.inf))
        out["a"]["rerank"] = check_rerank(
            rerank, slab.emb, torch.as_tensor(F["queries"], device=device),
            cand, cs.contiguous(), reps, label=" (TP rank 0 pools)", pv=1.0)
        del slab, qq, top, rows, cand, cs
        torch.cuda.empty_cache()

    # (b)
    b0 = recs[0]["b"]
    out["b"] = {k2: b0[k2] for k2 in ("N", "S", "ms", "recall@10", "plain",
                                       "all_reduce_bytes")}
    out["b"]["all_reduce_ms"] = [r["b"]["all_reduce_ms"] for r in recs]

    # (c): every lane slot for slot against the reference
    differ, mesh_leaves = [], {}
    for r in recs:
        c = r["c"]
        for i, leaves in enumerate(c["leaves"]):
            lane = c["lane0"] + i
            mesh_leaves[lane] = list(leaves)
            if not (all(np.array_equal(c["arrays"][f][i], ref[f][lane])
                        for f in MESH_STRUCT) and leaves == ref_leaves[lane]):
                differ.append(lane)
    near = {}
    if differ:
        trace = bd.traced_build(torch.as_tensor(rows_w), cfg, lanes, device)
        for lane in differ:
            want = trace.forest._leaf_of_local[lane]
            got = mesh_leaves[lane]
            first = next((i for i, (x, y) in enumerate(zip(want, got))
                          if x != y), min(len(want), len(got)))
            ties = bd.near_ties(trace, lane, first)
            if not ties:
                raise AssertionError(f"3j (c): lane {lane} differs from the "
                                     f"single-card forest at insert {first} "
                                     "with no near tie before it")
            near[lane] = {"first": first, "near_ties": ties[:3]}
    out["c"] = {"lanes": lanes, "lanes_differing": differ,
                "near_ties": near, "ref_build_s": ref_s,
                "ref_inserts_per_s": len(rows_w) / ref_s,
                "inserts_per_s": [r["c"]["inserts_per_s"] for r in recs],
                "rows": [r["c"]["rows"] for r in recs],
                "total_inserts_per_s": len(rows_w) / max(
                    r["c"]["build_s"] for r in recs),
                "ids": probes.hold_ids_at_ties(
                    ref_ids, recs[0]["c"]["ids"], ref_scores,
                    recs[0]["c"]["scores"])}

    # (d), (f): rank 0 held the steps; the all-reduce's share of a step
    d0, f0 = recs[0]["d"], recs[0]["f"]
    out["d"] = {"hold": {k2: v for k2, v in d0["hold"].items()
                         if k2 not in ("metrics_card", "metrics_host")},
                "global_batch": d0["global_batch"],
                "ms_per_step": [r["d"]["ms_per_step"] for r in recs],
                "grad_all_reduce_ms": [r["d"]["grad_all_reduce_ms"]
                                       for r in recs],
                "grad_all_reduce_share": [
                    r["d"]["grad_all_reduce_ms"] / r["d"]["ms_per_step"]
                    for r in recs],
                "grad_all_reduce_bytes": d0["grad_all_reduce_bytes"],
                "fit_dp_losses": d0["fit_dp_losses"]}
    out["f"] = {"hold": {k2: v for k2, v in f0["hold"].items()
                         if k2 not in ("metrics_card", "metrics_host")},
                "global_batch": f0["global_batch"],
                "ms_per_step": [r["f"]["ms_per_step"] for r in recs]}

    # (e)
    out["e"] = [r["e"] for r in recs]
    for e in out["e"]:
        if e["found_itself"] < 1.0:
            raise AssertionError(f"3j (e): a row did not find itself: {e}")
    out["s"] = time.perf_counter() - t_phase
    return out


def log_multichip(rec: dict, smi: str) -> None:
    """Phase 3j's lines."""
    log(f"[3j] cards {rec['cards']}, world size {rec['world']}, backend "
        f"{rec['backend']}; {'; '.join(rec['rank_devices'])} ({smi})")
    a = rec["a"]
    log(f"[3j] (a) fused TP over the flagship index: recall@10 "
        f"{a['recall@10']} (exact {a['exact']}), rank slab {a['slab']}; "
        f"vs plain on one device: {a['plain']}; launches by rank "
        f"{[{k: w[k] for k in ('fused_topk', 'rerank_l2')} for w in a['windows']]}")
    log(f"[3j] (a) batch ms by rank (CUDA events): {json.dumps(a['ms'])}")
    log(f"[3j] (a) stage split by rank, stream ms: {json.dumps(a['split'])}")
    b = rec["b"]
    log(f"[3j] (b) TP over the single tree (N={b['N']}, S={b['S']}): "
        f"recall@10 {b['recall@10']}, B=1000 {b['ms']:.3f} ms; vs exact "
        f"re-rank of the shards' pools: {b['plain']}; all-reduce of "
        f"{b['all_reduce_bytes']} bytes by rank {b['all_reduce_ms']} ms")
    c = rec["c"]
    log(f"[3j] (c) mesh forest, {c['lanes']} lanes: build inserts/s by rank "
        f"{c['inserts_per_s']} (rows {c['rows']}), total "
        f"{c['total_inserts_per_s']:.1f}; one-card reference "
        f"{c['ref_inserts_per_s']:.1f}; lanes differing "
        f"{c['lanes_differing']} {c['near_ties']}; ids vs the reference "
        f"{c['ids']}")
    for name in ("d", "f"):
        t = rec[name]
        h = t["hold"]
        log(f"[3j] ({name}) fit_dp, global batch {t['global_batch']}: ms a "
            f"step by rank {t['ms_per_step']}; vs single-process steps over "
            f"{h['steps']}: ok {h['ok']}, worst metric rel "
            f"{h['worst_metric_rel']:.3g}, worst parameter excess "
            f"{h['worst_param_excess']:.3g}, unsettled / parted "
            f"{h['unsettled']} / {h['parted']} of {h['entries']}")
    d = rec["d"]
    log(f"[3j] (d) gradient all-reduce ({d['grad_all_reduce_bytes']} bytes) "
        f"ms by rank {d['grad_all_reduce_ms']}, share of a step "
        f"{d['grad_all_reduce_share']}; one epoch of fit_dp: loss "
        f"{d['fit_dp_losses']}")
    log(f"[3j] (e) sharded forest: {rec['e']}")
    log(f"[3j] {rec['s']:.1f}s (ranks {rec['ranks_s']:.1f}s, by rank "
        f"{[round(x, 1) for x in rec['rank_s']]})")


# -- phase 3k: the reference's benchmark harness and the encoder --------

# the "extra" matrix's rows in order; Annoy is not installed and skips
HARNESS_ROWS = ("Flat IP ({tag})", "Flat L2 ({tag})", "Flat IP (native C++)",
                "HNSW (native C++)", "HNSW (native C++) PCA+ICA",
                "Cobweb PCA+ICA (beam) ({tag})",
                "Cobweb PCA+ICA Fast ({tag})")
# bert-base-uncased's published widths (its config.json)
BERT_BASE = dict(hidden_size=768, n_layers=12, n_heads=12,
                 intermediate_size=3072, vocab_size=30522,
                 max_position_embeddings=512)


def flat_ids_hold(card_ids, native_ids, corpus, queries,
                  tol=1e-5) -> dict:
    """The card's flat IP top-k against the native library's: at every
    place the two ids' exact (float64) scores agree within ``tol`` of the
    row's largest |score|, so ids differ only at ties."""
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    sc = np.einsum("bd,bkd->bk", q, c[card_ids])
    sn = np.einsum("bd,bkd->bk", q, c[native_ids])
    scale = np.abs(sn).max(1, keepdims=True)
    gap = np.abs(sc - sn) / scale
    differ = card_ids != native_ids
    if (gap > tol).any():
        b = int(np.argwhere(gap > tol)[0][0])
        raise AssertionError(
            f"flat IP: query {b}'s card ids {card_ids[b].tolist()} and "
            f"native ids {native_ids[b].tolist()} differ beyond ties")
    return {"places_differing": int(differ.sum()),
            "queries_differing": int(differ.any(1).sum()),
            "max_gap_rel": float(gap.max())}


def harness_phase(zero, read, root: Path, device="cuda", subset=10000,
                  targets=1000, dim=768) -> dict:
    """Phase 3k (a): the port's ``BenchmarkRunner`` on the synthetic
    dataset through the "extra" matrix, run as a user runs it, by the
    twin of ``scripts/synthetic_benchmark.py`` (its arguments, seed 42,
    its output under ``root``), its method rows in one counter window,
    then its gates: every row but Annoy present, the fast row's
    ids against the same pipeline in plain PyTorch (``probes.plain_check``)
    but at ties, the card's flat IP ids against the native library's but
    at ties, and the results file parsed back to the rows it printed."""
    from rag_cobweb_tpu_torch.bench import native, report
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import plain_check
    from rag_cobweb_tpu_torch.scripts import synthetic_benchmark
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(root)                  # the twin writes under its cwd
    try:
        zero()
        runner = synthetic_benchmark.main([
            "--subset_size", str(subset), "--target_size", str(targets),
            "--method", "extra", "--dim", str(dim), "--device", device])
        window = read()
    finally:
        os.chdir(cwd)
    rows = runner.results
    tag = "CPU" if device == "cpu" else "CUDA"
    want = [n.format(tag=tag) for n in HARNESS_ROWS]
    if [r["method"] for r in rows] != want:
        raise AssertionError(f"harness rows {[r['method'] for r in rows]}, "
                             f"expected {want}")
    e, db = runner.embeddings, runner.dbs["w"]
    qw = e["queries_w"]
    # the fast row's ids as it served them: batches of 256
    served = np.concatenate([np.asarray(db.predict_fast(
        qw[s:s + 256], k=10, is_embedding=True, return_ids=True), np.int64)
        for s in range(0, len(qw), 256)])
    plain = plain_check(db, qw, served, 10, db.rerank_candidates, 0, 1024,
                        e["corpus_w"], e["target_ids"])
    card = to_host(FlatIndex(e["corpus"], "ip", device=device)
                   .search_device(e["queries"], 10))
    nat, _ = native.flat_topk(e["corpus"], e["queries"], 10, "ip")
    flat = flat_ids_hold(card, nat, e["corpus"], e["queries"])
    results_path = str(root / runner.results_path)
    parsed = report.parse_results_file(results_path)
    if [p["method"] for p in parsed] != want:
        raise AssertionError(f"results file rows {parsed}")
    for p, r in zip(parsed, rows):
        if not (abs(p["recall@10"] - r["recall@10"]) <= 5e-5 and
                abs(p["avg_latency_ms"] - r["avg_latency_ms"]) <= 5e-4):
            raise AssertionError(f"results file row {p} does not read "
                                 f"back as {r}")
    return {"rows": rows, "window": window, "plain": plain, "flat": flat,
            "build": runner.builds["w"], "db": db, "queries_w": qw,
            "results_path": results_path}


def encoder_texts(n_corpus: int, n_queries: int, seed: int = 0):
    """(corpus, queries, gold ids): texts made from the sample corpora's
    sentences by a seeded word shuffle and 1-3 word substitutions from
    their vocabulary; each query is a corpus text with one word dropped."""
    from rag_cobweb_tpu_torch.bench.datasets import load_sample_corpuses
    base = [s for v in load_sample_corpuses().values() for s in v]
    vocab = sorted({w for s in base for w in s.split()})
    rng = np.random.default_rng(seed)
    corpus = []
    for _ in range(n_corpus):
        words = base[int(rng.integers(len(base)))].split()
        words = [words[j] for j in rng.permutation(len(words))]
        n_sub = min(len(words), int(rng.integers(1, 4)))
        for j in rng.choice(len(words), size=n_sub, replace=False):
            words[j] = vocab[int(rng.integers(len(vocab)))]
        corpus.append(" ".join(words))
    gold = rng.choice(n_corpus, size=n_queries, replace=False)
    queries = []
    for t in gold:
        words = corpus[t].split()
        del words[int(rng.integers(len(words)))]
        queries.append(" ".join(words))
    return corpus, queries, gold.astype(np.int64)


def encoder_phase(zero, read, smi: str, trace_dir: Path, device="cuda",
                  widths=None, n_corpus=10000, n_queries=1000,
                  max_length=128, n_hold=64, n_lanes=32) -> dict:
    """Phase 3k (b) and (c), and phase 3l (a) for each family: a model at
    ``widths`` (``make_random_encoder``'s arguments, ``arch`` among them:
    BERT by default; random weights from seed 0, the hash tokenizer, the
    architecture's pooling) on the card held against a host copy on
    ``n_hold`` texts; the corpus encoded (texts/s and tokens/s by CUDA
    events); PCA+ICA (0.96) fitted on it; ``encode_whiten_insert`` into a
    ``n_lanes``-lane forest (the whitening on the device); the queries
    encoded and served by ``query_ids`` in a counter window, their
    recall@10 beside the exact scan over the same whitened rows, their
    ids held against the same pipeline in plain PyTorch
    (``probes.plain_check``).  Each
    stage in a ``PhaseTimer``; one served batch traced with
    ``utils.profiling.trace``."""
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.headline import fit_whitener
    from rag_cobweb_tpu_torch.bench.metrics import to_host
    from rag_cobweb_tpu_torch.bench.probes import plain_check
    from rag_cobweb_tpu_torch.bench.torch_encoder import (
        TorchEncoder, encode_whiten_insert, make_random_encoder)
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.utils import profiling
    w = dict(BERT_BASE if widths is None else widths)
    card = device != "cpu"
    corpus, queries, gold = encoder_texts(n_corpus, n_queries)
    timer = profiling.PhaseTimer(device=device)
    kw = dict(max_length=max_length, batch_size=256, seed=0, **w)
    enc = make_random_encoder(device=device, **kw)
    out = {"widths": w}
    with timer.phase("hold against the host"):
        host = make_random_encoder(device="cpu", **kw)
        got, want = enc(corpus[:n_hold]), host(corpus[:n_hold])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg="encoder: card against host")
        out["hold_max_abs_err"] = float(np.abs(got - want).max())
        del host
    ids, mask = enc.tokenize(corpus)
    tokens = int(mask.sum())
    enc(corpus[:256])                                  # warm-up
    with timer.phase("encode corpus"):
        t0 = time.perf_counter()
        if card:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        raw = enc.encode_device(corpus)
        if card:
            ev1.record()
            torch.cuda.synchronize()
            out["encode_ms"] = ev0.elapsed_time(ev1)
        out["encode_wall_s"] = time.perf_counter() - t0
    ms = out.get("encode_ms", 1e3 * out["encode_wall_s"])
    out.update(texts=n_corpus, tokens=tokens,
               texts_per_s=n_corpus / ms * 1e3,
               tokens_per_s=tokens / ms * 1e3)
    with timer.phase("fit PCA+ICA"):
        wh = fit_whitener("pcaica", raw.cpu().numpy(), 0.96)
    out["whitened_dim"] = wh.dim_out
    wenc = TorchEncoder(enc.model, None, family=enc.family,
                        max_length=max_length, batch_size=256,
                        vocab_size=w["vocab_size"], whitening=wh,
                        device=device)
    db = CobwebIndex(config=TreeConfig(dim=wh.dim_out), n_subtrees=n_lanes,
                     device=device)
    with timer.phase("encode_whiten_insert"):
        t0 = time.perf_counter()
        encode_whiten_insert(wenc, db, corpus)
        out["ingest_texts_per_s"] = n_corpus / (time.perf_counter() - t0)
    with timer.phase("encode queries"):
        qw = wenc.encode_device(queries)
    to_host(db.query_ids(qw[:8], 10))          # the index builds here
    with timer.phase("serve"):
        zero()
        served = to_host(db.query_ids(qw, 10))
        out["window"] = read()
    store = db._emb_device()[:n_corpus]
    exact = to_host(FlatIndex(store.cpu().numpy(), "l2", device=device)
                    .search_device(qw.cpu().numpy(), 10))
    out["recall@10"] = float(np.mean([t in r for t, r in zip(gold, served)]))
    out["exact_recall@10"] = float(np.mean([t in r for t, r in
                                            zip(gold, exact)]))
    # the served ids against the same pipeline in plain PyTorch (equal but
    # at ties it shows)
    out["plain"] = plain_check(db, qw.cpu().numpy(), served, 10,
                               db.rerank_candidates, 0, 1024,
                               store.cpu().numpy(), gold)
    # (c) one served batch traced
    with profiling.trace(str(trace_dir), device=device) as prof:
        with profiling.span("bench.serve_batch"):
            to_host(db.query_ids(qw[:1000], 10))
    text = (trace_dir / profiling.TRACE_FILE).read_text()
    if "bench.serve_batch" not in text or "serve.query" not in text:
        raise AssertionError("the trace lacks its spans")
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        for kname, sym in (("fused_topk", "slab_topk"),
                           ("rerank_l2", "rerank_l2_kernel")):
            if sym in ev.key:
                dev_us[kname] = dev_us.get(kname, 0.0) + float(t)
    out["trace"] = {"file": str(trace_dir / profiling.TRACE_FILE),
                    "bytes": len(text), "device_us": dev_us}
    out["timer"] = timer.as_dict()
    out["timer_summary"] = timer.summary()
    out["db"], out["qw"] = db, qw
    return out


def gather_rate(rows=1 << 20, B=1024, C=512, dims=(128, 768),
                reps=10) -> dict:
    """Phase 3k (d): the card's row-gather rate, ``emb[idx]`` of B x C
    distinct rows of a (rows, D) f32 table, beside its byte bound (each
    row read once and written once)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for D in dims:
        emb = torch.randn((rows, D), generator=g, device="cuda")
        idx = torch.randperm(rows, generator=g, device="cuda")[:B * C] \
            .view(B, C)
        ms = cuda_ms(lambda: emb[idx], reps)
        n = B * C
        out[D] = {"ms": ms, "rows_per_s": n / ms * 1e3,
                  "gb_per_s": 2.0 * n * D * 4 / ms / 1e6,
                  "bound_ms": 2.0 * n * D * 4 / PEAK_BYTES_PER_S * 1e3}
        del emb, idx
        torch.cuda.empty_cache()
    return out


def log_benchmark_phase(h: dict, e: dict, smi: str) -> None:
    for r in h["rows"]:
        log(f"[3k] harness {r['method']}: recall@10 {r['recall@10']:.4f} "
            f"mrr@10 {r['mrr@10']:.4f} {r['avg_latency_ms']:.6f} ms/query "
            f"(batch {r['batch_latency_ms']:.4f} ms, control "
            f"{r['control_ms']:.6f} ms/query) | {smi}")
    b = h["build"]
    log(f"[3k] harness tree: {b['rows']} rows in {b['insert_s']:.1f}s, "
        f"{b['rows'] / b['insert_s']:.1f} inserts/s; index "
        f"{b['index_s']:.2f}s | {smi}")
    log(f"[3k] harness launches: {h['window']}; fast row vs the plain "
        f"pipeline: {h['plain']}; card flat IP vs native: {h['flat']}; "
        f"results file {h['results_path']}")
    log_encoder("[3k] encoder", e, smi)
    log("[3k] PhaseTimer:\n" + e["timer_summary"])
    log(f"[3k] trace {e['trace']['file']} ({e['trace']['bytes']} bytes); "
        f"device us in key_averages: {e['trace']['device_us']}")


def served_kernels(served) -> dict:
    """Kernels 1 and 5 held against their plain versions and timed at
    served shapes: each (name, db, whitened queries on the card) of
    ``served`` on its index with those queries and on their served pools
    (the re-rank pool, ``rerank_candidates``)."""
    from rag_cobweb_tpu_torch.core.index import fused_query_topk
    from rag_cobweb_tpu_torch.ops import fused_topk, rerank
    out = {}
    for name, db, q in served:
        fidx, pool = db._fused_index(), db.rerank_candidates
        out[name] = {"fused": check_fused(
            fused_topk, fused_topk.query_terms(q, fidx.GT.dtype), fidx.GT,
            fidx.c, fidx.valid, pool, reps=10, label=f" ({name})",
            real=True)}
        cs, cand = fused_query_topk(fidx, q, pool)
        out[name]["rerank"] = check_rerank(
            rerank, db._emb_device(), q, cand.to(torch.int32).contiguous(),
            cs.contiguous(), reps=10, label=f" ({name}, served pools)",
            pv=float(db.cfg.prior_var))
    return out


# -- phase 3l: the encoder families and the entry points' twins --------

FAMILIES = ("roberta-base", "gpt2", "t5-base")


def families_phase(zero, read, smi: str, trace_root: Path, device="cuda",
                   widths=None, **kw) -> dict:
    """Phase 3l (a): each of RoBERTa, GPT-2 and T5 at its published base
    widths (``torch_encoder.PUBLISHED``; ``widths`` replaces them by name
    for a host rehearsal) through ``encoder_phase`` (``kw`` its sizes):
    card against host, texts/s, PCA+ICA fused on the device,
    ``encode_whiten_insert`` into a 32-lane forest, served in a counter
    window, ids held by ``probes.plain_check``.  Fails unless recall@10
    is within 0.005 of the exact scan's and, on the card, kernels 1 and 5
    launched and no f32 entry.  On the card, kernels 1 and 5 are then held and timed
    on each forest's index and served pools."""
    from rag_cobweb_tpu_torch.bench.torch_encoder import PUBLISHED
    out = {}
    for name in FAMILIES:
        w = (widths or PUBLISHED)[name]
        e = encoder_phase(zero, read, smi, trace_root / name, device=device,
                          widths=w, **kw)
        win = e["window"]
        if device != "cpu" and not (win["fused_topk"] > 0
                                    and win["rerank_l2"] > 0
                                    and win["fused_topk_f32"] == 0):
            raise AssertionError(f"the {name} forest did not serve through "
                                 f"kernels 1 and 5: {win}")
        if not e["recall@10"] >= e["exact_recall@10"] - 0.005:
            raise AssertionError(
                f"{name} forest: recall@10 {e['recall@10']} is more than "
                f"0.005 below the exact scan's {e['exact_recall@10']}")
        if device != "cpu":
            e["kernels"] = served_kernels(((name, e["db"], e["qw"]),))[name]
        del e["db"], e["qw"]
        log_encoder(f"[3l] {name}", e, smi)
        out[name] = e
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def log_encoder(tag: str, e: dict, smi: str) -> None:
    log(f"{tag} {e['widths']}: card vs host max_abs_err "
        f"{e['hold_max_abs_err']:.3g}; encode {e['texts']} texts "
        f"({e['tokens']} tokens) {e.get('encode_ms', 0.0):.1f} ms "
        f"(CUDA events): {e['texts_per_s']:.1f} texts/s, "
        f"{e['tokens_per_s']:.1f} tokens/s | {smi}")
    log(f"{tag} forest: whitened dim {e['whitened_dim']}, ingest "
        f"{e['ingest_texts_per_s']:.1f} texts/s (encode, whiten, insert); "
        f"recall@10 {e['recall@10']} (exact scan {e['exact_recall@10']}); "
        f"launches {e['window']}; vs the plain pipeline {e['plain']} | "
        f"{smi}")


def twins_phase(out_dir: Path, device="cuda", case_corpus: int = 1000
                ) -> dict:
    """Phase 3l (b): the entry points' twins, each called as a user calls
    it (``main`` with its arguments) at small sizes on ``device``, once.
    The trainer each of the three training twins returns then takes 2
    more steps on the twin's data in lockstep with a host copy
    (``bench/train_steps.hold``, phase 3i's rule: every metric within 1e-5
    relative, every parameter after each step within atol 1e-5 / rtol
    1e-4), each step's metrics on both devices kept:
    ``train_query_encoder`` (200 passages, 32 queries, 64-d whitened to 8,
    2 epochs of 2 steps of 16), ``train_factorvae`` (512 synthetic 768-d
    rows, z_dim 32, 2 epochs of 2 steps of 256), ``compare_whitening``
    (600 rows, 64-d, 16 components, FactorVAE 1 epoch of 2 steps).  Then
    ``case_study`` (``case_corpus`` passages, 100 queries, 64-d),
    ``visualize_tree`` (its DOT files, a PNG only where ``dot`` exists)
    and ``run_experiments --dry-run`` (its commands name the twins)."""
    from rag_cobweb_tpu_torch.bench import train_steps
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.scripts import (case_study, compare_whitening,
                                              run_experiments,
                                              train_factorvae,
                                              train_query_encoder,
                                              visualize_tree)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    out = {}
    dev = ["--device", device]

    def run(name, fn, args):
        t0 = time.perf_counter()
        got = fn(args + dev)
        out[name] = {"s": time.perf_counter() - t0}
        return got

    def held(name, tr, steps, host_db=None):
        rec = train_steps.hold(tr, train_steps.host_copy(tr, host_db),
                               steps)
        if not rec["ok"]:
            raise AssertionError(f"3l {name} card against host: "
                                 f"{rec['fails']}")
        out[name]["hold"] = rec

    got = run("train_query_encoder", train_query_encoder.main, [
        "--corpus-size", "200", "--queries", "32", "--dim", "64",
        "--pca-dim", "8", "--epochs", "2", "--lr", "1e-3",
        "--save-dir", str(out_dir / "query")])
    tr = got["trainer"]
    tr.db.save(str(out_dir / "query_tree.npz"))
    data = synthetic_retrieval(200, 32, 64)
    held("train_query_encoder", tr,
         train_steps.query_steps(data.query_embs, data.target_ids, n=2),
         CobwebIndex.load(str(out_dir / "query_tree.npz"), device="cpu"))
    out["train_query_encoder"].update(
        losses=got["losses"], recall=(got["before"]["recall@10"],
                                      got["after"]["recall@10"]))
    got = run("train_factorvae", train_factorvae.main, [
        "--max-embed-samples", "512", "--batch-size", "256", "--epochs",
        "2", "--z-dim", "32", "--save-dir", str(out_dir / "factorvae")])
    rows = synthetic_retrieval(512, 1, 768, seed=42).corpus_embs
    held("train_factorvae", got["vae"],
         train_steps.factorvae_steps(got["vae"], rows, n=2))
    out["train_factorvae"]["recon_mse"] = [h["recon_mse"]
                                           for h in got["history"]]
    got = run("compare_whitening", compare_whitening.main, [
        "--samples", "600", "--dim", "64", "--pca-dim", "16",
        "--factorvae-epochs", "1"])
    rows = synthetic_retrieval(600, 1, 64).corpus_embs
    held("compare_whitening", got["vae"],
         train_steps.factorvae_steps(got["vae"], rows, n=2))
    out["compare_whitening"]["mean_abs_offdiag"] = {
        k: v["mean_abs_offdiag"] for k, v in got["reports"].items()}
    diff = case_study.main(["--corpus-size", str(case_corpus), "--queries",
                            "100", "--dim", "64", "--pca-dim", "16",
                            "--limit", "2"] + dev)
    out["case_study"] = {k: len(v) for k, v in diff.items()}
    paths = visualize_tree.main(["--output-dir", str(out_dir / "vis"),
                                 "--num-leaves", "4"] + dev)
    if not paths or not all(Path(p).exists() for p in paths):
        raise AssertionError(f"visualize_tree wrote {paths}")
    out["visualize_tree"] = sorted(Path(p).name for p in paths)
    exps = out_dir / "exps.json"
    exps.write_text(json.dumps({"experiments": [
        {"name": n, "script": f"scripts/{n}.py"}
        for n in ("synthetic_benchmark", "qqp_benchmark",
                  "million_benchmark")]}))
    cmds = run_experiments.main([str(exps), "--dry-run"] + dev)
    if not (cmds[0][1:3] == ["-m", "rag_cobweb_tpu_torch.scripts."
                                   "synthetic_benchmark"]
            and cmds[1][2].endswith(".qqp_benchmark")
            and cmds[2][1:] == ["-m", "rag_cobweb_tpu_torch.bench.million",
                                "--device", device]):
        raise AssertionError(f"run_experiments commands {cmds}")
    # a script without a twin is refused, never run as the JAX script
    exps.write_text(json.dumps({"experiments": [
        {"name": "p", "script": "scripts/torch_multichip_phase.py"}]}))
    try:
        run_experiments.main([str(exps), "--dry-run"] + dev)
    except ValueError:
        pass
    else:
        raise AssertionError("run_experiments took a script without a twin")
    out["run_experiments"] = [" ".join(c[1:]) for c in cmds]
    return out


def log_twins(rec: dict, smi: str) -> None:
    for name in ("train_query_encoder", "train_factorvae",
                 "compare_whitening"):
        r = dict(rec[name])
        h = r.pop("hold")
        log(f"[3l] {name}: {json.dumps(r)}; card vs host over "
            f"{h['steps']} lockstep steps: worst metric rel "
            f"{h['worst_metric_rel']:.3g}, worst gradient rel "
            f"{h['worst_grad_rel']:.3g}, worst parameter excess "
            f"{h['worst_param_excess']:.3g}, unsettled / parted entries "
            f"{h['unsettled']} / {h['parted']} of {h['entries']} | {smi}")
        log(f"[3l] {name} step metrics, card then host: "
            f"{json.dumps([h['metrics_card'], h['metrics_host']])}")
    for name in ("case_study", "visualize_tree", "run_experiments"):
        log(f"[3l] {name}: {json.dumps(rec[name])}")


# -- phase 3m: the experiment scripts' twins -------------------------------

def caches_phase(data, whitener, out_dir: Path, zero, read, device="cuda",
                 size: int = 131072, slice_size: int = 65536,
                 inc=()) -> dict:
    """Phase 3m (a): phase 3d's rows (``data``, its ``whitener``) written
    as a raw cache in ``bench/million``'s layout, then the twins of
    ``derive_caches`` (the whitened cache and a ``slice_size``-row raw
    slice), ``exact_scan`` (at ``size`` rows) and ``incremental_benchmark
    --cache`` (``inc``: its arguments, none: its defaults), each in its
    counter window.  Fails unless the whitened rows are within one float32
    ulp of ``transform_torch`` of the same rows in one call and the slice
    is bit-equal; ``exact_scan``'s ids equal a one-shot ``matmul`` +
    ``topk`` over the same scores but at ties it shows (the twin's id
    scoring within 1e-4 + 1e-6 relative of the one-shot's at that place);
    the new rows' self-hit@10 is 1.0 and both staleness flags hold; on
    the card kernels 1 and 5 launched in the incremental twin's window,
    kernel 5 also for the pending tier."""
    from rag_cobweb_tpu_torch import files
    from rag_cobweb_tpu_torch.scripts import (derive_caches, exact_scan,
                                              incremental_benchmark)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    dev = ["--device", device]
    raw, wpath, spath = (out_dir / "mb_cache_raw.npz",
                         out_dir / "mb_cache_w.npz",
                         out_dir / "mb_cache_raw_slice.npz")
    blob = files.whitener_pickle(whitener)
    t0 = time.perf_counter()
    np.savez(raw, corpus=data.corpus_embs, queries=data.query_embs,
             target_ids=data.target_ids,
             whitener_pickle=np.frombuffer(blob, np.uint8))
    out = {"raw_cache_write_s": time.perf_counter() - t0,
           "rows": len(data.corpus_embs)}

    # derive_caches
    zero()
    t0 = time.perf_counter()
    derive_caches.main(["--raw-cache", str(raw), "--whitened-out",
                        str(wpath), "--raw-slice-out", str(spath),
                        "--raw-slice-size", str(slice_size)] + dev)
    rec = {"s": time.perf_counter() - t0, "window": read()}
    with np.load(wpath) as z:
        cw, qw, tid = z["corpus_w"], z["queries_w"], z["target_ids"]
    ref = whitener.transform_torch(torch.as_tensor(
        data.corpus_embs, device=device)).cpu().numpy()
    diff = np.abs(cw - ref)
    rec["whitened_max_abs_err"] = float(diff.max())
    rec["whitened_max_ulps"] = float((diff / np.spacing(np.abs(ref))).max())
    if rec["whitened_max_ulps"] > 1 or not np.array_equal(
            tid, data.target_ids):
        raise AssertionError(f"3m derive_caches: the whitened cache is not "
                             f"transform_torch's rows: {rec}")
    with np.load(spath) as z:
        same = (np.array_equal(z["corpus"], data.corpus_embs[:slice_size])
                and np.array_equal(z["queries"], data.query_embs)
                and z["whitener_pickle"].tobytes() == blob)
    if not same:
        raise AssertionError("3m derive_caches: the raw slice differs")
    out["derive"] = rec

    # exact_scan against a one-shot scan of the same scores
    zero()
    t0 = time.perf_counter()
    got = exact_scan.main(["--cache", str(wpath), "--size", str(size)]
                          + dev)
    rec = {"s": time.perf_counter() - t0, "window": read(),
           "recall@10": got["recall@10"], "scan_s": got["scan_s"]}
    x = torch.as_tensor(cw[:size], device=device)
    q = torch.as_tensor(qw[tid < size], device=device)
    sc = q @ x.T - 0.5 * torch.sum(x * x, dim=1)[None, :]
    top_s, top_i = torch.topk(sc, 10, dim=1)
    ids = torch.as_tensor(got["ids"], device=device)
    differ = ids != top_i
    mine = sc.gather(1, ids)
    tol = 1e-4 + 1e-6 * top_s.abs()
    bad = differ & ((mine - top_s).abs() > tol)
    rec["ids_differing"] = int(differ.sum())
    rec["ids_differing_beyond_ties"] = int(bad.sum())
    del x, q, sc
    if rec["ids_differing_beyond_ties"]:
        raise AssertionError(f"3m exact_scan against the one-shot scan: "
                             f"{rec}")
    out["exact_scan"] = rec

    # incremental_benchmark on the whitened cache
    zero()
    t0 = time.perf_counter()
    got = incremental_benchmark.main(["--cache", str(wpath)] + list(inc)
                                     + dev)
    win = read()
    out["incremental"] = dict(got, s=time.perf_counter() - t0, window=win)
    if not (got["new_sentence_self_hit@10"] == 1.0 and got["stale_served"]
            and got["overflow_invalidated"]):
        raise AssertionError(f"3m incremental_benchmark: {got}")
    if device != "cpu" and not (win["fused_topk"] > 0
                                and win["rerank_l2"] > 0
                                and win["pending"] > 0):
        raise AssertionError(f"3m incremental_benchmark did not serve "
                             f"through kernels 1 and 5: {win}")
    return out


# The JAX package's recall@10 at pcadim_sweep_10k's fractions where its
# own 1024-row pool leaves golds out, so that it stays below the exact
# whitened scan's (0.912 and 0.915): ``scripts/pcadim_sweep_10k.py`` run
# on the CPU.  There the port is held to the JAX package's recall, as
# phase 3h holds the ZCA forest (``JAX_RECALL``).
JAX_SWEEP_RECALL = {"frac 0.99": 0.896, "frac 0.995": 0.877}

SWEEP_ARGS = {
    "pool_sweep_10k": [],
    "pcadim_sweep_10k": [],
    "tuning_sweep": ["--corpus-size", "10000", "--pools", "0,64,256,1024",
                     "--widths", "2,8"],
    "beam_diag": ["--corpus-size", "2500"],
}


def sweeps_phase(zero, read, device="cuda", args=None,
                 jax_recall=JAX_SWEEP_RECALL) -> dict:
    """Phase 3m (b): the sweep twins as users call them (``args``: each
    twin's arguments, ``SWEEP_ARGS`` by default), each in its counter
    window.  Fails unless every recall@10 served at a pool of 1024 or
    more is within 0.005 of the exact scan over the same whitened rows
    (or, where the JAX package's own pool leaves golds out at these
    settings, of the JAX package's recall: ``jax_recall``), and, on
    the card, kernels 1 and 5 launched in the windows of the three that
    serve pools; ``beam_diag`` runs the beam engine alone, which has no
    kernel, so its window must show no launch."""
    from rag_cobweb_tpu_torch.scripts import (beam_diag, pcadim_sweep_10k,
                                              pool_sweep_10k, tuning_sweep)
    fns = {"pool_sweep_10k": pool_sweep_10k.main,
           "pcadim_sweep_10k": pcadim_sweep_10k.main,
           "tuning_sweep": tuning_sweep.main, "beam_diag": beam_diag.main}
    out = {}
    for name, a in (args or SWEEP_ARGS).items():
        zero()
        t0 = time.perf_counter()
        rec = fns[name](list(a) + ["--device", device])
        out[name] = {"s": time.perf_counter() - t0, "window": read(),
                     "rec": rec}
    served = [(f"pool {p['pool']}", p["recall@10"],
               out["pool_sweep_10k"]["rec"]["exact_whitened"])
              for p in out["pool_sweep_10k"]["rec"]["pools"]
              if p["approx"] == 0 and p["pool"] >= 1024]
    served += [(f"frac {f['frac']}", f["cobweb"], f["exact_whitened"])
               for f in out["pcadim_sweep_10k"]["rec"]["fractions"]]
    tr = out["tuning_sweep"]["rec"]
    served += [(f"tuning pool {p['pool']}", p["recall"],
                tr["exact_whitened"])
               for p in tr["pool_curve"] if p["pool"] >= 1024]
    for what, r, ceiling in served:
        want, of = ((jax_recall[what], "the JAX package's")
                    if what in jax_recall else (ceiling,
                                                "the exact whitened"))
        if not r >= want - 0.005:
            raise AssertionError(f"3m {what}: recall@10 {r} is more than "
                                 f"0.005 below {of} {want}")
    if device != "cpu":
        for name in ("pool_sweep_10k", "pcadim_sweep_10k", "tuning_sweep"):
            w = out[name]["window"]
            if not (w["fused_topk"] > 0 and w["rerank_l2"] > 0):
                raise AssertionError(f"3m {name} did not serve through "
                                     f"kernels 1 and 5: {w}")
        if any(out["beam_diag"]["window"].values()):
            raise AssertionError(f"3m beam_diag launched a kernel: "
                                 f"{out['beam_diag']['window']}")
    out["served"] = served
    return out


SCALE_RUNS = {
    "forest": {"vforest": 64, "max_size": 10000,
               "checkpoints": (5000, 10000)},
    "tree": {"max_size": 1024, "checkpoints": (512, 1024)},
}


def scale_phase(device="cuda", runs=None, queries: int = 1000,
                dim: int = 768, extra=()) -> dict:
    """Phase 3m (c): ``scale_benchmark`` for each run of ``runs``
    (``SCALE_RUNS``: a 64-lane forest to 10000 rows, one tree to 1024
    (no less: its 1000 queries are drawn from its rows);
    ``queries``, ``dim`` and ``extra`` arguments for a host rehearsal).
    Fails unless every checkpoint has every row (the HNSW row where the
    native library loads) and the flat exact row's recall@10 equals a
    host flat scan's (float32 ``2 q.x - ||x||^2``, numpy) over the same
    rows."""
    from rag_cobweb_tpu_torch.bench import native
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.scripts import scale_benchmark
    out = {}
    for name, run in (runs or SCALE_RUNS).items():
        argv = ["--max-size", str(run["max_size"]), "--checkpoints",
                ",".join(map(str, run["checkpoints"])), "--queries",
                str(queries), "--dim", str(dim)] + list(extra)
        if run.get("vforest"):
            argv += ["--vforest", str(run["vforest"])]
        t0 = time.perf_counter()
        rows = scale_benchmark.main(argv + ["--device", device])
        rec = {"s": time.perf_counter() - t0, "rows": rows, "host_flat": []}
        data = synthetic_retrieval(run["max_size"], queries, dim,
                                   n_clusters=max(256,
                                                  run["max_size"] // 256))
        names = ["cobweb_fast", "cobweb_beam", "flat_exact"]
        for row in rows:
            want = names + (["hnsw_cpp"] if native.available()
                            and row["size"] <= 200_000 else [])
            missing = [n for n in want if f"{n}_recall@10" not in row]
            if [r["size"] for r in rows] != list(run["checkpoints"]) \
                    or missing:
                raise AssertionError(f"3m scale_benchmark {name}: rows "
                                     f"{[r['size'] for r in rows]}, "
                                     f"missing {missing}")
            c = data.corpus_embs[:row["size"]]
            mask = data.target_ids < row["size"]
            q = data.query_embs[mask]
            sc = 2.0 * (q @ c.T) - np.sum(c * c, axis=1)[None, :]
            top = np.argpartition(-sc, 10, axis=1)[:, :10]
            host = round(float(np.mean([g in r for g, r in
                                        zip(data.target_ids[mask], top)])),
                         4)
            rec["host_flat"].append(host)
            if row["flat_exact_recall@10"] != host:
                raise AssertionError(
                    f"3m scale_benchmark {name} at {row['size']}: flat "
                    f"exact recall@10 {row['flat_exact_recall@10']}, a "
                    f"host flat scan's {host}")
        out[name] = rec
    return out


def roofline_rows_hold(db, data, zero, read, batches=(32, 1024)) -> dict:
    """Phase 3m (d), inside phase 3b's hook on its served 100k index:
    ``roofline_benchmark.rows`` at ``batches`` in a counter window.  Fails
    unless the blocked kernel launched there and no row's roofline share
    (``bench/roofline.py``) is above 1.05."""
    from rag_cobweb_tpu_torch.scripts import roofline_benchmark
    corpus_w = db.whitener.transform_torch(torch.as_tensor(
        data.corpus_embs, device=db.device)).cpu().numpy()
    queries_w = db.whitener.transform_torch(torch.as_tensor(
        data.query_embs, device=db.device)).cpu().numpy()
    zero()
    t0 = time.perf_counter()
    rows = roofline_benchmark.rows(db, corpus_w, queries_w, batches,
                                   log=lambda *a: log(*a))
    out = {"s": time.perf_counter() - t0, "window": read(), "rows": rows}
    if db.device.type != "cpu" and not out["window"]["blocked_topk"] > 0:
        raise AssertionError(f"3m roofline: the blocked kernel never "
                             f"launched: {out['window']}")
    worst = max(rows, key=lambda r: r["roofline_frac"])
    if worst["roofline_frac"] > 1.05:
        raise AssertionError(f"3m roofline: {worst['engine']} at B="
                             f"{worst['batch']} beyond its bound: {worst}")
    return out


def insert_profile(device="cuda", args=()) -> list:
    """Phase 3m (e): ``profile_insert`` at its defaults (``args`` for a
    host rehearsal).  Fails unless every row was inserted once the cut
    descents were retried on the exact path."""
    from rag_cobweb_tpu_torch.scripts import profile_insert
    recs = profile_insert.main(list(args) + ["--device", device])
    for r in recs:
        if r["inserted_after_retries"] != r["rows"]:
            raise AssertionError(f"3m profile_insert: {r}")
    return recs


def log_experiments(c: dict, sw: dict, sc: dict, roof: dict, prof: list,
                    smi: str) -> None:
    log(f"[3m] raw cache {c['rows']} rows written in "
        f"{c['raw_cache_write_s']:.1f}s; derive_caches "
        f"{json.dumps(c['derive'])} | {smi}")
    log(f"[3m] exact_scan: {json.dumps(c['exact_scan'])} | {smi}")
    log(f"[3m] incremental_benchmark: {json.dumps(c['incremental'])} | "
        f"{smi}")
    for name, r in sw.items():
        if name != "served":
            log(f"[3m] {name} ({r['s']:.1f}s; launches {r['window']}): "
                f"{json.dumps(r['rec'])} | {smi}")
    log(f"[3m] served recall@10 against the exact whitened ceiling: "
        f"{json.dumps(sw['served'])}")
    for name, r in sc.items():
        log(f"[3m] scale_benchmark {name} ({r['s']:.1f}s; host flat "
            f"recall@10 {r['host_flat']}): {json.dumps(r['rows'])} | {smi}")
    log(f"[3m] roofline_benchmark rows on the 100k index ({roof['s']:.1f}s;"
        f" launches {roof['window']}): {json.dumps(roof['rows'])} | {smi}")
    log(f"[3m] profile_insert: {json.dumps(prof)} | {smi}")


# -- phase 3n: the TPU probes' twins ------------------------------------------

# phase 3n's cuts, each with the twin's default: the corpus of
# gather_probe (1M rows), pipeline_probe's and run_8m's sizes (1M and 8M
# rows of a whitened cache; here phase 3m (a)'s 131072), run_8m's halves
# of 65536 rows, ingress_rehearsal's set (2000 rows, 200 targets)
PROBE_CUTS = {"gather_probe": ["--corpus", "262144"],
              "pipeline_probe": {"size": 131072},
              "run_8m": ["--size", "131072", "--halves", "2"],
              "ingress_rehearsal": ["--subset-size", "400", "--target-size",
                                    "60"]}


def probes_phase(flag_db, flag_data, cache: Path, out_dir: Path, zero, read,
                 device="cuda", cuts=None, fast=()) -> dict:
    """Phase 3n: the twins of the reference's TPU probes on the card, each
    called as a user calls it, in its own counter window (``cuts``: the
    sizes cut, ``PROBE_CUTS`` by default; ``fast``: the JAX defaults of
    the cheap probes replaced, for a host rehearsal): (a)
    ``rerank_stage_probe.stages`` on phase 3's served flagship forest
    ``flag_db`` (its ``query_ids`` ids equal its stages', and the plain
    pipeline's but at ties, ``probes.plain_check``); (b)
    ``raw_rerank_probe.probe`` with the flagship's whitener, no refit;
    (c) ``transfer_probe``, ``probe_fused_epilogue`` (kernel 1 against
    the library's pool but at ties, raised inside), ``beam_microbench``,
    ``gather_probe`` (kernel 5 within 1e-4 relative, raised inside), at
    their defaults but ``cuts``; (d) ``pipeline_probe`` on the first rows
    of phase 3m (a)'s whitened cache ``cache`` (kernel 2 must launch in
    its window; its served ids held by ``plain_check``); (e)
    ``ingress_rehearsal`` (its subprocess exits 0, the rows parsed from
    its results file equal those it printed); (f) ``run_8m`` on the same
    cache in two halves (its served ids held by ``plain_check`` on the
    composed index in sentence order; its recall@10 within one query of
    the exact scan's over its bf16 whitened store, the f32 rows' printed
    beside it)."""
    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.probes import plain_check
    from rag_cobweb_tpu_torch.scripts import (
        beam_microbench, gather_probe, ingress_rehearsal, pipeline_probe,
        probe_fused_epilogue, raw_rerank_probe, rerank_stage_probe, run_8m,
        transfer_probe, _sweeps)
    cuts = PROBE_CUTS if cuts is None else cuts
    card = device != "cpu"
    dev = ["--device", device]
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}

    def window(name, fn):
        zero()
        t0 = time.perf_counter()
        r = fn()
        _sweeps.sync(torch.device(device))
        out[name] = {"s": time.perf_counter() - t0, "window": read(),
                     "rec": r}
        return r

    def need(name, *kernels):
        w = out[name]["window"]
        if card and not all(w[k] > 0 for k in kernels):
            raise AssertionError(f"3n {name}: kernels {kernels} did not all "
                                 f"launch: {w}")

    # (a) the flagship forest's stages
    q = flag_data.query_embs
    r = window("rerank_stage_probe", lambda: rerank_stage_probe.stages(
        flag_db, q, 1024, out=lambda *a, **k: log(*a)))
    if not r["stages_equal_query_ids"]:
        raise AssertionError("3n rerank_stage_probe: query_ids' ids differ "
                             "from its stages'")
    r["plain"] = plain_check(flag_db, q, r.pop("served_ids"), 10, 1024, 0,
                             1024, flag_data.corpus_embs,
                             flag_data.target_ids)
    need("rerank_stage_probe", "fused_topk", "rerank_l2")
    # (b) raw-mode forest, the flagship's whitener
    window("raw_rerank_probe", lambda: raw_rerank_probe.probe(
        flag_data, flag_db.whitener, device, out=lambda *a, **k: log(*a)))
    need("raw_rerank_probe", "fused_topk_f32", "rerank_l2")
    # (c) the cheap probes
    window("transfer_probe", lambda: transfer_probe.main(dev))
    if not out["transfer_probe"]["rec"].pop("transfers_exact"):
        raise AssertionError("3n transfer_probe: a transfer changed values")
    out["transfer_probe"]["rec"].pop("product_0")
    for name, mod in (("probe_fused_epilogue", probe_fused_epilogue),
                      ("beam_microbench", beam_microbench),
                      ("gather_probe", gather_probe)):
        args = list(cuts.get(name, [])) + list(dict(fast).get(name, []))
        window(name, lambda m=mod, a=args: m.main(a + dev))
    need("probe_fused_epilogue", "fused_topk")
    need("gather_probe", "rerank_l2")
    for r in out["gather_probe"]["rec"].values():
        r.pop("d2_first")
        r.pop("kernel_d2_first")
    out["probe_fused_epilogue"]["rec"].pop("served_ids")
    # (d) the 1M-row probe on the whitened cache's first rows
    size = cuts.get("pipeline_probe", {}).get("size", 1_000_000)
    pp = dict(dict(fast).get("pipeline_probe", {}))
    with np.load(cache) as z:
        corpus, queries, targets = (z["corpus_w"][:size], z["queries_w"],
                                    z["target_ids"])
    db, build_s = pipeline_probe.build(corpus, pp.get("vforest", 512),
                                       device, log=lambda *a, **k: log(*a))
    B = pp.get("batch", 1024)
    r = window("pipeline_probe", lambda: pipeline_probe.probe(
        db, queries, batch=B, pool=pp.get("pool", 1024),
        log=lambda *a, **k: log(*a)))
    out["pipeline_probe"]["s"] += build_s
    r["config"]["build_s"] = build_s
    r["plain"] = plain_check(db, queries[:B], r.pop("served_ids"), 10,
                             pp.get("pool", 1024), 0, B, corpus)
    need("pipeline_probe", "fused_group_topk", "fused_topk", "rerank_l2")
    del db
    # (e) the ingress rehearsal: the benchmark twin cold in a subprocess
    r = window("ingress_rehearsal", lambda: ingress_rehearsal.main(
        ["--root", str(out_dir / "ingress")]
        + list(cuts.get("ingress_rehearsal", [])) + dev))
    if r["returncode"] != 0 or r["rows"] != r["printed_rows"]:
        raise AssertionError(f"3n ingress_rehearsal: {r}")
    # (f) the two-half build and its composed serving
    args = run_8m.parse(["--cache", str(cache), "--gt-cache", "", "--out",
                         str(out_dir / "run_8m.json")]
                        + list(cuts.get("run_8m", []))
                        + list(dict(fast).get("run_8m", [])) + dev)
    holder = {}

    def r8():
        rec, comp = run_8m.run(args, log=lambda *a, **k: log(*a))
        holder["comp"] = comp
        return rec

    r = window("run_8m", r8)
    comp = holder.pop("comp")
    need("run_8m", "fused_topk", "rerank_l2_bf16", "backstop")
    n = min(args.size, len(corpus))
    served = comp.serve(queries, 10).cpu().numpy()
    store = torch.as_tensor(corpus[:n]).to(torch.bfloat16).float().numpy()
    r["plain"] = plain_check(comp.as_db(), queries, served, 10, args.pool,
                             args.backstop, 512, store)
    # the exact scan over the store's values (the bf16 whitened rows the
    # re-rank reads), the function served; and over the f32 rows
    for key, rows in (("exact_recall@10", store),
                      ("exact_f32_recall@10", corpus[:n])):
        exact = FlatIndex(rows, metric="l2", device=device).search(queries,
                                                                   10)
        r[key] = float(np.mean([t in row for t, row in zip(targets,
                                                           exact)]))
    if abs(r["recall@10"] - r["exact_recall@10"]) > 1.0 / len(queries) + 1e-4:
        raise AssertionError(f"3n run_8m: recall@10 {r['recall@10']} is "
                             f"more than one query from the exact scan's "
                             f"{r['exact_recall@10']} over the same bf16 "
                             f"store")
    del comp
    return out


def log_probes(rec: dict, smi: str) -> None:
    for name, r in rec.items():
        log(f"[3n] {name} ({r['s']:.1f}s; launches {r['window']}): "
            f"{json.dumps(r['rec'], default=str)} | {smi}")


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
    from rag_cobweb_tpu_torch.bench import headline, probes, scale_slice
    from rag_cobweb_tpu_torch.device import full_f32_matmul
    from rag_cobweb_tpu_torch.ops import (_build, blocked_topk,
                                          fused_topk, rerank)

    full_f32_matmul()
    t_start = tp = time.perf_counter()
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
    tp = phase_done("1", tp)

    # -- 2. kernels against their plain versions ------------------------
    main_f = check_fused(fused_topk, *fused_inputs(1024, 496, 10240, 10240,
                                                   seed=0), 1024, reps=20)
    # ragged: 2D = 250 (the wrapper pads qq's rows to 16 bytes for TMA)
    check_fused(fused_topk, *fused_inputs(1000, 250, 10240, 9000, seed=1),
                1024, reps=5)
    check_fused(fused_topk, *fused_inputs(1024, 496, 1 << 20,
                                          (1 << 20) - 1000, seed=2), 16,
                reps=3)
    # the pruned pool at the batch cell's shapes beside the per-slab path
    # it replaces there: the sweep's (1M rows, 2D = 256, pool 512) at B =
    # 32, 256 and 1024, the backstop's (a whitened store of 605 slabs, 2D =
    # 128) at B = 1024, and both through the serving path's entries in a
    # launch window
    fin = fused_inputs(1024, 256, 1 << 20, (1 << 20) - 1000, seed=3)
    pruned = {f"B{B}": check_pruned(fused_topk, fin[0][:B], *fin[1:], 512,
                                    reps=3)
              for B in (32, 256, 1024)}
    win = fused_inputs(1024, 128, 605 * 2048, 1 << 20, seed=4)
    pruned["backstop"] = check_pruned(fused_topk, *win, 512, reps=3,
                                      label=" backstop")
    pruned["window"] = pruned_window(fin, win, 512, probes)
    del fin, win
    torch.cuda.empty_cache()
    # 2D = 1536 (an index at the encoder's width): query boxes carried
    check_fused(fused_topk, *fused_inputs(1024, 1536, 10240, 10000, seed=5),
                1024, reps=5)
    torch.cuda.empty_cache()
    check_rerank(rerank, *rerank_inputs(1024, 1024, 768, 10240, seed=3),
                 reps=20)
    check_rerank(rerank, *rerank_inputs(1024, 1024, 768, 1 << 20, seed=4),
                 reps=5)
    # kernel 5's bf16-row entry (the bf16 re-rank store) at 1M rows, where
    # the gather comes from HBM: half the f32 entry's row bytes
    bf16_1m = check_rerank(rerank, *rerank_inputs(
        1024, 1024, 768, 1 << 20, seed=4, dtype=torch.bfloat16), reps=5)
    # the flagship serving's latency probes give kernels 1 and 5 batches of
    # 1 and 32 as well: each timed there beside its bound and library call
    small = {}
    for B in (1, 32):
        small[f"fused_topk B={B}"] = check_fused(
            fused_topk, *fused_inputs(B, 496, 10240, 10240, seed=10 + B),
            1024, reps=50)
        small[f"rerank_l2 B={B}"] = check_rerank(
            rerank, *rerank_inputs(B, 1024, 768, 10240, seed=20 + B),
            reps=50)
        small[f"fused_group_topk B={B}"] = check_group(
            fused_topk, *group_inputs(B, 496, 10240, 10000, seed=30 + B),
            per_group=2, reps=50)
    log("[kernel] small batches, ms / bound ms / library ms: " + json.dumps(
        {k: [r["ms"], r["bound_ms"], r["library_ms"]]
         for k, r in small.items()}))
    torch.cuda.empty_cache()
    # the blocked index shape the JAX package recorded for the 100k cell
    # (NB=196, M=896, D=128, TS=512, kk=16), dyadic so that every score is
    # exact, at the batch sizes the kernel is timed at on the served index
    # in phase 3b: a check only
    q, bidx = dyadic_blocked(4096, 196, 896, 128, 512, 300, torch.bfloat16,
                             seed=5)
    for B in (1, 8, 32, 1024, 4096):
        check_blocked(blocked_topk, q[:B], bidx, 16, reps=0)
        torch.cuda.empty_cache()
    # TS=1024: each block's slots split over a cluster of CUDA blocks and
    # merged; D=768 (an index without a whitener at the encoder's width):
    # the query tile goes through the ring in segments, timed
    q, bidx = dyadic_blocked(40, 40, 768, 128, 1024, 700, torch.bfloat16,
                             seed=8)
    check_blocked(blocked_topk, q, bidx, 16, reps=0)
    q, bidx = dyadic_blocked(1024, 196, 768, 768, 512, 300, torch.bfloat16,
                             seed=9)
    for B, reps in ((8, 20), (1024, 5)):
        check_blocked(blocked_topk, q[:B], bidx, 16, reps=reps)
    q, bidx = dyadic_blocked(37, 5, 48, 20, 64, 40, torch.float32, seed=6)
    check_blocked(blocked_topk, q, bidx, 8, reps=0)
    del q, bidx
    torch.cuda.empty_cache()
    gin = group_inputs(1024, 496, 10240, 10000, seed=7)
    check_group(fused_topk, *gin, per_group=1, reps=10)
    main_g = check_group(fused_topk, *gin, per_group=2, reps=10)
    del gin
    torch.cuda.empty_cache()
    tp = phase_done("2", tp)

    # -- 3. the flagship slice ------------------------------------------
    zero, read = probes.zero_counters, probes.read_counters
    out_dir = here / "build" / "query_api"    # phase 3f's saved indexes
    mc_dir = here / "build" / "multichip"     # phase 3j's inputs
    launches, windows = {}, {}

    def whitened(db, data, n):
        qs = torch.as_tensor(data.query_embs[:n], device="cuda")
        return db.whitener.transform_torch(qs)

    flag = {}

    def flagship_hook(event, engine, db, data):
        if event == "start":
            zero()
            return
        windows["fused"] = read()
        # kernel 5 on the served pools: the flagship's queries (one batch)
        # and their exact top-1024 pools from kernel 1
        from rag_cobweb_tpu_torch.core.index import fused_query_topk
        fidx = db._fused_index()
        cs, cand = fused_query_topk(fidx, whitened(db, data, 1024), 1024)
        flag["rerank"] = check_rerank(
            rerank, db._emb_device(),
            torch.as_tensor(data.query_embs[:1024], device="cuda"),
            cand.to(torch.int32).contiguous(), cs.contiguous(), reps=20,
            label=" (served pools)", pv=float(db.cfg.prior_var))
        del cs, cand
        flag["split"] = probes.stage_split(db, data.query_embs, 10, 1024)
        flag["gt_shape"] = tuple(fidx.GT.shape)
        # the group pool over the serving FusedIndex, its own window
        qw = whitened(db, data, 1024)
        zero()
        fused_topk.fused_group_topk(fidx, qw, 1024, per_group=2)
        torch.cuda.synchronize()
        windows["group"] = read()
        q = qw.float()
        qq = torch.cat([q, q * q], 1).to(fidx.GT.dtype).contiguous()
        check_group(fused_topk, qq, fidx.GT, fidx.c, fidx.valid, 2, reps=0,
                    label=" (served index)")
        # 3f: the query API on the flagship forest (lane-fair beam)
        flag["api"] = query_api(db, data, zero, read, "flagship forest",
                                out_dir)
        write_multichip_flagship(db, data, mc_dir)
        flag["db"], flag["data"] = db, data     # phase 3n probes it

    rec = headline.run(corpus_size=10000, queries=1000, dim=768,
                       pca_dim=0.96, k=10, batch=1024, dataset="hard",
                       n_lanes=32, rerank=1024, device="cuda",
                       log=lambda *a: log(*a), hook=flagship_hook)[0]
    log(json.dumps(rec))
    flag_exact = rec["exact_recall@10"]      # phase 3j's recall gate
    flag["batch_ms"] = rec["value"] * 1000   # one 1000-query batch (3k d)
    log(f"[slice] kernel launches on the main path: {windows['fused']}")
    log("[slice] flagship stage split, stream ms between CUDA events, one "
        "batch: "
        + json.dumps(flag["split"]) + f" | headline batch ms "
        f"{rec['value'] * flag['split']['B']:.4f}")
    log(f"[slice] group pool over the serving index: {windows['group']}")
    if rec["device"] != name:
        raise AssertionError(f"headline ran on {rec['device']}")
    if not rec["recall@10"] >= rec["exact_recall@10"] - 0.005:
        raise AssertionError(
            f"recall@10 {rec['recall@10']} is more than 0.005 below the "
            f"exact scan's {rec['exact_recall@10']}")
    for k in ("fused_topk", "rerank_l2"):
        if windows["fused"][k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")
    if windows["group"]["fused_group_topk"] <= 0:
        raise AssertionError("fused_group_topk never launched")
    if windows["fused"]["fused_topk_f32"]:
        raise AssertionError("the flagship served an f32 index")
    log_query_api("flagship forest", flag["api"], rec["exact_recall@10"])
    fast_window(flag["api"]["fast_window"], "flagship forest")
    launches["fused_topk"] = windows["fused"]["fused_topk"]
    launches["rerank_l2"] = windows["fused"]["rerank_l2"]
    launches["fused_group_topk"] = windows["group"]["fused_group_topk"]
    torch.cuda.empty_cache()
    tp = phase_done("3", tp)

    # -- 3b. the blocked slice: the 100k cell -----------------------------
    served, served_f, served_g = {}, {}, {}
    last = {}       # phase 3h's records
    exp3m = {}      # phase 3m's inputs and its roofline rows

    def blocked_hook(event, engine, db, data):
        if event == "start":
            zero()
            return
        windows[engine] = read()
        if engine == "fused":
            # kernel 1 held and timed on the cell's served fused index at
            # the batch sizes the serving gives it (kappa = the pool, 512)
            fidx = db._fused_index()
            qw = whitened(db, data, 1024)
            for B, reps in ((1, 50), (32, 50), (1024, 10)):
                qq = fused_topk.query_terms(qw[:B], fidx.GT.dtype)
                served_f[B] = check_fused(
                    fused_topk, qq, fidx.GT, fidx.c, fidx.valid, 512, reps,
                    label=" (served 100k index)")
                served_g[B] = check_group(
                    fused_topk, qq, fidx.GT, fidx.c, fidx.valid, 2, reps,
                    label=" (served 100k index)")
            return
        if engine == "blocked":
            # 3h (c): blocked_query_topk_rerank on the served bf16 blocked
            # index at B=1024, held against a host copy on 64 queries
            last["blocked_rerank"] = blocked_rerank_hold(
                db, whitened(db, data, 1024))
            return
        if engine != "blocked_kernel":
            return
        bidx = db._blocked_index()
        NB, M, TS = bidx.ivt_b.shape[0], bidx.ivt_b.shape[1], \
            bidx.W.shape[2]
        windows["shape"] = (NB, M, TS)
        log(f"[blocked] index NB={NB} M={M} TS={TS} "
            f"D={bidx.ivt_b.shape[2]} {bidx.W.dtype}")
        # the kernel held and timed on the served index, at the batch
        # sizes the serving gives it (1, 8, 32 and 1024: the headline's
        # latency probes and batches) and at 4096, the JAX roofline's
        # largest batch
        qw = whitened(db, data, len(data.query_embs))
        kk = db.pallas_block_k
        for B, reps in ((1, 20), (8, 20), (32, 20), (1024, 10), (4096, 3)):
            served[B] = check_blocked(blocked_topk, qw[:B], bidx, kk, reps,
                                      real=True)
        # 3m (d): the roofline twin's rows on this served index
        exp3m["roofline"] = roofline_rows_hold(db, data, zero, read)

    recs = headline.run(corpus_size=100000, queries=4096, dim=768,
                        pca_dim=128, k=10, batch=1024, dataset="hard",
                        n_lanes=64, rerank=512, device="cuda",
                        engines=("blocked_kernel", "blocked", "fused"),
                        log=lambda *a: log(*a), hook=blocked_hook)
    for r in recs:
        log(json.dumps(r))
        if not r["recall@10"] >= r["exact_recall@10"] - 0.005:
            raise AssertionError(
                f"{r['engine']}: recall@10 {r['recall@10']} is more than "
                f"0.005 below the exact scan's {r['exact_recall@10']}")
    for eng in ("blocked_kernel", "blocked", "fused"):
        log(f"[blocked] {eng} serving launches: {windows[eng]}")
    wk, wb = windows["blocked_kernel"], windows["blocked"]
    if not (wk["blocked_topk"] > 0 and wk["rerank_l2"] > 0
            and wk["fused_topk"] == 0):
        raise AssertionError(f"blocked_kernel did not serve through the "
                             f"blocked and re-rank kernels: {wk}")
    if not (wb["rerank_l2"] > 0 and wb["blocked_topk"] == 0
            and wb["fused_topk"] == 0):
        raise AssertionError(f"blocked did not serve the PyTorch sweep: "
                             f"{wb}")
    launches["blocked_topk"] = wk["blocked_topk"]
    log("[blocked] blocked_topk ms on the served index by batch size: "
        + json.dumps({B: r["ms"] for B, r in sorted(served.items())}))
    for kernel, recs_b in (("fused_topk", served_f),
                           ("fused_group_topk", served_g)):
        log(f"[blocked] {kernel} ms / bound ms / library ms on the served "
            "fused index by batch size: " + json.dumps(
                {B: [r["ms"], r["bound_ms"], r["library_ms"]]
                 for B, r in sorted(recs_b.items())}))

    tp = phase_done("3b", tp)

    # -- 3c. the single-tree slice --------------------------------------
    rec1, single = single_tree_slice(headline, zero, read, windows, launches,
                                     name, out_dir)
    tp = phase_done("3c", tp)

    # 3j's inputs: the single tree, as phase 3i trains on it
    mc_single = write_multichip_single(single["db"], single["data"], mc_dir)

    # -- 3i. training on the card, on 3c's single tree -----------------
    train = training_slice(single.pop("db"), single.pop("data"),
                           here / "build" / "train", smi, epochs=2)
    log_training(train)
    tp = phase_done("3i", tp)
    del train
    torch.cuda.empty_cache()

    # -- 3d. the scale slice: 131072 indexed rows, backstop, adds ------
    scale = {}

    def scale_hook(step, db, data):
        if step == "backstop":
            exp3m["scale_data"] = (data, db.whitener)    # 3m (a)'s rows
            # the backstop's kernel 1 on the served whitened store (kappa
            # 512, the rows past the indexed count invalid)
            GT, half = db._wemb_device()
            qq = whitened(db, data, 1024).to(torch.bfloat16).contiguous()
            valid = torch.arange(GT.shape[1], device="cuda") \
                < db._indexed_count()
            for B, reps in ((1, 50), (32, 50), (1024, 10)):
                scale[B] = check_fused(
                    fused_topk, qq[:B], GT, -half, valid, 512, reps,
                    label=" backstop (served whitened store)", real=True)
        elif step == "pending":
            # kernel 5 at the pending tier's shape: the queries against
            # every pending row of the raw store
            sids = db._pending_rows()[1]
            qs = torch.as_tensor(data.query_embs[:1024], device="cuda")
            cand = sids.to(torch.int32).view(1, -1).expand(
                len(qs), -1).contiguous()
            scale["pending"] = check_rerank(
                rerank, db._emb_device(), qs, cand,
                torch.zeros(cand.shape, device="cuda"), reps=10,
                label=" (pending tier)", pv=float(db.cfg.prior_var))
        elif step == "tools":
            # 3g: the memory tools on this build
            scale["tools"] = memory_tools_slice(db, data, zero, read)

    rec3 = scale_slice.run(device="cuda", log=lambda *a: log(*a),
                           hook=scale_hook)
    log(json.dumps(rec3))
    log(f"[scale] recall@10 with the backstop / without / exact: "
        f"{rec3['backstop_on']['recall@10']} / "
        f"{rec3['backstop_off']['recall@10']} / {rec3['exact_recall@10']};"
        f" after the adds {rec3['after_adds']['recall@10']} / exact "
        f"{rec3['after_adds']['exact_recall@10']}")
    log("[scale] backstop kernel 1 ms / bound ms / library ms by batch "
        "size: " + json.dumps({B: [scale[B]["ms"], scale[B]["bound_ms"],
                                   scale[B]["library_ms"]]
                               for B in (1, 32, 1024)}))
    # counted where the backstop pool and the pending tier launch them
    launches["backstop"] = rec3["windows"]["backstop_on"]["backstop"]
    launches["pending"] = rec3["windows"]["after_adds"]["pending"]
    tools = scale["tools"]
    launches["rerank_l2_bf16"] = tools["a"]["window"]["rerank_l2_bf16"]
    log(f"[tools] recall@10 f32 store / bf16 store / compressed stats: "
        f"{tools['a']['recall@10_f32_store']} / {tools['a']['recall@10']} "
        f"/ {tools['b']['recall@10']}; store bytes "
        f"{tools['a']['store_bytes']}, state bytes "
        f"{tools['b']['state_bytes']}, freed by the offload "
        f"{tools['c']['device_bytes_freed']}; host build "
        f"{tools['d']['cpu_build_s']:.1f}s for {tools['d']['rows']} rows, "
        f"structure equal to the card build: "
        f"{tools['d']['structure_equal_device_build']} (leaves equal: "
        f"{tools['d']['leaves_equal_device_build']}, lanes differing: "
        f"{tools['d']['lanes_differing_from_device_build']})")

    tp = phase_done("3d+3g", tp)

    # -- 3e. the small-forest slice: c=5000, both routings --------------
    small = small_forest_slice(headline, zero, read, out_dir)
    for routing, sf in small.items():
        rec = sf["rec"]
        log(f"[small] {routing}: recall@10 {rec['recall@10']} (exact "
            f"{rec['exact_recall@10']}; plain pipeline "
            f"{sf['plain']['plain_recall@10']}, golds outside the 1024-row "
            f"pool {sf['plain']['golds_outside_pool']}); build "
            f"{rec['build_inserts_per_s']:.1f} inserts/s; ms/query B=750 "
            f"{rec['value']:.6f}, B=1 {rec['b1_latency_ms']:.4f} ms, B=32 "
            f"{rec['b32_latency_ms']:.6f} ms/query; lane rows "
            f"{sf['lane_rows']}, deepest path {sf['max_depth']}")
        log(f"[small] {routing} served vs plain: {sf['plain']}; serving "
            f"launches {sf['window']}; add-64 launches {sf['add_window']}")
        log(f"[small] {routing} stage split, stream ms between CUDA events, "
            f"one batch: " + json.dumps(sf["split"]))
    log_query_api("small forest content", small["content"]["api"],
                  small["content"]["rec"]["exact_recall@10"])
    edge = small["round_robin"]
    log(f"[small] edge forest ({edge['edge']['rows']} rows): {edge['edge']}"
        f"; launches {edge['edge_window']}")
    launches["small_forest"] = small["round_robin"]["window"]["rerank_l2"]

    tp = phase_done("3e", tp)

    # -- 3h. the last single-chip modules ---------------------------------
    last["forests"] = whitener_forests(headline, zero, read, out_dir)
    last["classifier"] = classifier_slice()
    last["grouped"] = grouped_pool_probe()
    for kind, wf in last["forests"].items():
        rec = wf["rec"]
        log(f"[3h] {kind}: fit {rec['whitener_fit_s']:.2f}s, tree dim "
            f"{rec['tree_dim']}, fused index {wf['fused_shape']}; build "
            f"{rec['build_inserts_per_s']:.1f} inserts/s; recall@10 "
            f"{rec['recall@10']} (exact {rec['exact_recall@10']}; plain "
            f"pipeline {wf['plain']['plain_recall@10']}, golds outside the "
            f"1024-row pool {wf['plain']['golds_outside_pool']}); "
            f"ms/query B={wf['B']} "
            f"{rec['value']:.6f}, B=1 {rec['b1_latency_ms']:.4f} ms, B=32 "
            f"{rec['b32_latency_ms']:.6f} ms/query; save {wf['save_s']:.1f}s")
        log(f"[3h] {kind} served vs plain: {wf['plain']}; launches "
            f"{wf['window']}; served ids sha256 {wf['ids_sha256']}")
        log(f"[3h] {kind} stage split, stream ms between CUDA events, one "
            "batch: " + json.dumps(wf["split"]))
    for kind, wf in last["forests"].items():
        rec = wf["rec"]
        # within 0.005 of the exact scan's recall, or, where the JAX
        # package's own pool leaves golds out at these settings, of the
        # JAX package's recall
        want, of = JAX_RECALL.get(kind, (rec["exact_recall@10"],
                                         "the exact scan's"))
        if not rec["recall@10"] >= want - 0.005:
            raise AssertionError(f"{kind}: recall@10 {rec['recall@10']} is "
                                 f"more than 0.005 below {of} {want}")
    log(f"[3h] vforest_beam_topk on the zca forest: "
        f"{last['forests']['zca']['beam']}")
    log(f"[3h] classifier: {json.dumps(last['classifier'])}")
    log(f"[3h] blocked_query_topk_rerank on the 100k blocked index: "
        f"{json.dumps(last['blocked_rerank'])}")
    log(f"[3h] grouped_pool_topk: {json.dumps(last['grouped'])}")
    zca, pcazca = last["forests"]["zca"], last["forests"]["pcazca"]
    del last
    torch.cuda.empty_cache()
    tp = phase_done("3h", tp)

    # -- 3k. the reference's benchmark harness and the encoder -----------
    bench = harness_phase(zero, read, here / "build" / "harness")
    encp = encoder_phase(zero, read, smi, here / "build" / "trace")
    log_benchmark_phase(bench, encp, smi)
    for what, w in (("harness", bench["window"]),
                    ("encoder forest", encp["window"])):
        if not (w["fused_topk"] > 0 and w["rerank_l2"] > 0
                and w["fused_topk_f32"] == 0):
            raise AssertionError(f"the {what} did not serve through "
                                 f"kernels 1 and 5: {w}")
    if not encp["recall@10"] >= encp["exact_recall@10"] - 0.005:
        raise AssertionError(
            f"encoder forest: recall@10 {encp['recall@10']} is more than "
            f"0.005 below the exact scan's {encp['exact_recall@10']}")
    # kernels 1 and 5 at (a)'s and (b)'s served shapes: the harness
    # tree's index at a batch of 256 (the harness's), the encoder
    # forest's at the 1000 queries
    k3 = served_kernels((
        ("harness", bench["db"], torch.as_tensor(bench["queries_w"][:256],
                                                 device="cuda")),
        ("encoder", encp["db"], encp["qw"])))
    launches["3k"] = {name: w for name, w in (("harness", bench["window"]),
                                               ("encoder", encp["window"]))}
    # (d) the roofline of the flagship's served batch (phase 3), and the
    # card's row-gather rate
    from rag_cobweb_tpu_torch.bench import roofline
    twoD, Sp = flag["gt_shape"]
    roof = roofline.product_path_model(
        1000, Sp, twoD // 2, 1024, 768, gt_dtype_bytes=2, d_raw=768
    ).report(flag["batch_ms"] / 1e3, 1000)
    log(f"[3k] roofline of the flagship's served batch (B=1000, Sp={Sp}, "
        f"D_tree={twoD // 2}, C=1024, D_store=768): {json.dumps(roof)} | "
        f"{smi}")
    gather = gather_rate()
    log(f"[3k] row gather emb[idx], B=1024 x C=512 distinct rows of 1M: "
        + json.dumps(gather) + f" | {smi}")
    del bench, encp
    torch.cuda.empty_cache()
    tp = phase_done("3k", tp)

    # -- 3l. the encoder families and the entry points' twins ------------
    fams = families_phase(zero, read, smi, here / "build" / "trace")
    launches["3l"] = {n: e["window"] for n, e in fams.items()}
    twins = twins_phase(here / "build" / "twins")
    log_twins(twins, smi)
    tp = phase_done("3l", tp)

    # -- 3j. multi-device: the port on torch.distributed ------------------
    mc = multichip_phase(flag_exact, mc_dir, *mc_single, forest_rows=1024)
    log_multichip(mc, smi)
    tp = phase_done("3j", tp)
    launches["tp"] = {kern: [w[kern] for w in mc["a"]["windows"]]
                      for kern in ("fused_topk", "rerank_l2")}

    # -- 3m. the experiment scripts' twins ---------------------------------
    caches = caches_phase(*exp3m.pop("scale_data"),
                          here / "build" / "experiments", zero, read,
                          inc=["--size", "50000"])
    sweeps = sweeps_phase(zero, read)
    scal = scale_phase()
    prof = insert_profile()
    log_experiments(caches, sweeps, scal, exp3m["roofline"], prof, smi)
    tp = phase_done("3m", tp)
    twin_windows = {"incremental_benchmark": caches["incremental"]["window"],
                    **{n: r["window"] for n, r in sweeps.items()
                       if n != "served"}}
    launches["3m"] = {kern: {n: w[kern] for n, w in twin_windows.items()
                             if w[kern]}
                      for kern in ("fused_topk", "rerank_l2")}
    launches["3m"]["pending"] = caches["incremental"]["window"]["pending"]
    launches["3m"]["blocked_topk"] = \
        exp3m["roofline"]["window"]["blocked_topk"]
    del caches
    torch.cuda.empty_cache()

    # -- 3n. the TPU probes' twins -----------------------------------------
    exp_dir = here / "build" / "experiments"
    probes_rec = probes_phase(flag.pop("db"), flag.pop("data"),
                              exp_dir / "mb_cache_w.npz", exp_dir / "probes",
                              zero, read)
    log_probes(probes_rec, smi)
    launches["3n"] = {kern: {n: r["window"][kern]
                             for n, r in probes_rec.items()
                             if r["window"][kern]}
                      for kern in ("fused_topk", "fused_topk_f32",
                                   "fused_group_topk", "rerank_l2",
                                   "rerank_l2_bf16", "backstop")}
    del probes_rec
    torch.cuda.empty_cache()
    tp = phase_done("3n", tp)

    # -- 4. result lines ----------------------------------------------------
    src = "rag_cobweb_tpu_torch/csrc/"
    kernels = [
        dict(name="fused_topk", route="cuda", source=src + "fused_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:243",
             launches=launches["fused_topk"], **main_f,
             # phase 2: the pruned pool at the batch cell's shapes (B=1024
             # at the top, the sweep's pool), its launches and overflows
             # in the serving path's window
             pruned=dict(launches=pruned["window"]["fused_topk_pruned"],
                         overflow=pruned["window"]["pool_overflow"],
                         **pruned["B1024"], B32=pruned["B32"],
                         B256=pruned["B256"], backstop=pruned["backstop"]),
             single_tree=dict(launches=windows["single"]["fused_topk"],
                              **single["fused"]),
             backstop=dict(launches=launches["backstop"], **scale[1024],
                           B1=scale[1], B32=scale[32]),
             # 3h: the ZCA forest's served index (2D = 1536), its PCA+ZCA
             # twin inside
             zca=dict(launches=zca["window"]["fused_topk"], **zca["fused"],
                      pcazca=dict(launches=pcazca["window"]["fused_topk"],
                                  **pcazca["fused"])),
             # 3j: each rank's sweep and pool in the fused TP engine (its
             # launches summed over the ranks, then by rank), the record at
             # rank 0's slab
             tp=dict(launches=sum(launches["tp"]["fused_topk"]),
                     by_rank=launches["tp"]["fused_topk"],
                     ranks=mc["world"], **mc["a"]["fused"]),
             # 3k: the harness tree's served index (B=256) and the encoder
             # forest's (B=1000), each in its phase's window
             harness=dict(launches=launches["3k"]["harness"]["fused_topk"],
                          **k3["harness"]["fused"]),
             encoder=dict(launches=launches["3k"]["encoder"]["fused_topk"],
                          **k3["encoder"]["fused"]),
             # 3l: each encoder family's forest, served in its window
             families={n: dict(launches=launches["3l"][n]["fused_topk"],
                               **e["kernels"]["fused"])
                       for n, e in fams.items()},
             # 3m: launches in the windows of the experiment twins that
             # serve pools (the kernel is timed in the rows above)
             twins=dict(launches=sum(launches["3m"]["fused_topk"].values()),
                        by_twin=launches["3m"]["fused_topk"]),
             # 3n: launches in the probe twins' windows (the backstop's
             # inside, counted apart under "backstop")
             probes=dict(launches=sum(launches["3n"]["fused_topk"].values()),
                         by_twin=launches["3n"]["fused_topk"],
                         backstop=launches["3n"]["backstop"])),
        dict(name="rerank_l2", route="cuda", source=src + "rerank_l2.cu",
             replaces="scripts/gather_probe.py:55",
             launches=launches["rerank_l2"], **flag["rerank"],
             single_tree=dict(launches=windows["single"]["rerank_l2"],
                              **single["rerank"]),
             pending=dict(launches=launches["pending"],
                          **scale["pending"]),
             # the bf16-row entry on phase 3g's served pools (bf16 store),
             # and at 1M random rows under "M1"
             bf16=dict(launches=launches["rerank_l2_bf16"],
                       **tools["a"]["rerank"], M1=bf16_1m),
             small_forest=dict(
                 launches=launches["small_forest"],
                 **small["round_robin"]["rerank"],
                 content=dict(launches=small["content"]["window"][
                     "rerank_l2"], **small["content"]["rerank"])),
             zca=dict(launches=zca["window"]["rerank_l2"], **zca["rerank"],
                      pcazca=dict(launches=pcazca["window"]["rerank_l2"],
                                  **pcazca["rerank"])),
             # 3j: each rank's exact re-rank in the fused TP engine, the
             # record on rank 0's pools
             tp=dict(launches=sum(launches["tp"]["rerank_l2"]),
                     by_rank=launches["tp"]["rerank_l2"],
                     ranks=mc["world"], **mc["a"]["rerank"]),
             harness=dict(launches=launches["3k"]["harness"]["rerank_l2"],
                          **k3["harness"]["rerank"]),
             encoder=dict(launches=launches["3k"]["encoder"]["rerank_l2"],
                          **k3["encoder"]["rerank"]),
             families={n: dict(launches=launches["3l"][n]["rerank_l2"],
                               **e["kernels"]["rerank"])
                       for n, e in fams.items()},
             twins=dict(launches=sum(launches["3m"]["rerank_l2"].values()),
                        by_twin=launches["3m"]["rerank_l2"],
                        pending=launches["3m"]["pending"]),
             # 3n: the f32 entry's launches by twin, and the bf16-row
             # entry's (run_8m's bf16 store) under "bf16"
             probes=dict(launches=sum(launches["3n"]["rerank_l2"].values()),
                         by_twin=launches["3n"]["rerank_l2"],
                         bf16=launches["3n"]["rerank_l2_bf16"])),
        # one CUDA kernel and counter for both TPU kernels (_kernel_v2's
        # body is _kernel): the served index at B=1024, and under "B4096"
        # at the batch of _kernel_v2's measurement
        dict(name="blocked_topk", route="cuda",
             source=src + "blocked_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:40; "
                      "rag_cobweb_tpu/ops/pallas_query.py:126",
             launches=launches["blocked_topk"], **served[1024],
             B4096=served[4096],
             # 3m (d): the roofline twin's rows on the same index
             twins=dict(launches=launches["3m"]["blocked_topk"])),
        dict(name="fused_group_topk", route="cuda",
             source=src + "fused_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:270",
             launches=launches["fused_group_topk"], **main_g,
             # 3n: pipeline_probe's grouped arm
             probes=dict(
                 launches=sum(launches["3n"]["fused_group_topk"].values()),
                 by_twin=launches["3n"]["fused_group_topk"])),
        # the f32 entries (CUDA cores) on the single tree's f32 indexes
        dict(name="fused_topk_f32", route="cuda",
             source=src + "fused_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:243",
             launches=launches["fused_topk_f32"],
             **single["fused_f32 B=1024"],
             B1=single["fused_f32 B=1"], B32=single["fused_f32 B=32"],
             # 3n: raw_rerank_probe's rerank=0 pools
             probes=dict(
                 launches=sum(launches["3n"]["fused_topk_f32"].values()),
                 by_twin=launches["3n"]["fused_topk_f32"])),
        dict(name="fused_group_topk_f32", route="cuda",
             source=src + "fused_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:270",
             launches=launches["fused_group_topk_f32"], **single["group_f32"],
             B1=single["group_f32 B=1"], B8=single["group_f32 B=8"],
             B32=single["group_f32 B=32"]),
        dict(name="blocked_topk_f32", route="cuda",
             source=src + "blocked_topk.cu",
             replaces="rag_cobweb_tpu/ops/pallas_query.py:40; "
                      "rag_cobweb_tpu/ops/pallas_query.py:126",
             launches=launches["blocked_topk_f32"],
             **single["blocked_f32 B=1024"], B1=single["blocked_f32 B=1"],
             B8=single["blocked_f32 B=8"], B32=single["blocked_f32 B=32"]),
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
