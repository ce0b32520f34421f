"""Time one kernel of this checkout against the same kernel of another
checkout (``--parent``), in turns on one card.

    python -m rag_cobweb_tpu_torch.bench.kernel_ab \\
        --kernel {blocked_topk,blocked_topk_f32,fused_topk,fused_topk_f32,
              fused_group_topk,fused_group_topk_f32,rerank_l2} \\
        --parent DIR

The other checkout's kernel source (``csrc/<source>.cu``, with the headers
beside it; kernel 2, ``fused_group_topk``, lives in ``fused_topk.cu``) is
built with the same ``nvcc`` command into ``build/torch_kernels/`` and
called through its own C entry, whose argument list is read from that
checkout's ``ops/_build.py``.  At each shape both kernels are held against
this checkout's plain version, then timed with CUDA events (device time)
as parent, this, this, parent (and, where a shape names one, the library
call after them); one JSON line per shape, then the card's name and power
limit.  Shapes:

* ``blocked_topk``: the 100k cell's served bf16 blocked index (c=100000,
  768-d, PCA to 128, 64 lanes: NB=196, M=768, D=128, TS=512) and its
  whitened queries, 16 candidates a block, at B = 1, 8, 32, 1024 (the
  batches the serving gives the kernel) and 4096; held within one bf16
  step of every nlp term weighted by |W| (the cell is built first, ~1
  min);
* ``blocked_topk_f32``: the blocked sweep's f32 entry on a random dyadic
  f32 blocked index of the single tree's shape (NB=20, M=768, D=248,
  TS=512, 272 valid slots in the last block, kk=10), so no tree is built
  and every nlp term and score is exact in f32 in any order: at B = 1, 8,
  32 and 1000 both kernels give the plain version's scores and ids
  exactly; each line adds the bound (67 TFLOP/s f32, 3.35 TB/s) and the
  library call (3 ``bmm`` + ``topk``, f32 with TF32 off) timed in the same
  turns;
* ``fused_topk``: the flagship's served fused index (c=10000, 768-d, PCA
  0.96, 32 lanes: 2D=496, Sp=10240) with its whitened queries and
  kappa=1024 at B = 1, 32 and 1000 (its batch), the 100k cell's (2D=256,
  Sp=100352, kappa=512) at B = 1, 32 and 1024, then random bf16 inputs of
  the flagship shape at B=1024 and of 1M rows with kappa=16; sorted pool
  scores within 1e-3 + 1e-3 |score| (both cells are built first, ~1 min);
* ``fused_topk_f32``: kernel 1's f32 entry on random dyadic f32 fused
  indexes, so every score is exact in f32 in any order and ties are
  exact: the single tree's shape (2D=496, Sp=10240, 10000 valid rows) at
  kappa 10 and B = 1, 8, 32 and 1000, and at kappa 1024 and B=1000 (the
  f32 re-rank pool); the 100k shape (2D=256, Sp=100352, 100000 valid
  rows) at kappa 10 and B = 1 and 1024.  Both kernels give the plain
  version's pools exactly (scores and ids, each slab's pool sorted); each
  line adds the bound (67 TFLOP/s f32, 3.35 TB/s) and the library call
  (``matmul`` + ``topk``, TF32 off) timed in the same turns;
* ``fused_group_topk``: the same served indexes and batches, and random
  bf16 inputs of the flagship shape at B=1024, per_group=2; scores in
  round order within 1e-3 + 1e-3 |score|, each id carrying its score
  within that, exhausted rounds (NEG) at the plain version's rows;
* ``fused_group_topk_f32``: kernel 2's f32 entry on random dyadic f32
  fused indexes, as ``fused_topk_f32``: the single tree's shape (2D=496,
  Sp=10240, 10000 valid rows) at per_group 2 and B = 1, 8, 32 and 1000,
  and at per_group 128 and B=32 with group 3 cut to 50 valid rows (its
  last 78 rounds exhausted); the 100k shape (2D=256, Sp=100352, 100000
  valid rows) at per_group 2 and B = 1 and 1024.  Both kernels give the
  plain version's rounds exactly (scores and ids, in round order); each
  line adds the bound (67 TFLOP/s f32, 3.35 TB/s) and the library call
  (``matmul`` + ``topk`` over (B, NS 16, 128), TF32 off) timed in the
  same turns;
* ``rerank_l2``: the flagship's served pools (its 1000 queries' exact
  top-1024 from kernel 1, the raw 768-d store), then uniform random
  candidates (C=1024, D=768, some -inf) on 10240 rows at B = 1, 32 and
  1024 and on 1M rows at B=1024; within 1e-5 of the larger term of lp.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from rag_cobweb_tpu_torch.ops import _build

KERNELS = ("blocked_topk", "blocked_topk_f32", "fused_topk",
           "fused_topk_f32", "fused_group_topk", "fused_group_topk_f32",
           "rerank_l2")
ENTRY = {"blocked_topk": "blocked_topk_bf16",
         "blocked_topk_f32": "blocked_topk_f32",
         "fused_topk": "fused_topk_bf16",
         "fused_topk_f32": "fused_topk_f32",
         "fused_group_topk": "fused_group_topk_bf16",
         "fused_group_topk_f32": "fused_group_topk_f32",
         "rerank_l2": "rerank_l2"}
SOURCE = {"blocked_topk_f32": "blocked_topk",   # else the kernel's own name
          "fused_topk_f32": "fused_topk", "fused_group_topk": "fused_topk",
          "fused_group_topk_f32": "fused_topk"}


def parent_entry(parent: Path, kernel: str):
    """The other checkout's C entry of ``kernel``, built and loaded, with
    the argument types of that checkout's ``_build.py``."""
    pkg = parent / "rag_cobweb_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "_parent_build", pkg / "ops" / "_build.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    source = SOURCE.get(kernel, kernel)
    src = pkg / "csrc" / f"{source}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"lib{source}_other_{_build.digest(src)}.so"
    if not so.exists():
        subprocess.run(_build.nvcc_command(src, so), check=True)
    fn = getattr(ctypes.CDLL(str(so)), ENTRY[kernel])
    fn.argtypes = other._SIGNATURES[source][ENTRY[kernel]]
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls; the calls queue
    behind a sleeping kernel, so the host's launch time is not counted."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e5 * reps))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def served(cell: str, engine: str) -> dict:
    """A cell built and served once by ``engine``, as ``chip_smoke.py``
    serves it: its index object, whitened and raw queries, and store."""
    from rag_cobweb_tpu_torch.bench import headline
    got = {}

    def hook(event, engine, db, data):
        if event == "end":
            qs = torch.as_tensor(data.query_embs, device="cuda")
            got.update(db=db, raw=qs, q=db.whitener.transform_torch(qs))

    if cell == "100k":
        headline.run(corpus_size=100000, queries=4096, dim=768, pca_dim=128,
                     k=10, batch=1024, dataset="hard", n_lanes=64,
                     rerank=512, device="cuda", engines=(engine,), hook=hook)
    else:
        headline.run(corpus_size=10000, queries=1000, dim=768, pca_dim=0.96,
                     k=10, batch=1024, dataset="hard", n_lanes=32,
                     rerank=1024, device="cuda", engines=(engine,),
                     hook=hook)
    return got


def served_index():
    """The 100k cell's blocked index, whitened queries and candidates per
    block (``blocked_phases.py`` uses it too)."""
    got = served("100k", "blocked_kernel")
    db = got["db"]
    return db._blocked_index(), got["q"], db.pallas_block_k


def blocked_cases(other):
    """(shape, this, other, check) at each batch size of the served index."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    bidx, queries, kk = served_index()
    NB, M, D = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    for B in (1, 8, 32, 1024, 4096):
        qd, q2 = bt._queries(bidx, queries[:B])
        out_s = torch.empty((NB, B, kk), dtype=torch.float32, device="cuda")
        out_t = torch.empty((NB, B, kk), dtype=torch.int32, device="cuda")
        ptrs = [t.data_ptr() for t in (qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid)]

        def run_other():
            _build.check(other(*ptrs, out_s.data_ptr(), out_t.data_ptr(), B,
                               NB, M, D, TS, kk,
                               torch.cuda.current_stream().cuda_stream),
                         "other kernel")
            return out_s

        ps, _ = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                          bidx.const_b, bidx.W, bidx.valid,
                                          kk)
        _, nlp = bt.block_scores_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid)
        tol = (1e-3 + 1e-3 * ps.abs()
               + torch.matmul(nlp.abs() * 2.0 ** -7,
                              bidx.W.float().abs()).amax(2, keepdim=True))
        del nlp

        def check(ks, ps=ps, tol=tol):
            err = (ks - ps).abs()
            return float(err.max()), bool((err <= tol).all())

        flops = 2.0 * B * NB * M * (2 * D + TS)
        nbytes = (2 * B * D * 2 + 2 * NB * M * D * 2 + NB * M * 4
                  + NB * M * TS * 2 + NB * TS + NB * B * kk * 8)
        yield ({"B": B, "NB": NB, "M": M, "D": D, "TS": TS, "kk": kk,
                "bound_ms": max(flops / 989e12, nbytes / 3.35e12) * 1e3},
               lambda qd=qd, q2=q2: bt._block_candidates(qd, q2, bidx,
                                                         kk)[0],
               run_other, check)


def dyadic_f32_index(NB, M, D, TS, S_last, seed):
    """A random f32 blocked index whose nlp terms and scores are exact in
    f32 in any order (small multiples of powers of two; W holds ~12 weights
    of 0.5 or 1 per slot, as a path does), so ties are exact and go to the
    lower slot in every version.  The last block has ``S_last`` valid
    slots."""
    from rag_cobweb_tpu_torch.core.index import BlockedIndex
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device="cuda").float()

    W = ints(1, 3, (NB, M, TS)) / 2
    W = torch.where(torch.rand((NB, M, TS), generator=g, device="cuda")
                    < 12.0 / M, W, torch.zeros_like(W))
    valid = torch.ones((NB, TS), dtype=torch.bool, device="cuda")
    valid[-1, S_last:] = False
    return BlockedIndex(
        ivt_b=ints(1, 17, (NB, M, D)) / 16,
        movt_b=ints(-8, 9, (NB, M, D)) / 16,
        const_b=ints(-64, 65, (NB, M)) / 4, W=W.contiguous(), valid=valid,
        sid_of_slot=torch.arange(NB * TS, device="cuda",
                                 dtype=torch.int32).view(NB, TS))


def blocked_f32_cases(other):
    """The single tree's f32 blocked shape on a dyadic index: scores and
    ids equal to the plain version's, with the library call beside."""
    from rag_cobweb_tpu_torch.ops import blocked_topk as bt
    NB, M, D, TS, kk = 20, 768, 248, 512, 10
    bidx = dyadic_f32_index(NB, M, D, TS, 10000 - 19 * TS, seed=8)
    g = torch.Generator(device="cuda").manual_seed(9)
    queries = torch.randint(-8, 9, (1000, D), generator=g,
                            device="cuda").float() / 8
    for B in (1, 8, 32, 1000):
        qd, q2 = bt._queries(bidx, queries[:B])
        out_s = torch.empty((NB, B, kk), dtype=torch.float32, device="cuda")
        out_t = torch.empty((NB, B, kk), dtype=torch.int32, device="cuda")
        ptrs = [t.data_ptr() for t in (qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid)]

        def run_other():
            _build.check(other(*ptrs, out_s.data_ptr(), out_t.data_ptr(), B,
                               NB, M, D, TS, kk,
                               torch.cuda.current_stream().cuda_stream),
                         "other kernel")
            return out_s, out_t

        ps, pi = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                           bidx.const_b, bidx.W, bidx.valid,
                                           kk)

        def check(out, ps=ps, pi=pi):
            ks, ki = out
            err = (ks - ps).abs()
            return float(err.max()), bool(
                (err <= 1e-3 + 1e-3 * ps.abs()).all()
                and torch.equal(ki, pi))

        def library(qd=qd, q2=q2, B=B):
            qT = qd.T.unsqueeze(0).expand(NB, D, B)
            q2T = q2.T.unsqueeze(0).expand(NB, D, B)
            nl = (torch.bmm(bidx.movt_b, qT) - 0.5 * torch.bmm(bidx.ivt_b, q2T)
                  + bidx.const_b.unsqueeze(2))
            sc = torch.bmm(bidx.W.transpose(1, 2), nl)
            sc.masked_fill_(~bidx.valid.unsqueeze(2), bt.NEG)
            return torch.topk(sc, kk, dim=1)

        flops = 2.0 * B * NB * M * (2 * D + TS)
        nbytes = (4 * (2 * B * D + 2 * NB * M * D + NB * M + NB * M * TS)
                  + NB * TS + NB * B * kk * 8)
        yield ({"B": B, "NB": NB, "M": M, "D": D, "TS": TS, "kk": kk,
                "bound_ms": max(flops / 67e12, nbytes / 3.35e12) * 1e3},
               lambda qd=qd, q2=q2: bt._block_candidates(qd, q2, bidx, kk),
               run_other, check, library)


def fused_cases(other):
    from rag_cobweb_tpu_torch.ops import fused_topk as ft

    def case(label, qq, GT, c, valid, kappa):
        B, twoD = qq.shape
        Sp = GT.shape[1]
        NS = Sp // ft.SLAB
        out_s = torch.empty((NS, B, kappa), device="cuda")
        out_i = torch.empty((NS, B, kappa), dtype=torch.int32, device="cuda")

        def run_other():
            _build.check(other(qq.data_ptr(), GT.data_ptr(), c.data_ptr(),
                               valid.data_ptr(), out_s.data_ptr(),
                               out_i.data_ptr(), B, twoD, Sp, kappa,
                               torch.cuda.current_stream().cuda_stream),
                         "other kernel")
            return out_s

        ps, _ = ft.slab_topk_plain(qq, GT, c, valid, kappa)

        def check(ks):
            ks = torch.sort(ks, dim=2, descending=True).values
            fin = torch.isfinite(ps)
            if not torch.equal(fin, torch.isfinite(ks)):
                return math.inf, False
            err = (ks[fin] - ps[fin]).abs()
            return float(err.max()), bool(
                (err <= 1e-3 + 1e-3 * ps[fin].abs()).all())

        nbytes = qq.numel() * 2 + GT.numel() * 2 + Sp * 5 + NS * B * kappa * 8
        return ({"inputs": label, "B": B, "2D": twoD, "Sp": Sp,
                 "kappa": kappa,
                 "bound_ms": max(2.0 * B * twoD * Sp / 989e12,
                                 nbytes / 3.35e12) * 1e3},
                lambda: ft.slab_topk(qq, GT, c, valid, kappa)[0],
                run_other, check)

    for cell, kappa, batches in (("flagship", 1024, (1, 32, 1000)),
                                 ("100k", 512, (1, 32, 1024))):
        got = served(cell, "fused")
        fidx = got["db"]._fused_index()
        for B in batches:
            yield case(f"served {cell}", ft.query_terms(got["q"][:B],
                                                        fidx.GT.dtype),
                       fidx.GT, fidx.c, fidx.valid, kappa)
        del got, fidx
    for B, twoD, Sp, kappa in ((1024, 496, 10240, 1024),
                               (1024, 496, 1 << 20, 16)):
        g = torch.Generator(device="cuda").manual_seed(B + Sp)
        q = torch.randn((B, twoD // 2), generator=g, device="cuda")
        qq = torch.cat([q, q * q], 1).to(torch.bfloat16).contiguous()
        GT = (0.05 * torch.randn((twoD, Sp), generator=g, device="cuda")) \
            .to(torch.bfloat16).contiguous()
        c = torch.randn((Sp,), generator=g, device="cuda")
        valid = torch.arange(Sp, device="cuda") < Sp - 1000
        yield case("random", qq, GT, c, valid, kappa)


def dyadic_fused_index(twoD, Sp, S, n_queries, seed):
    """A random f32 fused index (GT, c, valid; ``S`` valid rows) and
    ``n_queries`` queries whose scores are exact in f32 in any order
    (small multiples of powers of two), so ties are exact and go to the
    lower row in every version."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device="cuda").float()

    GT = (ints(-16, 17, (twoD, Sp)) / 16).contiguous()
    c = ints(-64, 65, (Sp,)) / 4
    valid = torch.arange(Sp, device="cuda") < S
    return GT, c, valid, ints(-8, 9, (n_queries, twoD)) / 8


def fused_f32_cases(other):
    """Kernel 1's f32 entry on dyadic f32 fused indexes: pools equal to
    the plain version's, with the library call beside."""
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    for twoD, Sp, S, kappa, batches in ((496, 10240, 10000, 10,
                                         (1, 8, 32, 1000)),
                                        (496, 10240, 10000, 1024, (1000,)),
                                        (256, 100352, 100000, 10,
                                         (1, 1024))):
        GT, c, valid, queries = dyadic_fused_index(twoD, Sp, S, max(batches),
                                                   seed=twoD + Sp + kappa)
        NS = Sp // ft.SLAB
        for B in batches:
            qq = queries[:B].contiguous()
            out_s = torch.empty((NS, B, kappa), device="cuda")
            out_i = torch.empty((NS, B, kappa), dtype=torch.int32,
                                device="cuda")

            def run_other(qq=qq, B=B, out_s=out_s, out_i=out_i):
                _build.check(other(qq.data_ptr(), GT.data_ptr(),
                                   c.data_ptr(), valid.data_ptr(),
                                   out_s.data_ptr(), out_i.data_ptr(), B,
                                   twoD, Sp, kappa,
                                   torch.cuda.current_stream().cuda_stream),
                             "other kernel")
                return out_s, out_i

            ps, pi = ft.slab_topk_plain(qq, GT, c, valid, kappa)

            def check(out, ps=ps, pi=pi):
                ks, ki = out
                ks = torch.sort(ks, dim=2, descending=True).values
                fin = torch.isfinite(ps)
                err = (float((ks[fin] - ps[fin]).abs().max())
                       if bool(fin.any()) else 0.0)
                return err, bool(
                    torch.equal(ks, ps)
                    and torch.equal(torch.sort(ki, dim=2).values,
                                    torch.sort(pi, dim=2).values))

            def library(qq=qq, B=B):
                s = torch.matmul(qq, GT) + c
                s.masked_fill_(~valid, -math.inf)
                return torch.topk(s.view(B, NS, ft.SLAB), kappa, dim=2)

            nbytes = (4 * (B * twoD + twoD * Sp + Sp) + Sp
                      + NS * B * kappa * 8)
            yield ({"B": B, "2D": twoD, "Sp": Sp, "valid": S,
                    "kappa": kappa,
                    "bound_ms": max(2.0 * B * twoD * Sp / 67e12,
                                    nbytes / 3.35e12) * 1e3},
                   lambda qq=qq: ft.slab_topk(qq, GT, c, valid, kappa),
                   run_other, check, library)
        del GT, c, valid, queries


def group_cases(other):
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    per_group = 2                   # pallas_fused_group_topk's default

    def case(label, qq, GT, c, valid):
        B, twoD = qq.shape
        Sp = GT.shape[1]
        NS, KO = Sp // ft.SLAB, per_group * ft.NG
        out_s = torch.empty((NS, B, KO), device="cuda")
        out_i = torch.empty((NS, B, KO), dtype=torch.int32, device="cuda")

        def run_other():
            _build.check(other(qq.data_ptr(), GT.data_ptr(), c.data_ptr(),
                               valid.data_ptr(), out_s.data_ptr(),
                               out_i.data_ptr(), B, twoD, Sp, per_group,
                               torch.cuda.current_stream().cuda_stream),
                         "other kernel")
            return out_s, out_i

        ps, pi = ft.slab_group_topk_plain(qq, GT, c, valid, per_group)
        full = ft.slab_scores_plain(qq, GT, c, valid, ft.NEG) \
            .permute(1, 0, 2)
        base = (torch.arange(NS, device="cuda") * ft.SLAB).view(NS, 1, 1)
        tol = 1e-3 + 1e-3 * ps.abs()
        neg = ps <= ft.NEG / 2

        def check(out):
            ks, ki = out
            err = (ks - ps).abs()
            at = full.gather(2, (ki - base).long())
            ok = (bool((err <= tol).all())
                  and torch.equal(neg, ks <= ft.NEG / 2)
                  and torch.equal(ki[neg], pi[neg])
                  and bool(((at - ks).abs() <= tol)[~neg].all()))
            return float(err.max()), ok

        nbytes = qq.numel() * 2 + GT.numel() * 2 + Sp * 5 + NS * B * KO * 8
        return ({"inputs": label, "B": B, "2D": twoD, "Sp": Sp,
                 "per_group": per_group,
                 "bound_ms": max(2.0 * B * twoD * Sp / 989e12,
                                 nbytes / 3.35e12) * 1e3},
                lambda: ft.slab_group_topk(qq, GT, c, valid, per_group),
                run_other, check)

    for cell, batches in (("flagship", (1, 32, 1000)),
                          ("100k", (1, 32, 1024))):
        got = served(cell, "fused")
        fidx = got["db"]._fused_index()
        for B in batches:
            yield case(f"served {cell}", ft.query_terms(got["q"][:B],
                                                        fidx.GT.dtype),
                       fidx.GT, fidx.c, fidx.valid)
        del got, fidx
    g = torch.Generator(device="cuda").manual_seed(7)
    B, twoD, Sp = 1024, 496, 10240
    q = torch.randn((B, twoD // 2), generator=g, device="cuda")
    qq = torch.cat([q, q * q], 1).to(torch.bfloat16).contiguous()
    GT = (0.05 * torch.randn((twoD, Sp), generator=g, device="cuda")) \
        .to(torch.bfloat16).contiguous()
    c = torch.randn((Sp,), generator=g, device="cuda")
    yield case("random", qq, GT, c, torch.arange(Sp, device="cuda") < 10000)


def group_f32_cases(other):
    """Kernel 2's f32 entry on dyadic f32 fused indexes: rounds equal to
    the plain version's, with the library call beside."""
    from rag_cobweb_tpu_torch.ops import fused_topk as ft
    for twoD, Sp, S, per_group, batches in ((496, 10240, 10000, 2,
                                             (1, 8, 32, 1000)),
                                            (496, 10240, 10000, 128, (32,)),
                                            (256, 100352, 100000, 2,
                                             (1, 1024))):
        GT, c, valid, queries = dyadic_fused_index(twoD, Sp, S, max(batches),
                                                   seed=twoD + Sp + per_group)
        if per_group == ft.GROUP:
            # group 3 keeps 50 valid rows: its last 78 rounds are exhausted
            valid[3 * ft.GROUP + 50:4 * ft.GROUP] = False
        NS, KO = Sp // ft.SLAB, per_group * ft.NG
        for B in batches:
            qq = queries[:B].contiguous()

            def run_other(qq=qq, B=B):
                # outputs allocated a call, as the wrapper does: both sides
                # write to the caching allocator's blocks in turn
                out_s = torch.empty((NS, B, KO), device="cuda")
                out_i = torch.empty((NS, B, KO), dtype=torch.int32,
                                    device="cuda")
                _build.check(other(qq.data_ptr(), GT.data_ptr(),
                                   c.data_ptr(), valid.data_ptr(),
                                   out_s.data_ptr(), out_i.data_ptr(), B,
                                   twoD, Sp, per_group,
                                   torch.cuda.current_stream().cuda_stream),
                             "other kernel")
                return out_s, out_i

            ps, pi = ft.slab_group_topk_plain(qq, GT, c, valid, per_group)

            def check(out, ps=ps, pi=pi):
                ks, ki = out
                return (float((ks - ps).abs().max()),
                        torch.equal(ks, ps) and torch.equal(ki, pi))

            def library(qq=qq, B=B):
                s = torch.matmul(qq, GT) + c
                s.masked_fill_(~valid, ft.NEG)
                return torch.topk(s.view(B, NS * ft.NG, ft.GROUP), per_group,
                                  dim=2)

            nbytes = (4 * (B * twoD + twoD * Sp + Sp) + Sp
                      + NS * B * KO * 8)
            yield ({"B": B, "2D": twoD, "Sp": Sp, "valid": int(valid.sum()),
                    "per_group": per_group,
                    "bound_ms": max(2.0 * B * twoD * Sp / 67e12,
                                    nbytes / 3.35e12) * 1e3},
                   lambda qq=qq: ft.slab_group_topk(qq, GT, c, valid,
                                                    per_group),
                   run_other, check, library)
        del GT, c, valid, queries


def rerank_cases(other):
    from rag_cobweb_tpu_torch.core.index import fused_query_topk
    from rag_cobweb_tpu_torch.ops import rerank
    pv = 1.0 / (2.0 * math.e * math.pi)

    def case(label, emb, q, cand, cs):
        (S, D), (B, C) = emb.shape, cand.shape
        out = torch.empty((B, C), device="cuda")
        d_log_pv = D * math.log(pv)

        def run_other():
            _build.check(other(emb.data_ptr(), q.data_ptr(), cand.data_ptr(),
                               cs.data_ptr(), out.data_ptr(), B, C, D, pv,
                               d_log_pv,
                               torch.cuda.current_stream().cuda_stream),
                         "other kernel")
            return out

        lp = rerank.rerank_lp_plain(emb, q, cand, cs, pv)

        def check(lk):
            fin = torch.isfinite(lp)
            if not torch.equal(fin, torch.isfinite(lk)):
                return math.inf, False
            err = (lk[fin] - lp[fin]).abs()
            tol = 1e-5 * (lp[fin].abs() + 0.5 * abs(d_log_pv))
            return float(err.max()), bool((err <= tol).all())

        rows = int(torch.unique(cand[torch.isfinite(cs)]).numel())
        nbytes = rows * D * 4 + B * D * 4 + 3 * B * C * 4
        flops = 3.0 * int(torch.isfinite(cs).sum()) * D
        return ({"inputs": label, "B": B, "C": C, "D": D, "S": S,
                 "distinct_rows": rows,
                 "bound_ms": max(nbytes / 3.35e12, flops / 67e12) * 1e3},
                lambda: rerank.rerank_lp(emb, q, cand, cs, pv), run_other,
                check)

    got = served("flagship", "fused")
    db = got["db"]
    cs, cand = fused_query_topk(db._fused_index(), got["q"], 1024)
    yield case("served flagship pools", db._emb_device(), got["raw"],
               cand.to(torch.int32).contiguous(), cs.contiguous())
    del got, db, cs, cand
    for B, S in ((1, 10240), (32, 10240), (1024, 10240), (1024, 1 << 20)):
        C, D = 1024, 768
        g = torch.Generator(device="cuda").manual_seed(B + S)
        emb = torch.randn((S, D), generator=g, device="cuda")
        q = torch.randn((B, D), generator=g, device="cuda")
        cand = torch.randint(0, S, (B, C), generator=g, device="cuda",
                             dtype=torch.int32)
        cs = torch.randn((B, C), generator=g, device="cuda")
        cs[:, -7:] = -math.inf
        yield case("random", emb, q, cand, cs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, choices=KERNELS)
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from rag_cobweb_tpu_torch.device import full_f32_matmul
    full_f32_matmul()
    _build.build_all()
    other = parent_entry(args.parent, args.kernel)
    cases = {"blocked_topk": blocked_cases,
             "blocked_topk_f32": blocked_f32_cases,
             "fused_topk": fused_cases, "fused_topk_f32": fused_f32_cases,
             "fused_group_topk": group_cases,
             "fused_group_topk_f32": group_f32_cases,
             "rerank_l2": rerank_cases}[args.kernel](other)
    for shape, run_this, run_other, check, *library in cases:
        errs = {}
        for name, fn in (("other", run_other), ("this", run_this)):
            out = fn()
            torch.cuda.synchronize()
            err, ok = check(out)
            errs[name] = err
            if not ok:
                raise AssertionError(f"{name} {args.kernel} at {shape}: off "
                                     f"the plain version by {err:.3g}")
        B = shape["B"]
        reps = max(3, min(200, 20000 // B))
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            fn = run_other if name == "other" else run_this
            times[name].append(cuda_ms(fn, reps))
        lib = {"library_ms": cuda_ms(library[0], reps)} if library else {}
        print(json.dumps({"kernel": args.kernel, **shape,
                          "other_ms": times["other"],
                          "this_ms": times["this"], **lib,
                          "max_abs_err": errs}),
              flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
