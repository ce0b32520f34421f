"""Time the blocked sweep kernel of this checkout against the one of
another checkout (``--parent``), in turns on one card.

    python -m rag_cobweb_tpu_torch.bench.blocked_ab --parent DIR

The other checkout's ``csrc/blocked_topk.cu`` is built with the same
``nvcc`` flags into ``build/torch_kernels/`` and called through the same C
entry (``blocked_topk_bf16``).  The index is the 100k cell's of
``chip_smoke.py`` (c=100000, 768-d, PCA to 128, 64 lanes): its served bf16
blocked index (NB=196, M=768, D=128, TS=512) and whitened queries, with
the engine's 16 candidates per block.  At each batch size the serving
gives the kernel (1, 8, 32, 1024) and at 4096, both kernels are held
against the plain version (scores within one bf16 step of every nlp term
weighted by |W|) and timed with CUDA events as parent, this, this,
parent; one JSON line per batch size, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from rag_cobweb_tpu_torch.ops import _build
from rag_cobweb_tpu_torch.ops import blocked_topk as bt


def parent_kernel(parent: Path):
    """The other checkout's bf16 entry, built and loaded."""
    src = parent / "rag_cobweb_tpu_torch" / "csrc" / "blocked_topk.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"libblocked_topk_other_{digest}.so"
    if not so.exists():
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(so)).blocked_topk_bf16
    fn.argtypes = _build._SIGNATURES["blocked_topk"]["blocked_topk_bf16"]
    fn.restype = ctypes.c_int
    return fn


def served_index():
    """The 100k cell built and served once by ``blocked_kernel``: (its
    blocked index, the whitened queries, its candidates per block)."""
    from rag_cobweb_tpu_torch.bench import headline
    got = {}

    def hook(event, engine, db, data):
        if event == "end":
            got["bidx"] = db._blocked_index()
            qs = torch.as_tensor(data.query_embs, device="cuda")
            got["q"] = db.whitener.transform_torch(qs)
            got["kk"] = db.pallas_block_k

    headline.run(corpus_size=100000, queries=4096, dim=768, pca_dim=128,
                 k=10, batch=1024, dataset="hard", n_lanes=64, rerank=512,
                 device="cuda", engines=("blocked_kernel",), hook=hook)
    return got["bidx"], got["q"], got["kk"]


def cuda_ms(fn, reps):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blocked_ab: no CUDA device", file=sys.stderr)
        return 2
    other = parent_kernel(args.parent)
    bidx, queries, kk = served_index()
    NB, M, D = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    for B in (1, 8, 32, 1024, 4096):
        qd, q2 = bt._queries(bidx, queries[:B])
        out_s = torch.empty((NB, B, kk), dtype=torch.float32, device="cuda")
        out_t = torch.empty((NB, B, kk), dtype=torch.int32, device="cuda")
        ptrs = [t.data_ptr() for t in (qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid)]
        stream = torch.cuda.current_stream().cuda_stream

        def run_other():
            _build.check(other(*ptrs, out_s.data_ptr(), out_t.data_ptr(), B,
                               NB, M, D, TS, kk, stream), "other kernel")
            return out_s, out_t

        def run_this():
            return bt._block_candidates(qd, q2, bidx, kk)

        ps, _ = bt.block_candidates_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                          bidx.const_b, bidx.W, bidx.valid,
                                          kk)
        _, nlp = bt.block_scores_plain(qd, q2, bidx.ivt_b, bidx.movt_b,
                                       bidx.const_b, bidx.W, bidx.valid)
        tol = (1e-3 + 1e-3 * ps.abs()
               + torch.matmul(nlp.abs() * 2.0 ** -7,
                              bidx.W.float().abs()).amax(2, keepdim=True))
        del nlp
        errs = {}
        for name, fn in (("other", run_other), ("this", run_this)):
            ks, _ = fn()
            torch.cuda.synchronize()
            err = (ks - ps).abs()
            errs[name] = float(err.max())
            if bool((err > tol).any()):
                raise AssertionError(f"{name} kernel at B={B}: scores off "
                                     f"by {errs[name]:.3g}")
        del tol
        reps = max(3, min(200, 20000 // B))
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            fn = run_other if name == "other" else run_this
            times[name].append(cuda_ms(fn, reps))
        flops = 2.0 * B * NB * M * (2 * D + TS)
        nbytes = (2 * B * D * 2 + 2 * NB * M * D * 2 + NB * M * 4
                  + NB * M * TS * 2 + NB * TS + NB * B * kk * 8)
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        print(json.dumps({"B": B, "NB": NB, "M": M,
                          "D": D, "TS": TS, "kk": kk,
                          "other_ms": times["other"],
                          "this_ms": times["this"], "bound_ms": bound,
                          "max_abs_err": errs}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
