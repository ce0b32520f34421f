"""How often kernel 1's guessed key windows hold, on the served indexes.

    python -m rag_cobweb_tpu_torch.bench.fused_guess

Kernel 1 (``csrc/fused_topk.cu``) starts the select of an item from a
guessed window of 2^24 keys around each query's kappa-th key of the
cluster's last item, where the cluster keeps one query tile (B <= 64 and
more slabs than clusters); a query whose kappa-th key is outside starts
over, one pass more.  This script builds the kernel with
``-DFUSED_GUESS_STATS`` (into ``build/torch_kernels/``), which counts, for
every guessed (query, item), whether the window held, and runs it on the
flagship's and the 100k cell's served fused indexes (``kernel_ab.py``'s
cells, built first, ~1 min) at the batches the serving gives it.  One
JSON line per shape, then the card's name and power limit.  The counts
cost an atomic a guessed query; time the kernel with ``kernel_ab.py``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from rag_cobweb_tpu_torch.ops import _build
from rag_cobweb_tpu_torch.ops import fused_topk as ft


def build():
    src = _build._CSRC / "fused_topk.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"fused_guess_{_build.digest(src)}.so"
    if not so.exists():
        subprocess.run(_build.nvcc_command(src, so, "-DFUSED_GUESS_STATS"),
                       check=True)
    lib = ctypes.CDLL(str(so))
    lib.fused_topk_bf16.argtypes = \
        _build._SIGNATURES["fused_topk"]["fused_topk_bf16"]
    lib.read_guess_stats.argtypes = [ctypes.c_void_p]
    for fn in (lib.fused_topk_bf16, lib.read_guess_stats):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_guess: no CUDA device", file=sys.stderr)
        return 2
    from rag_cobweb_tpu_torch.bench.kernel_ab import served
    lib = build()
    stats = np.zeros(2, np.uint64)
    for cell, kappa, batches in (("flagship", 1024, (1, 32, 1000)),
                                 ("100k", 512, (1, 32, 1024))):
        got = served(cell, "fused")
        fidx = got["db"]._fused_index()
        Sp = fidx.GT.shape[1]
        for B in batches:
            qq = ft.query_terms(got["q"][:B], fidx.GT.dtype)
            out_s = torch.empty((Sp // ft.SLAB, B, kappa), device="cuda")
            out_i = torch.empty((Sp // ft.SLAB, B, kappa), dtype=torch.int32,
                                device="cuda")
            _build.check(lib.read_guess_stats(stats.ctypes.data), "clear")
            _build.check(lib.fused_topk_bf16(
                qq.data_ptr(), fidx.GT.data_ptr(), fidx.c.data_ptr(),
                fidx.valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B,
                qq.shape[1], Sp, kappa,
                torch.cuda.current_stream().cuda_stream), "fused_topk_bf16")
            torch.cuda.synchronize()
            _build.check(lib.read_guess_stats(stats.ctypes.data), "read")
            held, missed = int(stats[0]), int(stats[1])
            ps, _ = ft.slab_topk_plain(qq, fidx.GT, fidx.c, fidx.valid,
                                       kappa)
            ks = torch.sort(out_s, 2, descending=True).values
            fin = torch.isfinite(ps)
            err = float((ks[fin] - ps[fin]).abs().max())
            print(json.dumps({
                "inputs": f"served {cell}", "B": B, "2D": qq.shape[1],
                "Sp": Sp, "kappa": kappa, "query_items": Sp // ft.SLAB * B,
                "guessed": held + missed, "held": held, "missed": missed,
                "max_abs_err": err}), flush=True)
        del got, fidx
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
