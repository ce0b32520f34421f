"""Where the blocked sweep kernel's time goes, per CUDA block, on the card.

    python -m rag_cobweb_tpu_torch.bench.blocked_phases

For a card without a device profiler at hand: it builds
``csrc/blocked_topk.cu`` with ``-DBLOCKED_PHASES`` (into
``build/torch_kernels/``), where the first consumer thread of every CUDA
block stamps ``clock64()`` before the query tile arrives, after it, after
the M loop, after the score tile is stored and after the selection, and
every row that fails the selection's filter and takes the full sort is
counted.  It runs on the 100k cell's served index (``kernel_ab.py``'s)
at B = 1, 32 and 1024 and prints, per batch size, the median cycles of
each phase over the CUDA blocks, their shares of the block's time, and
the rows of the full sort; then the card's name and power limit.  The
stamps cost a few instructions a block; time the kernel itself with
``kernel_ab.py`` or ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from rag_cobweb_tpu_torch.ops import _build
from rag_cobweb_tpu_torch.ops import blocked_topk as bt

PHASES = ("query_tile", "m_loop", "tile_store", "selection")
SLOTS = 65536          # CUDA blocks that can be stamped (g_stamps)


def build():
    src = _build._CSRC / "blocked_topk.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"blocked_phases_{_build.digest(src)}.so"
    if not so.exists():
        subprocess.run(_build.nvcc_command(src, so, "-DBLOCKED_PHASES"),
                       check=True)
    lib = ctypes.CDLL(str(so))
    lib.blocked_topk_bf16.argtypes = \
        _build._SIGNATURES["blocked_topk"]["blocked_topk_bf16"]
    lib.read_stamps.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_ulonglong)]
    for fn in (lib.blocked_topk_bf16, lib.read_stamps, lib.clear_stamps):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("blocked_phases: no CUDA device", file=sys.stderr)
        return 2
    from rag_cobweb_tpu_torch.bench.kernel_ab import served_index
    lib = build()
    bidx, queries, kk = served_index()
    NB, M, D = bidx.ivt_b.shape
    TS = bidx.W.shape[2]
    for B in (1, 32, 1024):
        qd, q2 = bt._queries(bidx, queries[:B])
        out_s = torch.empty((NB, B, kk), dtype=torch.float32, device="cuda")
        out_t = torch.empty((NB, B, kk), dtype=torch.int32, device="cuda")
        stamps = np.zeros((SLOTS, 8), np.int64)
        full = ctypes.c_ulonglong(0)
        _build.check(lib.clear_stamps(), "clear_stamps")
        _build.check(lib.blocked_topk_bf16(
            *(t.data_ptr() for t in (qd, q2, bidx.ivt_b, bidx.movt_b,
                                     bidx.const_b, bidx.W, bidx.valid)),
            out_s.data_ptr(), out_t.data_ptr(), B, NB, M, D, TS, kk,
            torch.cuda.current_stream().cuda_stream), "blocked_topk")
        torch.cuda.synchronize()
        _build.check(lib.read_stamps(stamps.ctypes.data, ctypes.byref(full)),
                     "read_stamps")
        done = stamps[stamps[:, 4] > 0][:, :5]
        cycles = np.median(np.diff(done, axis=1), axis=0)
        total = float(np.median(done[:, 4] - done[:, 0]))
        print(json.dumps({
            "B": B, "NB": NB, "M": M, "D": D, "TS": TS, "kk": kk,
            "cuda_blocks": int(len(done)),
            "median_cycles": dict(zip(PHASES, map(float, cycles))),
            "median_total_cycles": total,
            "share": {p: round(float(c) / total, 3)
                      for p, c in zip(PHASES, cycles)},
            "full_sort_rows": int(full.value), "rows": NB * B}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
