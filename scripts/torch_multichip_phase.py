"""Phase 3j of ``chip_smoke.py`` alone, on every card of the machine (up
to 4 ranks, a card each over NCCL; 2 ranks over gloo on one card).

    python scripts/torch_multichip_phase.py [--single-rows N]

Builds the flagship forest (c=10000, 1000 queries, 768-d, PCA+ICA at
0.96, 32 lanes) and the single tree as phases 3 and 3c build them, on
the first card, writes phase 3j's inputs under ``build/multichip/`` and
runs ``chip_smoke.multichip_phase`` with its checks, printing its lines
and the card's nvidia-smi line.  ``--single-rows`` cuts the single tree
(and its queries' corpus) to its first rows (default: all 10 000).
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    import chip_smoke
    from rag_cobweb_tpu_torch.bench import headline
    from rag_cobweb_tpu_torch.device import full_f32_matmul
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--single-rows", type=int, default=10000)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    full_f32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "multichip"
    t0 = time.perf_counter()
    got = {}

    def keep(name):
        def hook(event, engine, db, data):
            if event == "end":
                got[name] = (db, data)
        return hook

    flag = headline.run(corpus_size=10000, queries=1000, dim=768,
                        pca_dim=0.96, k=10, batch=1024, dataset="hard",
                        n_lanes=32, rerank=1024, device="cuda",
                        hook=keep("flagship"))[0]
    chip_smoke.write_multichip_flagship(*got.pop("flagship"), out_dir)
    headline.run(corpus_size=a.single_rows, queries=1000, dim=768,
                 pca_dim=0.96, k=10, batch=1024, dataset="hard", n_lanes=1,
                 rerank=1024, device="cuda", hook=keep("single"))
    single = chip_smoke.write_multichip_single(*got.pop("single"), out_dir)
    chip_smoke.log(f"[3j] inputs built and written in "
                   f"{time.perf_counter() - t0:.1f}s ({smi}, "
                   f"{torch.cuda.device_count()} cards)")
    torch.cuda.empty_cache()
    rec = chip_smoke.multichip_phase(flag["exact_recall@10"], out_dir,
                                     *single)
    chip_smoke.log_multichip(rec, smi)
    for kern in ("fused", "rerank"):
        chip_smoke.log(f"[3j] {kern} at rank 0's shape: {rec['a'][kern]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
