"""The control of a cell's comparison, and its planted faults, at the
cell's own size.  For each seed: set-up, a window of the port as it is
(its numbers, and the control's: the reference in the port's place one
precision below the configuration's, ``check._controls``), then a window
under each fault named (``faults.py``), each read against the same
reference, all at several margins of the reference's pools.  The
benchmark's runs do not run it; it is how the limits and the margin in
``configs/<config>.json`` were read.

    python3 perfbench/control.py --workload <cell> --seeds a,b,c \\
        [--seconds 12] [--faults pools_halved,sweep_garbage] \\
        [--margins 0.5,0.75,0.9,0.95,1.0]

One JSON line a seed and variant.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import run as run_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--margins", default="0.5,0.75,0.9,0.95,1.0")
    ap.add_argument("--post-calls", type=int, default=0,
                    help="calls with the backstop off after each window "
                    "(0: the configuration's)")
    args = ap.parse_args(argv)
    bench = run_mod.load_bench()
    cell = run_mod.find(bench["workloads"], args.workload, "workload")
    cfg = run_mod.load_json("configs", cell["config"])
    mix = run_mod.load_json("traffic", cell["traffic"])
    if args.post_calls:
        cfg["check"]["post_calls"] = args.post_calls
    import torch
    if not torch.cuda.is_available():
        print("[perfbench] no CUDA device", file=sys.stderr)
        return 3
    api = run_mod.port_api()
    if api is None:
        return 4
    from perfbench import cell as cell_mod
    from perfbench import check as check_mod
    from perfbench import faults
    dev = torch.device("cuda", 0)
    print(f"[perfbench] {run_mod.card_line()}", file=sys.stderr, flush=True)
    margins = [float(m) for m in args.margins.split(",")]
    planted = [faults.ALL[f] for f in args.faults.split(",") if f]
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        s = cell_mod.Setup(cfg, mix, seed, dev, api)
        cell_mod._warm(s, int(mix["warm_steps"]))
        setup_s = time.perf_counter() - t0
        for fault in [None] + planted:
            undo = fault(s) if fault is not None else None
            w = cell_mod.window(s, args.seconds, False)
            t1 = time.perf_counter()
            # the fault stays under the calls that the check makes
            v = check_mod.check(s, seed, False, control=fault is None,
                                margins=margins, keep_port=True)
            if undo is not None:
                undo()
            line = {"workload": args.workload, "seed": seed,
                    "variant": fault.__name__ if fault else "port",
                    "setup_s": setup_s, "window_s": w["window_s"],
                    "check_s": time.perf_counter() - t1,
                    "correct": v["correct"], "numbers": v["numbers"],
                    "control": v.get("control"),
                    "readings": v["readings"], "limits": v["limits"]}
            print(json.dumps(line), flush=True)
            del v, w
            torch.cuda.empty_cache()
        del s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
