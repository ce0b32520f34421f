"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``; each metric is read by
``metrics/<metric>.py``.  All are found by name, so a new cell, mix or
metric is a new file and a new entry.  Without a CUDA device, or without
the port beside this folder, the run exits with an error and prints no
result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "rag_cobweb_tpu")


def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def reader(name: str):
    """``read(result)`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def port_api():
    """The port's serving API, or None where the port is not beside this
    folder."""
    try:
        from rag_cobweb_tpu_torch.core.config import TreeConfig
        from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
        from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel
    except ImportError as e:
        print(f"[perfbench] the port cannot be imported: {e}",
              file=sys.stderr)
        return None
    return argparse.Namespace(TreeConfig=TreeConfig, CobwebIndex=CobwebIndex,
                              PCAICAWhiteningModel=PCAICAWhiteningModel)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_bench()
    cell = find(bench["workloads"], args.workload, "workload")
    cfg = load_json("configs", cell["config"])
    mix = load_json("traffic", cell["traffic"])

    import torch
    need = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"[perfbench] the cell needs {need} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 3
    api = port_api()
    if api is None:
        return 4
    from perfbench import cell as cell_mod
    from perfbench import readers

    dev = torch.device("cuda", 0)
    print(f"[perfbench] {card_line()}", file=sys.stderr, flush=True)
    res = cell_mod.run(cfg, mix, args.seed, args.seconds, bool(args.trace),
                       dev, api, T_PROCESS)
    metrics = cell_mod.result_metrics(res, bench, cell, bool(args.trace),
                                      reader)
    v = res["verdict"]
    calls = readers.queries(res)
    line = {"correct": bool(v["correct"]),
            "attempted": int(sum(c["B"] for c in calls)
                             + len(readers.adds(res))),
            "failed": int(v["numbers"]["bad_ids"]), "metrics": metrics,
            "device": cell_mod.device_info(res, dev, bool(args.trace))}
    if args.trace and res["stretch"] is not None:
        from perfbench import trace as trace_mod
        line["breakdown"] = trace_mod.breakdown(res["stretch"])
    line["checked"] = {k: {"value": v["numbers"][k],
                           "limit": v["limits"][k]} for k in v["numbers"]}
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    for k, d in line["checked"].items():
        print(f"[perfbench] check {k} {d['value']!r} limit {d['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
