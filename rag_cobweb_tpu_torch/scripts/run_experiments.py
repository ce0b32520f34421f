"""Experiment fan-out CLI (twin of ``scripts/run_experiments.py``;
reference scripts/run_experiments.py:28-175): an experiment naming one of
the reference's scripts runs its twin, with ``--device``; a script
without a twin raises ``ValueError`` before anything is launched.

    python -m rag_cobweb_tpu_torch.scripts.run_experiments exps.json \\
        --dry-run
"""

import argparse

from rag_cobweb_tpu_torch.bench.launcher import run_experiments


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", help="experiment-list JSON")
    p.add_argument("--mode", choices=["local", "slurm", "slurm-multihost"],
                   default="local")
    p.add_argument("--max-parallel", type=int, default=1)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    launched = run_experiments(args.config, mode=args.mode,
                               max_parallel=args.max_parallel,
                               dry_run=args.dry_run, device=args.device)
    for item in launched:
        print(item)
    return launched


if __name__ == "__main__":
    main()
