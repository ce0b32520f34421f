"""Experiment launcher (port of ``rag_cobweb_tpu/bench/launcher.py``):
JSON experiment lists -> generated job scripts -> local subprocess
fan-out or SLURM ``sbatch`` (reference scripts/run_experiments.py:28-175,
which merges per-experiment SLURM overrides into defaults and sbatches
one script per experiment).

Cluster usage is embarrassingly parallel (one process per experiment, no
cross-job communication); each job owns its cards through the launcher's
resource stanza.  A multi-host job's script exports the coordinator
contract ``parallel/distributed.launch_config`` reads.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shlex
import subprocess
import sys

DEFAULT_SLURM = {
    "partition": "gpu",
    "qos": "normal",
    "mem": "16G",
    "time": "04:00:00",
    "cpus_per_task": 4,
    "nodes": 1,
    "ntasks_per_node": 1,
}


def load_experiments(config_path: str) -> list[dict]:
    """Experiment-list JSON: {"defaults": {...}, "experiments": [{...}]}.
    Per-experiment keys override the defaults (reference :33-37)."""
    with open(config_path) as f:
        data = json.load(f)
    defaults = data.get("defaults", {})
    out = []
    for exp in data.get("experiments", []):
        merged = {**defaults, **exp}
        merged["slurm"] = {**DEFAULT_SLURM,
                           **defaults.get("slurm", {}),
                           **exp.get("slurm", {})}
        out.append(merged)
    return out


# Twins that live outside ``rag_cobweb_tpu_torch/scripts/``, by the
# reference script's name.
TWIN_ELSEWHERE = {"million_benchmark": "rag_cobweb_tpu_torch.bench.million"}


def twin_module(script: str):
    """The module of the port's twin of ``script`` (a path under the
    reference's ``scripts/``), or None where it has none."""
    name = os.path.splitext(os.path.basename(script))[0]
    if name in TWIN_ELSEWHERE:
        return TWIN_ELSEWHERE[name]
    mod = f"rag_cobweb_tpu_torch.scripts.{name}"
    if name.startswith("_") or importlib.util.find_spec(mod) is None:
        return None
    return mod


def experiment_command(exp: dict, device: str = "cuda") -> list[str]:
    """The experiment's command line: the twin of the script it names
    (``python -m``) on ``device``.  A script without a twin raises
    ``ValueError``: the port never runs the JAX package's scripts."""
    script = exp.get("script", "scripts/synthetic_benchmark.py")
    twin = twin_module(script)
    if twin is None:
        raise ValueError(
            f"{script} has no twin in the port (every reference script has "
            "one; scripts/torch_*.py are the port's own checks, run "
            "directly); the launcher does not run the JAX package's "
            "scripts")
    cmd = [sys.executable, "-m", twin]
    if exp.get("config"):
        cmd += ["--config", exp["config"]]
    for k, v in exp.get("args", {}).items():
        cmd += [f"--{k}", str(v)]
    return cmd + ["--device", device]


def write_slurm_script(exp: dict, out_dir: str, index: int,
                       device: str = "cuda") -> str:
    """Emit one sbatch script per experiment (reference :48-126)."""
    os.makedirs(out_dir, exist_ok=True)
    s = exp["slurm"]
    name = exp.get("name", f"exp{index}")
    path = os.path.join(out_dir, f"{name}.sh")
    cmd = " ".join(shlex.quote(c) for c in experiment_command(exp, device))
    with open(path, "w") as f:
        f.write(
            "#!/bin/bash\n"
            f"#SBATCH --job-name={name}\n"
            f"#SBATCH --partition={s['partition']}\n"
            f"#SBATCH --qos={s['qos']}\n"
            f"#SBATCH --mem={s['mem']}\n"
            f"#SBATCH --time={s['time']}\n"
            f"#SBATCH --cpus-per-task={s['cpus_per_task']}\n"
            f"#SBATCH --nodes={s['nodes']}\n"
            f"#SBATCH --ntasks-per-node={s['ntasks_per_node']}\n"
            f"#SBATCH --output=slurm_outputs/{name}_%j.out\n\n"
            f"srun {cmd}\n"
        )
    os.chmod(path, 0o755)
    return path


def write_multihost_slurm_script(exp: dict, out_dir: str, index: int,
                                 coordinator_port: int = 12321,
                                 device: str = "cuda") -> str:
    """One sbatch script that runs an experiment as a multi-host job: N
    nodes x 1 task, the first node hosting the ``torch.distributed``
    rendezvous, every task taking its rank from ``SLURM_PROCID``.

    The reference launcher only ever emitted independent single-task jobs
    (run_experiments.py:48-126, nodes=1).  The exported contract is the
    one ``parallel/distributed.launch_config`` reads (and the JAX
    package's ``initialize``): ``JAX_COORDINATOR_ADDRESS`` host:port,
    ``JAX_NUM_PROCESSES``, the rank from ``SLURM_PROCID``; worker scripts
    call ``initialize()`` with no arguments.
    """
    os.makedirs(out_dir, exist_ok=True)
    s = exp["slurm"]
    name = exp.get("name", f"exp{index}")
    nodes = int(s.get("nodes", 1))
    path = os.path.join(out_dir, f"{name}_multihost.sh")
    cmd = " ".join(shlex.quote(c) for c in experiment_command(exp, device))
    with open(path, "w") as f:
        f.write(
            "#!/bin/bash\n"
            f"#SBATCH --job-name={name}\n"
            f"#SBATCH --partition={s['partition']}\n"
            f"#SBATCH --qos={s['qos']}\n"
            f"#SBATCH --mem={s['mem']}\n"
            f"#SBATCH --time={s['time']}\n"
            f"#SBATCH --cpus-per-task={s['cpus_per_task']}\n"
            f"#SBATCH --nodes={nodes}\n"
            "#SBATCH --ntasks-per-node=1\n"
            f"#SBATCH --output=slurm_outputs/{name}_%j.out\n\n"
            "# multi-host torch.distributed: rendezvous on the first\n"
            "# allocated node; each srun task reads its rank from\n"
            "# SLURM_PROCID\n"
            "COORD_HOST=$(scontrol show hostnames \"$SLURM_JOB_NODELIST\""
            " | head -n 1)\n"
            f"export JAX_COORDINATOR_ADDRESS="
            f"\"${{COORD_HOST}}:{coordinator_port}\"\n"
            "export JAX_NUM_PROCESSES=\"$SLURM_NTASKS\"\n"
            f"srun --kill-on-bad-exit=1 {cmd}\n"
        )
    os.chmod(path, 0o755)
    return path


def run_experiments(config_path: str, mode: str = "local",
                    script_dir: str = "generated_jobs",
                    max_parallel: int = 1,
                    dry_run: bool = False,
                    device: str = "cuda") -> list:
    """Fan out all experiments.  mode='local' runs them as subprocesses
    (sequential or bounded-parallel); mode='slurm' generates scripts and
    sbatches them (reference :127-166).  ``device``: each script runs as
    its twin on ``device`` (``experiment_command``: a script without a
    twin raises ``ValueError`` before anything is launched)."""
    exps = load_experiments(config_path)
    for exp in exps:        # every command first: an untwinned one raises
        experiment_command(exp, device)
    launched = []
    if mode in ("slurm", "slurm-multihost"):
        writer = (write_multihost_slurm_script if mode == "slurm-multihost"
                  else write_slurm_script)
        for i, exp in enumerate(exps):
            path = writer(exp, script_dir, i, device=device)
            launched.append(path)
            if not dry_run:
                subprocess.run(["sbatch", path], check=True)
        return launched

    running: list[subprocess.Popen] = []
    for exp in exps:
        cmd = experiment_command(exp, device)
        launched.append(cmd)
        if dry_run:
            continue
        while len(running) >= max_parallel:
            running = [p for p in running if p.poll() is None] or running
            if all(p.poll() is None for p in running):
                running[0].wait()
            running = [p for p in running if p.poll() is None]
        running.append(subprocess.Popen(cmd))
    for p in running:
        p.wait()
    return launched
