"""A new configuration, traffic mix and per-layer metric are each one new
file and one new entry, found by name: no existing file is edited."""

import hashlib
import importlib.util
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "msmarco_dpr_1m.json").read_text())
    cfg.update(name="msmarco_dpr_2m", rows=2097152)
    (pb / "configs" / "msmarco_dpr_2m.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "batch.json").read_text())
    mix.update(name="online", batch=32)
    (pb / "traffic" / "online.json").write_text(json.dumps(mix))
    (pb / "metrics" / "calls_per_s.online.py").write_text(
        "from perfbench import readers\n\n\n"
        "def read(res):\n"
        "    return len(readers.queries(res)) / res['window_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "msmarco_dpr_2m.online",
                               "config": "msmarco_dpr_2m",
                               "traffic": "online", "chips": 1,
                               "why": "new"})
    bench["per_layer"].append({"name": "calls_per_s.online", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving API", "moves": "qps",
                               "workloads": ["msmarco_dpr_2m.online"]})
    # only BENCHMARK.json's entries change; every other file is as it was
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
    assert len(after) - len(before) == 3

    spec = importlib.util.spec_from_file_location("copied_run",
                                                  pb / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.HERE == pb
    b = run.load_bench()
    cell = run.find(b["workloads"], "msmarco_dpr_2m.online", "workload")
    assert run.load_json("configs", cell["config"])["rows"] == 2097152
    assert run.load_json("traffic", cell["traffic"])["batch"] == 32
    read = run.reader("calls_per_s.online")

    class Fake:
        calls = [{"add": 0}] * 30
    assert read({"setup": Fake, "window_s": 10.0}) == 3.0


def test_without_the_port_there_is_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and ``perfbench/`` the
    port cannot be imported, and the run gives up before any result."""
    import os
    import subprocess
    import sys
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", "from perfbench import run; "
         "print(run.port_api() is None)"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "msmarco_dpr_1m.batch", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
