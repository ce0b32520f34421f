"""Post-hoc report generation (port of ``rag_cobweb_tpu/bench/report.py``,
copied): parse results tables back into dicts and emit LaTeX tables
(reference src/utils/create_metrics_table.py:16-141 and
create_runtime_table.py:11-68, with the free-global bug of
``run_encoder_table`` fixed by explicit arguments)."""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from typing import Iterable, Sequence


def parse_results_file(path: str) -> list[dict]:
    """Parse the grid tables written by metrics.print_metrics_table back
    into row dicts (reference create_metrics_table.py:16-42)."""
    rows: list[dict] = []
    header: list[str] = []
    with open(path) as f:
        for line in f:
            if not line.startswith("|"):
                continue
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if not cells or all(set(c) <= {"-", "=", "+", " "} for c in cells):
                continue
            if cells[0] == "method":
                header = cells
                continue
            if not header or len(cells) != len(header):
                continue
            row: dict = {"method": cells[0]}
            for k, v in zip(header[1:], cells[1:]):
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v
            rows.append(row)
    return rows


def parse_reference_results_file(path: str) -> dict[str, dict]:
    """Parse the REFERENCE's committed artifact format (blocks of
    ``--- Metrics for <method> ---`` / ``Avg Latency: X ms`` / a +---+
    pretty-table with one row per k) into
    ``{method: {avg_latency_ms, recall@k, mrr@k, ndcg@k, ...}}``.

    This is the reader for the reference's regression-by-artifact record
    (the reference repository's outputs/*/benchmark_*.txt, written by its
    print_metrics_table, benchmark_utils.py:836-868) — used by the golden
    tests to pin our baseline numbers to their recorded source.
    """
    out: dict[str, dict] = {}
    method = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            m = re.match(r"^-+ Metrics for (.+?) -+$", line)
            if m:
                method = m.group(1).strip()
                out[method] = {}
                continue
            if method is None:
                continue
            m = re.match(
                r"^Avg Latency: ([0-9.]+) ms with total time ([0-9.]+)", line
            )
            if m:
                out[method]["avg_latency_ms"] = float(m.group(1))
                out[method]["time_taken"] = float(m.group(2))
                continue
            m = re.match(
                r"^\|\s*@(\d+)\s*\|\s*([0-9.]+)\s*\|\s*([0-9.]+)\s*\|"
                r"\s*([0-9.]+)\s*\|$", line
            )
            if m:
                k = int(m.group(1))
                out[method][f"recall@{k}"] = float(m.group(2))
                out[method][f"mrr@{k}"] = float(m.group(3))
                out[method][f"ndcg@{k}"] = float(m.group(4))
    return {k: v for k, v in out.items() if v}


def collect_results(outputs_dir: str, pattern: str = "benchmark_*.txt"
                    ) -> dict[str, list[dict]]:
    """All results files under outputs/<dataset>/, keyed by filename."""
    out = {}
    for path in sorted(glob.glob(os.path.join(outputs_dir, "**", pattern),
                                 recursive=True)):
        rows = parse_results_file(path)
        if rows:
            out[os.path.relpath(path, outputs_dir)] = rows
    return out


_RUN_META = re.compile(
    r"benchmark_(?P<model>.+?)_(?P<dataset>[a-z_]+)_(?P<split>[a-z]+)"
    r"_c(?P<c>\d+)_t(?P<t>\d+)_k(?P<k>\d+)"
)


def run_metadata(filename: str) -> dict:
    m = _RUN_META.search(os.path.basename(filename))
    if not m:
        return {}
    d = m.groupdict()
    return {"model": d["model"], "dataset": d["dataset"],
            "split": d["split"], "corpus_size": int(d["c"]),
            "target_size": int(d["t"]), "top_k": int(d["k"])}


def latex_metrics_table(results_by_run: dict[str, list[dict]],
                        metric_ks: Sequence[int] = (5, 10),
                        group_by: str = "model",
                        selected_metrics: Iterable[str] = ("recall", "ndcg"),
                        ) -> str:
    """LaTeX metric table grouped by model or corpus size (reference
    create_metrics_table.py:51-141)."""
    groups: dict[str, list[tuple[dict, dict]]] = defaultdict(list)
    for fname, rows in results_by_run.items():
        meta = run_metadata(fname)
        key = str(meta.get(group_by, meta.get("corpus_size", fname)))
        for row in rows:
            groups[key].append((meta, row))

    cols = [f"{m}@{k}" for m in selected_metrics for k in metric_ks]
    lines = [
        "\\begin{tabular}{ll" + "r" * len(cols) + "}",
        "\\toprule",
        group_by + " & method & " + " & ".join(cols) + " \\\\",
        "\\midrule",
    ]
    for key in sorted(groups):
        for meta, row in groups[key]:
            vals = [
                f"{row.get(c, float('nan')):.3f}" if isinstance(
                    row.get(c), float) else "--"
                for c in cols
            ]
            method = str(row.get("method", "?")).replace("_", "\\_")
            lines.append(f"{key} & {method} & " + " & ".join(vals) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines)


def latex_runtime_table(results_by_run: dict[str, list[dict]]) -> str:
    """LaTeX per-query latency table (reference create_runtime_table.py:11-68)."""
    lines = [
        "\\begin{tabular}{llrr}",
        "\\toprule",
        "run & method & latency (ms) & QPS \\\\",
        "\\midrule",
    ]
    for fname in sorted(results_by_run):
        meta = run_metadata(fname)
        tag = f"c={meta.get('corpus_size', '?')}"
        for row in results_by_run[fname]:
            lat = row.get("avg_latency_ms", float("nan"))
            qps = row.get("qps", float("nan"))
            method = str(row.get("method", "?")).replace("_", "\\_")
            lines.append(
                f"{tag} & {method} & "
                f"{lat:.3f} & {qps:.0f} \\\\"
                if isinstance(lat, float) else f"{tag} & {method} & -- & -- \\\\"
            )
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines)
