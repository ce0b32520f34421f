"""Real-data ingress rehearsal on the card (twin of
``scripts/ingress_rehearsal.py``): a drop-in embedding cache in the
reference's layout gives a full benchmark artifact with no code edit and
no network.

    python -m rag_cobweb_tpu_torch.scripts.ingress_rehearsal \\
        [--root build/experiments/ingress_rehearsal] \\
        [--model-name all-roberta-large-v1] [--subset-size 2000] \\
        [--target-size 200] [--split validation] [--top-k 10] \\
        [--method golden] [--cpu] [--device cuda]

1. A "real-shaped" set (the hard synthetic rows, 768-d, distinct texts:
   corpus row i "question i: ...", each target the text of its gold row)
   is written into the content-addressed cache slots
   (``data/embeddings/{corpus,queries}_<uid>.npy``,
   ``data/sentences/{corpus,queries,targets}_<uid>.txt``) under
   ``--root``; no ids file, so the harness finds each gold by its text,
   which must match exactly one corpus row
   (``bench/harness.target_ids_from_cache``; the texts are distinct).
2. ``python -m rag_cobweb_tpu_torch.scripts.qqp_benchmark`` runs cold in
   a subprocess (cwd ``--root``, the Hugging Face offline variables set)
   with the matching arguments and ``--device``; a non-zero exit fails.
3. The results file is parsed back (``bench/report.parse_results_file``)
   and so is the table the run printed: the record's ``rows`` and
   ``printed_rows``.

``--root`` defaults to the git-ignored ``build/experiments/`` (the JAX
script's is under ``/tmp``); ``--cpu`` is ``--device cpu``.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[2]
OFFLINE = {"HF_HUB_OFFLINE": "1", "HF_DATASETS_OFFLINE": "1",
           "TRANSFORMERS_OFFLINE": "1"}


def write_cache(root: str, model_name: str, subset_size: int,
                target_size: int, split: str, top_k: int,
                dim: int = 768, seed: int = 0) -> str:
    """Synthesize and write the cache set; returns the run id."""
    from rag_cobweb_tpu_torch.bench import encoders
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard

    uid = encoders.generate_unique_id(model_name, "qqp", split,
                                      subset_size, target_size, top_k=top_k)
    data = synthetic_retrieval_hard(subset_size, target_size, dim, seed=seed)
    corpus_text = [f"question {i}: synthetic passage body {i}"
                   for i in range(subset_size)]
    queries_text = [f"query {j} paraphrase" for j in range(target_size)]
    targets_text = [corpus_text[t] for t in data.target_ids]
    for kind, arr in (("corpus", data.corpus_embs),
                      ("queries", data.query_embs)):
        path = encoders.embedding_cache_path(root, kind, uid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, arr)
    for kind, text in (("corpus", corpus_text), ("queries", queries_text),
                       ("targets", targets_text)):
        encoders.save_sentences(encoders.sentences_cache_path(root, kind,
                                                              uid), text)
    return uid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO / "build" / "experiments"
                                          / "ingress_rehearsal"))
    ap.add_argument("--model-name", default="all-roberta-large-v1")
    ap.add_argument("--subset-size", type=int, default=2000)
    ap.add_argument("--target-size", type=int, default=200)
    ap.add_argument("--split", default="validation")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--method", default="golden")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    resolve_device(device)

    from rag_cobweb_tpu_torch.bench import encoders, report

    os.makedirs(args.root, exist_ok=True)
    uid = write_cache(args.root, args.model_name, args.subset_size,
                      args.target_size, args.split, args.top_k)
    print(f"[rehearsal] cache written under {args.root} (uid {uid})")
    out = encoders.results_path(args.root, "qqp", uid)
    if os.path.exists(out):
        os.remove(out)      # the harness appends: one run's table
    cmd = [sys.executable, "-m", "rag_cobweb_tpu_torch.scripts.qqp_benchmark",
           "--model_name", args.model_name, "--subset_size",
           str(args.subset_size), "--target_size", str(args.target_size),
           "--split", args.split, "--top_k", str(args.top_k), "--method",
           args.method, "--device", device]
    env = dict(os.environ, **OFFLINE)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    r = subprocess.run(cmd, cwd=args.root, env=env, capture_output=True,
                       text=True, timeout=3000)
    sys.stdout.write(r.stdout[-3000:])
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise SystemExit(f"benchmark subprocess failed rc={r.returncode}")
    printed = os.path.join(args.root, f"stdout_{uid}.txt")
    with open(printed, "w") as f:
        f.write(r.stdout)
    rows = report.parse_results_file(out)
    assert rows, f"no parseable rows in {out}"
    print(f"[rehearsal] artifact {out} parsed: "
          f"{json.dumps(rows, indent=1)[:1200]}")
    print("[rehearsal] OK: drop-in cache -> full artifact, no code edits")
    return {"uid": uid, "results_path": out, "rows": rows,
            "printed_rows": report.parse_results_file(printed),
            "returncode": r.returncode}


if __name__ == "__main__":
    main()
