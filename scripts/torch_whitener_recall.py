"""Whitener-mode forest recall of the JAX package and of its PyTorch port,
side by side on the host, at the flagship settings on a ZCA or PCA+ZCA
whitener (hard synthetic corpus c=10000, 1000 queries, 768-d, 32 lanes,
k=10, pool 1024, the fused engine over a bf16 index, the exact re-rank on
the raw rows).

    python scripts/torch_whitener_recall.py [--whitener zca|pcazca]
        [--corpus-size 10000] [--queries 1000]

Each package fits its own whitener (the same host float64 code) and
builds its own ``CobwebIndex`` from the raw rows on the CPU.  Prints
recall@10 of the exact scan and of each package, the queries whose ids
differ between the packages, for each package the golds its 1024-row
path-score pool leaves out (ranked by the plain f32 scores of its served
fused index) and the digest of its served ids, which ``chip_smoke.py``
phase 3h prints for the card's (the same int64 bytes, sha256, 16 hex
digits).  Runs on the CPU (JAX_PLATFORMS=cpu).
"""

import argparse
import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rag_cobweb_tpu.bench.baselines import FlatIndex  # noqa: E402
from rag_cobweb_tpu.bench.datasets import synthetic_retrieval_hard  # noqa
from rag_cobweb_tpu.bench.metrics import retrieval_metrics  # noqa: E402
from rag_cobweb_tpu.core import index as jindex  # noqa: E402
from rag_cobweb_tpu.core.config import TreeConfig as JCfg  # noqa: E402
from rag_cobweb_tpu.core.wrapper import CobwebIndex as JIndex  # noqa: E402
from rag_cobweb_tpu.whitening import models as jmodels  # noqa: E402
from rag_cobweb_tpu_torch.core import index as tindex  # noqa: E402
from rag_cobweb_tpu_torch.core.config import TreeConfig  # noqa: E402
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex  # noqa: E402
from rag_cobweb_tpu_torch.whitening import models as tmodels  # noqa: E402

CLASSES = {"zca": "ZCAWhiteningModel", "pcazca": "PCAZCAWhiteningModel"}


def outside(scores: np.ndarray, gold: np.ndarray, pool: int) -> list:
    """The queries whose gold has ``pool`` or more rows scoring above it."""
    g = scores[np.arange(len(gold)), gold]
    return np.nonzero((scores > g[:, None]).sum(1) >= pool)[0].tolist()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--whitener", choices=tuple(CLASSES), default="zca")
    ap.add_argument("--corpus-size", type=int, default=10000)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--pool", type=int, default=1024)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    data = synthetic_retrieval_hard(args.corpus_size, args.queries, args.dim)
    kw = {} if args.whitener == "zca" else {"pca_dim": 0.96}
    k, pool, gold = 10, args.pool, np.asarray(data.target_ids)
    exact = FlatIndex(data.corpus_embs, metric="l2").search(
        data.query_embs, k)
    out = {"whitener": args.whitener, "corpus_size": args.corpus_size,
           "queries": args.queries, "lanes": args.lanes, "pool": pool,
           "exact_recall@10": retrieval_metrics(exact, gold,
                                                k)["recall@10"]}
    ids, misses = {}, {}
    for name in ("jax", "port"):
        t0 = time.perf_counter()
        cls = getattr(jmodels if name == "jax" else tmodels,
                      CLASSES[args.whitener])
        w = cls.fit(data.corpus_embs, **kw)
        if name == "jax":
            db = JIndex(config=JCfg(dim=args.dim), whitener=w,
                        n_subtrees=args.lanes,
                        capacity=4 * args.corpus_size + 16)
        else:
            db = CobwebIndex(config=TreeConfig(dim=w.dim_out), whitener=w,
                             n_subtrees=args.lanes,
                             capacity=4 * args.corpus_size + 16,
                             device="cpu")
        db.add_sentences([None] * args.corpus_size, data.corpus_embs)
        build_s = time.perf_counter() - t0
        ids[name] = np.asarray(db.query_ids(data.query_embs, k, rerank=pool))
        fidx = db._fused_index()
        if name == "jax":
            q = w.transform_jit(jnp.asarray(data.query_embs))
            scores = np.asarray(jindex.fused_scores(fidx, q))
        else:
            q = w.transform_torch(torch.as_tensor(data.query_embs))
            scores = tindex.fused_scores(fidx, q).numpy()
        misses[name] = outside(scores[:, :args.corpus_size], gold, pool)
        out[name] = {
            "recall@10": retrieval_metrics(ids[name], gold, k)["recall@10"],
            "golds_outside_pool": len(misses[name]), "build_s": build_s,
            "ids_sha256": hashlib.sha256(np.ascontiguousarray(
                ids[name], np.int64).tobytes()).hexdigest()[:16]}
        print(f"[{name}] {json.dumps(out[name])}", file=sys.stderr,
              flush=True)
    out["queries_ids_differ"] = int((ids["jax"] != ids["port"]).any(1).sum())
    out["pool_misses_same_queries"] = misses["jax"] == misses["port"]
    out["pool_misses"] = misses["jax"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
