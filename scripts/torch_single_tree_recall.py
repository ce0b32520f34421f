"""Single-tree recall of the JAX package and of its PyTorch port, side by
side on the host at a reduced size of the flagship (hard synthetic
corpus, PCA+ICA at 0.96, the fused engine with an exact re-rank pool of
the same share of the corpus as the flagship's 1024 of 10 000).

    python scripts/torch_single_tree_recall.py [--corpus-size 3000]
        [--queries 300] [--pool-share 0.1024]

One whitener fit (numpy, shared); each package builds its own
``CobwebIndex`` (one tree, the default) from the raw rows and serves the
queries with ``blocked_threshold`` lowered so the fused engine serves.
Prints recall@10 of the exact scan, of each package, the queries whose
ids differ between the packages, and for each package the queries whose
gold is outside its path-score pool (the pool's rank of the gold by the
plain f32 path scores).  Runs on the CPU (JAX_PLATFORMS=cpu).
"""

import argparse
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
from rag_cobweb_tpu.whitening import PCAICAWhiteningModel  # noqa: E402
from rag_cobweb_tpu_torch import interop  # noqa: E402
from rag_cobweb_tpu_torch.core import index as tindex  # noqa: E402
from rag_cobweb_tpu_torch.core.config import TreeConfig  # noqa: E402
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex  # noqa: E402


def gold_ranks(scores: np.ndarray, gold: np.ndarray) -> np.ndarray:
    """1-based rank of each query's gold among its row of path scores."""
    g = scores[np.arange(len(gold)), gold]
    return (scores > g[:, None]).sum(1) + 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus-size", type=int, default=3000)
    ap.add_argument("--queries", type=int, default=300)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--pool-share", type=float, default=1024 / 10000)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    data = synthetic_retrieval_hard(args.corpus_size, args.queries, args.dim)
    jw = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=0.96,
                                  ica_max_iter=500, seed=0,
                                  ica_sample_size=10000)
    tw = interop.whitener_from_numpy(dict(
        mean=jw.mean, pca_components=jw.pca_components,
        pca_explained_var=jw.pca_explained_var,
        ica_unmixing=jw.ica_unmixing, eps=jw.eps))
    pool = max(10, int(round(args.pool_share * args.corpus_size)))
    k = 10
    exact = FlatIndex(data.corpus_embs, metric="l2").search(
        data.query_embs, k)
    out = {"corpus_size": args.corpus_size, "queries": args.queries,
           "pool": pool, "dim": jw.dim_out,
           "exact_recall@10": retrieval_metrics(
               exact, data.target_ids, k)["recall@10"]}
    ids = {}
    for name in ("jax", "port"):
        t0 = time.perf_counter()
        if name == "jax":
            db = JIndex(config=JCfg(dim=jw.dim_out), whitener=jw,
                        capacity=4 * args.corpus_size + 16)
        else:
            db = CobwebIndex(config=TreeConfig(dim=tw.dim_out), whitener=tw,
                             capacity=4 * args.corpus_size + 16,
                             device="cpu")
        db.add_sentences([None] * args.corpus_size, data.corpus_embs)
        build_s = time.perf_counter() - t0
        db.blocked_threshold = 64
        ids[name] = np.asarray(db.query_ids(data.query_embs, k, rerank=pool))
        idx = db.build_prediction_index()
        if name == "jax":
            q = jw.transform_jit(jnp.asarray(data.query_embs))
            scores = np.asarray(jindex.rank_scores(idx, q))
            depth = int(np.asarray((idx.paths >= 0).sum(1)).max())
        else:
            q = tw.transform_torch(torch.as_tensor(data.query_embs))
            scores = tindex.rank_scores(idx, q).numpy()
            depth = int((idx.paths_h >= 0).sum(1).max())
        ranks = gold_ranks(scores, np.asarray(data.target_ids))
        out[name] = {
            "recall@10": retrieval_metrics(ids[name], data.target_ids,
                                           k)["recall@10"],
            "golds_outside_pool": int((ranks > pool).sum()),
            "gold_path_rank_median": float(np.median(ranks)),
            "max_path_len": depth, "build_s": build_s}
        print(f"[{name}] {json.dumps(out[name])}", file=sys.stderr,
              flush=True)
    out["queries_ids_differ"] = int((ids["jax"] != ids["port"]).any(1).sum())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
