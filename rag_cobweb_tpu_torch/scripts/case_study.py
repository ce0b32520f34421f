"""Qualitative case study on the card (twin of ``scripts/case_study.py``;
reference src/benchmarks/gpt_case_study.py): the queries whitened-Cobweb
retrieval finds but the exact flat search misses (and the reverse).
Hermetic: a synthetic corpus with text labels."""

import argparse

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus-size", type=int, default=4000)
    p.add_argument("--queries", type=int, default=400)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=int, default=96)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any work

    import torch

    from rag_cobweb_tpu_torch.bench.baselines import FlatIndex
    from rag_cobweb_tpu_torch.bench.case_study import (print_case_study,
                                                       retrieval_diff)
    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.core import index as index_mod
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

    enable_persistent_cache()
    data = synthetic_retrieval(args.corpus_size, args.queries, args.dim)
    wh = PCAICAWhiteningModel.fit(data.corpus_embs, pca_dim=args.pca_dim,
                                  ica_max_iter=300)
    cw, qw = wh.transform(data.corpus_embs), wh.transform(data.query_embs)
    db = CobwebIndex(corpus=None, corpus_embeddings=cw,
                     config=TreeConfig(dim=cw.shape[1]), device=args.device)
    idx = db.build_prediction_index()
    _, cobweb_ids = index_mod.query_topk(
        idx, torch.as_tensor(qw, device=db.device), args.k)
    cobweb_ids = cobweb_ids.cpu().numpy()
    flat_ids = FlatIndex(data.corpus_embs, metric="ip",
                         device=args.device).search(data.query_embs, args.k)

    diff = retrieval_diff(cobweb_ids, flat_ids, data.target_ids, k=args.k)
    corpus_labels = [f"<corpus item {i}>" for i in range(args.corpus_size)]
    queries = [f"<query {i} (gold={data.target_ids[i]})>"
               for i in range(args.queries)]
    targets = [corpus_labels[t] for t in data.target_ids]
    print_case_study(diff, queries, targets, cobweb_ids, corpus_labels,
                     name_a="Cobweb PCA+ICA Fast", name_b="Flat exact IP",
                     limit=args.limit)
    return diff


if __name__ == "__main__":
    main()
