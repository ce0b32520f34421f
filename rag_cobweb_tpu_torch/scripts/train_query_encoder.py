"""Cobweb-supervised query-encoder training on the card (twin of
``scripts/train_query_encoder.py``; reference
src/training/cobweb_query_train.py): a whitened Cobweb index over the
passages, then a projection head trained by CE over the tree's
differentiable leaf scores.  Hermetic by default (synthetic
embeddings)."""

import argparse

import numpy as np

from rag_cobweb_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus-size", type=int, default=2000)
    p.add_argument("--queries", type=int, default=400)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--pca-dim", type=int, default=96)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--save-dir", type=str,
                   default="models/cobweb_query_encoder")
    p.add_argument("--corpus-embeddings", type=str, default=None)
    p.add_argument("--query-embeddings", type=str, default=None)
    p.add_argument("--gold-rows", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)     # no card: raise before any work

    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.training.query_train import CobwebQueryTrainer
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache
    from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

    enable_persistent_cache()
    if args.corpus_embeddings:
        corpus = np.load(args.corpus_embeddings)
        queries = np.load(args.query_embeddings)
        gold = np.load(args.gold_rows)
    else:
        data = synthetic_retrieval(args.corpus_size, args.queries, args.dim)
        corpus, queries, gold = (data.corpus_embs, data.query_embs,
                                 data.target_ids)

    whitener = PCAICAWhiteningModel.fit(corpus, pca_dim=args.pca_dim,
                                        ica_max_iter=500)
    corpus_w = whitener.transform(corpus)
    db = CobwebIndex(corpus=None, corpus_embeddings=corpus_w,
                     config=TreeConfig(dim=corpus_w.shape[1]),
                     device=args.device)

    tr = CobwebQueryTrainer(db, in_dim=queries.shape[1], lr=args.lr)
    before = tr.evaluate(queries, gold)
    print("before:", before)
    losses = tr.fit(queries, gold, epochs=args.epochs,
                    batch_size=args.batch_size, save_dir=args.save_dir,
                    log_every=1)
    after = tr.evaluate(queries, gold)
    print("after:", after)
    return {"before": before, "losses": losses, "after": after,
            "trainer": tr}


if __name__ == "__main__":
    main()
