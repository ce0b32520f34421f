"""Whitened fused pool + raw-embedding exact re-rank, on the card (twin of
``scripts/raw_rerank_probe.py``): the gold's coverage in the whitened
top-P pool bounds the recall a raw re-rank of that pool can reach.

    python -m rag_cobweb_tpu_torch.scripts.raw_rerank_probe [--device cuda]

The hard synthetic set (10000 rows, 1000 queries, 768-d), PCA+ICA at
0.96; a 32-lane forest built in raw mode on the whitened rows (no
whitener, so the store holds whitened rows); at P = 256, 1024 and 4096
the ``rerank=0`` pool of P (the path-score order, kernel 1's f32 entry)
and its raw-L2 re-rank to 10 through kernel 5 on the raw rows (prior
variance 1, so the key doubled is ``-d2``).  The JAX script re-ranks
with an XLA gather and ``argsort``.  One line a pool, as the JAX script
prints it.  ``probe`` takes the data and a fitted whitener, so a caller
that has them (``chip_smoke.py`` phase 3n, phase 3's whitener) runs it
without a refit.  Not carried over, as they exist only for the TPU: the
XLA compile cache and ``warmup_insert_programs``.
"""

import argparse

import torch

from rag_cobweb_tpu_torch.device import resolve_device

POOLS = (256, 1024, 4096)


def probe(data, wh, device, pools=POOLS, out=print) -> dict:
    """Coverage and raw re-rank recall@10 at each pool of ``pools`` on a
    raw-mode 32-lane forest over ``data``'s rows whitened by ``wh``."""
    from rag_cobweb_tpu_torch.core.config import TreeConfig
    from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
    from rag_cobweb_tpu_torch.ops import rerank
    from rag_cobweb_tpu_torch.scripts._sweeps import whiten

    cw = whiten(wh, data.corpus_embs, device)
    qw = whiten(wh, data.query_embs, device)
    db = CobwebIndex(config=TreeConfig(dim=cw.shape[1]),
                     capacity=4 * len(cw) + 16, n_subtrees=32, device=device)
    db.add_sentences([None] * len(cw), cw)
    corpus_raw = torch.as_tensor(data.corpus_embs, device=device)
    q_raw = torch.as_tensor(data.query_embs, device=device)
    gold = data.target_ids
    rec = {"pools": []}
    for P in pools:
        ids = db.query_ids(qw, P, rerank=0)                       # (T, P)
        ids_h = ids.cpu().numpy()
        cov = float((ids_h == gold[:, None]).any(1).mean())
        cand = ids.to(torch.int32).contiguous()
        lp = rerank.rerank_lp(corpus_raw, q_raw, cand,
                              torch.zeros(cand.shape, device=device), 1.0)
        top = cand.gather(1, torch.topk(lp, 10, dim=1).indices)
        r = float((top.cpu().numpy() == gold[:, None]).any(1).mean())
        out(f"P={P:5d}: pool_coverage={cov:.4f} "
            f"raw_rerank_recall@10={r:.4f}", flush=True)
        rec["pools"].append({"P": P, "pool_coverage": cov,
                             "raw_rerank_recall@10": r})
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from rag_cobweb_tpu_torch.bench.datasets import synthetic_retrieval_hard
    from rag_cobweb_tpu_torch.scripts._sweeps import fit_whitener
    from rag_cobweb_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    data = synthetic_retrieval_hard(10000, 1000, 768)
    return probe(data, fit_whitener(data.corpus_embs, 0.96), dev)


if __name__ == "__main__":
    main()
