"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for the control script that reads them at a cell's
own size.  Each takes the set-up and returns a function that undoes it.
(One card: no exchange between chips to leave out.)"""

from __future__ import annotations

import time

import numpy as np
import torch


def state_unchanged(s):
    """Adds acknowledged and dropped, in an add's time: the forest and the
    tiers never see the rows."""
    def add_sentences(sentences, vectors=None, **kw):
        time.sleep(0.05)
    db = s.db
    db.add_sentences = add_sentences
    return lambda: db.__dict__.pop("add_sentences", None)


def _wrap_query(s, fn):
    db = s.db
    orig = db.query_ids
    db.query_ids = lambda queries, k, rerank=None: fn(orig, queries, k,
                                                      rerank)
    return lambda: db.__dict__.pop("query_ids", None)


def half_batch(s):
    """Only the first half of each call answered; its answers stand in
    for the rest."""
    def fn(orig, queries, k, rerank):
        h = max(1, len(queries) // 2)
        ids = orig(np.ascontiguousarray(queries[:h]), k, rerank)
        return torch.cat([ids, ids])[:len(queries)]
    return _wrap_query(s, fn)


def answer_altered(s):
    """The last of each query's ten answers replaced where it is produced
    by another row."""
    def fn(orig, queries, k, rerank):
        ids = orig(queries, k, rerank).clone()
        ids[:, -1] = (ids[:, 0] + 977) % len(s.db.sentences)
        return ids
    return _wrap_query(s, fn)


def pools_halved(s):
    """Every call served from pools of half the configured sizes (the
    backstop follows the re-rank pool)."""
    def fn(orig, queries, k, rerank):
        return orig(queries, k, max(k, (rerank or s.pool) // 2))
    return _wrap_query(s, fn)


def sweep_garbage(s):
    """The sweep's pool replaced by rows drawn at random from those it
    ranked: the forest's path scores reach no answer."""
    from rag_cobweb_tpu_torch.core import index as index_mod
    orig = index_mod.fused_query_topk
    gen = torch.Generator(device=s.dev)
    gen.manual_seed(12345)

    def fused_query_topk(fidx, queries, k):
        cs, cand = orig(fidx, queries, k)
        hi = int(cand.max()) + 1
        rnd = torch.randint(hi, cand.shape, generator=gen, device=s.dev)
        return cs, rnd.to(cand.dtype)
    index_mod.fused_query_topk = fused_query_topk

    def undo():
        index_mod.fused_query_topk = orig
    return undo


ALL = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered,
                               pools_halved, sweep_garbage)}
