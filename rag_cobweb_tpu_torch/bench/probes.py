"""Probes of a served index, shared by ``chip_smoke.py`` and the bench
scripts: the kernels' launch counters, the plain serving pipeline the
served ids are held against, and the stage split of one served batch.

The counters are a view of ``utils/profiling``'s registry: each
kernel's launches (``launch.<wrapper>``), those of its second entry (the
sweeps' f32 entries, kernel 5's bf16-row entry) apart, and those made for
the backstop pool and the pending tier.  ``zero_counters`` takes the
registry's values as the base, ``read_counters`` the launches since.
The stage split reads the device-timed spans of one real ``query_ids``
call (``stage_split``, ``small_forest_split``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from rag_cobweb_tpu_torch.bench.metrics import retrieval_metrics
from rag_cobweb_tpu_torch.core import index as index_mod
from rag_cobweb_tpu_torch.ops import fused_topk, rerank
from rag_cobweb_tpu_torch.utils import profiling

# each kernel's counter and the entry counted apart from its main one
COUNTERS = {"fused_topk": ("launch.slab_topk", "f32"),
            "fused_group_topk": ("launch.slab_group_topk", "f32"),
            "blocked_topk": ("launch.blocked_topk", "f32"),
            "rerank_l2": ("launch.rerank_lp", "bf16")}
TIER_COUNTERS = {"backstop": "launch.backstop", "pending": "launch.pending"}
_base: dict = {}


def zero_counters():
    _base.clear()
    _base.update(profiling.counters())


def read_counters() -> dict:
    """Since ``zero_counters``: each kernel's launches of its main entry
    (the sweeps' bf16 one, kernel 5's f32 one), ``<name>_f32`` /
    ``<name>_bf16`` those of the other entry, and those made for the
    backstop pool and the pending tier."""
    now = profiling.counters()

    def since(name):
        return now.get(name, 0) - _base.get(name, 0)

    out = {}
    for k, (name, entry) in COUNTERS.items():
        out[f"{k}_{entry}"] = since(f"{name}_{entry}")
        out[k] = since(name) - out[f"{k}_{entry}"]
    out.update({k: since(name) for k, name in TIER_COUNTERS.items()})
    return out


def _plain_keys(raw, qs, cand, live, pv):
    """The re-rank's fresh-leaf key ``-0.5 (||q - x||^2 / pv + D log pv)``
    of each candidate row of ``raw``, -inf where not ``live``."""
    d2 = torch.sum(torch.square(qs.unsqueeze(1) - raw[cand]), dim=-1)
    lp = -0.5 * (d2 / pv + qs.shape[1] * math.log(pv))
    return torch.where(live, lp, torch.full_like(lp, float("-inf")))


def plain_check(db, queries, served, k: int, pool: int, bs: int,
                batch: int, corpus, targets=None) -> dict:
    """``db``'s served pipeline in plain PyTorch, batch by batch, held
    against its ``served`` ids.  Only the serving fused index is taken from
    ``db``; the rest is built here from ``corpus``, the raw rows of its
    sentences in order (a ``db`` without a whitener indexes them as they
    are): the whitened queries' top-``pool`` by the fused
    index's scores; with ``bs``, the top-``bs`` of the indexed rows by
    ``q . w - 0.5 ||w||^2`` over the corpus whitened here and rounded to
    bf16; the rows added since the index was built (each query's nearest
    ones by ``torch.cdist``); their union by ``np.unique``; the re-rank key
    on the raw rows; the top ``k``.  The served keys must not rise along
    a row by more than 1e-5 of their terms, and each id that is served
    but not plain, or plain but not served, must be a tie: its key within
    1e-5 of its terms of the k-th, or a pool score within 1e-3 + 1e-5 of
    its terms of that pool's last.  With ``targets``: the
    plain pipeline's recall@k and the golds its sweep pool leaves out.
    Returns the record."""
    fidx = db._fused_index()
    dev = fidx.GT.device
    pv = float(db.cfg.prior_var)
    nv, n = db._indexed_count(), len(db)
    raw = torch.as_tensor(np.asarray(corpus[:n], np.float32), device=dev)
    if bs:
        # the whole store in one transform, as one add of every indexed row
        # makes it
        W = db.whitener.transform_torch(raw[:nv]).to(torch.bfloat16).float()
        half = 0.5 * torch.sum(torch.square(W), dim=1)
    near = min(n - nv, max(64, 4 * k))    # added rows kept a query
    plain, outside, ties = [], 0, 0
    for s in range(0, len(queries), batch):
        qs = torch.as_tensor(queries[s:s + batch], device=dev)
        q = qs if db.whitener is None else db.whitener.transform_torch(qs)
        qq = fused_topk.query_terms(q, fidx.GT.dtype)
        full = fused_topk.slab_scores_plain(
            qq, fidx.GT, fidx.c, fidx.valid, float("-inf")).reshape(
                len(qq), -1)
        terms = torch.matmul(qq.float().abs(), fidx.GT.float().abs()) \
            + fidx.c.abs()
        cs, cand = torch.topk(full, pool, dim=1)
        pools = [(full, terms, cs[:, -1:])]
        lists = [(cand, cs)]
        if targets is not None:
            outside += _pool_misses(full, targets[s:s + batch], nv, pool)
        if bs:
            qb = q.to(torch.bfloat16).float()
            bfull = torch.matmul(qb, W.T) - half
            bterms = torch.matmul(qb.abs(), W.abs().T) + half
            bcs, bcand = torch.topk(bfull, bs, dim=1)
            pools.append((bfull, bterms, bcs[:, -1:]))
            lists.append((bcand, bcs))
        if near:
            d = torch.cdist(qs, raw[nv:n],
                            compute_mode="donot_use_mm_for_euclid_dist")
            ncand = torch.topk(d, near, dim=1, largest=False).indices + nv
            lists.append((ncand, torch.zeros(ncand.shape, device=dev)))
        ids_h = np.concatenate([c.cpu().numpy() for c, _ in lists], axis=1)
        live_h = np.concatenate(
            [torch.isfinite(v).cpu().numpy() for _, v in lists], axis=1)
        rows = [np.unique(i[m]) for i, m in zip(ids_h, live_h)]
        width = max(len(r) for r in rows)
        union = np.zeros((len(rows), width), np.int64)
        live = np.zeros((len(rows), width), bool)
        for i, r in enumerate(rows):
            union[i, :len(r)], live[i, :len(r)] = r, True
        union = torch.as_tensor(union, device=dev)
        lp = _plain_keys(raw, qs, union, torch.as_tensor(live, device=dev),
                         pv)
        top = torch.topk(lp, k, dim=1)
        ids = union.gather(1, top.indices)
        got = torch.as_tensor(served[s:s + batch], device=dev)
        plain.append(ids.cpu().numpy())

        def pool_tie(qi, sid):
            return any(sid < nv and abs(float(sc[qi, sid] - last[qi, 0]))
                       <= 1e-3 + 1e-5 * float(tm[qi, sid])
                       for sc, tm, last in pools)

        ties += _hold_served(raw, qs, got, ids, top.values, k, pv, s,
                             pool_tie)
        del full, terms, pools
    return _plain_record(np.concatenate(plain), served, ties, targets, k,
                         outside)


def _pool_misses(full, targets, nv: int, pool: int) -> int:
    """The golds ``targets`` whose score in ``full`` (B, S) is not among
    the top ``pool`` (more than ``pool - 1`` rows score above it), or
    that are not indexed (at or past ``nv``)."""
    gold = torch.as_tensor(np.asarray(targets), device=full.device).view(-1, 1)
    g = full.gather(1, gold.clamp(max=full.shape[1] - 1))
    return int(((gold[:, 0] >= nv) | ((full > g).sum(1) >= pool)).sum())


def golds_outside_pool(db, queries, targets, pool: int,
                       batch: int = 1024) -> int:
    """The golds the serving FusedIndex's top-``pool`` path scores leave
    out (plain f32 scores of its GT, batch by batch), as ``plain_check``
    counts them, without holding served ids."""
    fidx = db._fused_index()
    nv = db._indexed_count()
    outside = 0
    for s in range(0, len(queries), batch):
        q, _ = db._as_query_batch(queries[s:s + batch], True)
        full = fused_topk.slab_scores_plain(
            fused_topk.query_terms(q, fidx.GT.dtype), fidx.GT, fidx.c,
            fidx.valid, float("-inf")).reshape(len(q), -1)
        outside += _pool_misses(full, targets[s:s + batch], nv, pool)
    return outside


def _hold_served(raw, qs, got, ids, top, k: int, pv: float, s: int,
                 pool_tie) -> int:
    """The served ids ``got`` of one batch against the plain pipeline's
    ``ids`` (keys ``top``): the served keys must not rise along a row by
    more than 1e-5 of their terms, and each id served but not plain, or
    plain but not served, must be a tie: its key within 1e-5 of its terms
    of the k-th, or ``pool_tie(query, id)``.  Returns the tied ids."""
    dev, D = raw.device, raw.shape[1]
    gk = _plain_keys(raw, qs, got, torch.ones(
        got.shape, dtype=torch.bool, device=dev), pv)
    tol = 1e-5 * (top[:, -1:].abs() + 0.5 * D * abs(math.log(pv)))
    bad = torch.nonzero((gk[:, 1:] > gk[:, :-1] + tol).any(dim=1))[:, 0]
    if len(bad):
        qi = int(bad[0])
        raise AssertionError(
            f"query {s + qi}: served ids out of key order: "
            f"{got[qi].tolist()} with keys {gk[qi].tolist()}")
    ties = 0
    for qi in torch.nonzero((ids != got).any(dim=1))[:, 0].tolist():
        both = torch.as_tensor(np.union1d(ids[qi].cpu(), got[qi].cpu()),
                               device=dev).view(1, -1)
        keys = _plain_keys(raw, qs[qi:qi + 1], both,
                           torch.ones(both.shape, dtype=torch.bool,
                                      device=dev), pv)[0]
        kth = float(torch.topk(keys, k).values[-1])
        for sid in set(ids[qi].tolist()) ^ set(got[qi].tolist()):
            key = float(keys[both[0] == sid][0])
            tie = abs(key - kth) <= 1e-5 * (
                abs(kth) + 0.5 * D * abs(math.log(pv)))
            if not (tie or pool_tie(qi, sid)):
                raise AssertionError(
                    f"query {s + qi}: served id {sid} differs from the "
                    f"plain pipeline's and is no tie (key {key} vs the "
                    f"{k}-th {kth})")
            ties += 1
    return ties


def _plain_record(plain, served, ties: int, targets, k: int,
                  outside: int) -> dict:
    differ = (plain != served).any(axis=1)
    out = {"queries_differing_from_plain": int(differ.sum()),
           "queries_differing_in_order_only": int(sum(
               set(a) == set(b) for a, b in zip(plain[differ],
                                                 served[differ]))),
           "tied_ids": ties}
    if targets is not None:
        out["plain_recall@10"] = retrieval_metrics(
            plain, np.asarray(targets), k)["recall@10"]
        out["golds_outside_pool"] = outside
    return out


def small_forest_plain(db, queries, served, k: int, pool: int, batch: int,
                       corpus, targets=None) -> dict:
    """The small-forest engine's pipeline (a forest below
    ``blocked_threshold``) in plain PyTorch, batch by batch, held against
    its ``served`` ids as ``plain_check`` holds the fused engine's: the
    whitened queries through the same per-lane merge over the forest's
    stacked index (``parallel/vforest._vforest_query``, top ``pool``),
    then ``rerank_lp_plain`` on the raw rows ``corpus`` in place of kernel
    5, then the top ``k``.  The pools are the served ones, so a served id
    may differ only at a tie of the re-rank key.  With ``targets``: the
    plain pipeline's recall@k and the golds its pool leaves out.  Returns
    the record."""
    from rag_cobweb_tpu_torch.parallel.vforest import _vforest_query
    idx = db.forest.build_index()
    dev = idx.const.device
    pv = float(db.cfg.prior_var)
    n = len(db)
    raw = torch.as_tensor(np.asarray(corpus[:n], np.float32), device=dev)
    plain, outside, ties = [], 0, 0
    for s in range(0, len(queries), batch):
        qs = torch.as_tensor(queries[s:s + batch], device=dev)
        cs, cand = _vforest_query(idx, db.whitener.transform_torch(qs),
                                  min(max(pool, k), n))
        lp = rerank.rerank_lp_plain(raw, qs, cand, cs, pv)
        top = torch.topk(lp, min(k, n), dim=1)
        ids = cand.gather(1, top.indices)
        if targets is not None:
            gold = torch.as_tensor(np.asarray(targets[s:s + batch]),
                                   device=dev).view(-1, 1)
            outside += int((~(cand == gold).any(dim=1)).sum())
        got = torch.as_tensor(served[s:s + batch], device=dev)
        plain.append(ids.cpu().numpy())
        ties += _hold_served(raw, qs, got, ids, top.values, k, pv, s,
                             lambda qi, sid: False)
    return _plain_record(np.concatenate(plain), served, ties, targets, k,
                         outside)


def leaf_keys(db, queries, ids: np.ndarray):
    """Each sentence id's leaf log-prob under its query, the key
    ``predict`` ranks by, on ``db``'s flat index (-inf for an id of -1),
    and the magnitude of its terms (|q| . |mu/var| + 0.5 q^2 . 1/var +
    |const|, the scale of its float32 rounding) -> two (B, k) host
    arrays."""
    idx = (db.forest.flat_index() if db.forest is not None
           else db.build_prediction_index())
    q, _ = db._as_query_batch(queries, True)
    ids_t = torch.as_tensor(np.asarray(ids), device=q.device)
    leaf = index_mod._sentence_leaf_nodes(idx)[ids_t.clamp(min=0)]
    x = q.float().unsqueeze(1)
    movt, ivt = idx.mu_over_var_T.T[leaf], idx.inv_var_T.T[leaf]
    c = idx.const[leaf]
    lp = (torch.sum(x * movt, -1) - 0.5 * torch.sum(x * x * ivt, -1) + c)
    terms = (torch.sum(x.abs() * movt.abs(), -1)
             + 0.5 * torch.sum(x * x * ivt, -1) + c.abs())
    lp = torch.where(ids_t >= 0, lp, torch.full_like(lp, float("-inf")))
    return lp.cpu().numpy(), terms.cpu().numpy()


def hold_beam(db, queries, want: list, got: list) -> dict:
    """``predict``'s ids ``got`` (a list a query) against ``want`` from the
    same index elsewhere (another device, a loaded copy): at each place
    the two ids' leaf log-probs (``leaf_keys`` on ``db``) agree within
    1e-5 of the row's largest term, and the ids are equal wherever that
    key ties no other key of the row nor its last.  Raises otherwise;
    returns the queries that differ, the tied places and the first few of
    them with their keys."""
    k = max(max(map(len, want)), max(map(len, got)), 1)
    w = np.full((len(want), k), -1, np.int64)
    g = np.full((len(got), k), -1, np.int64)
    for i, (a, b) in enumerate(zip(want, got)):
        w[i, :len(a)], g[i, :len(b)] = a, b
    if not np.array_equal(w < 0, g < 0):
        raise AssertionError("predict: the two serve ids at other places")
    kw, tw = leaf_keys(db, queries, w)
    kg, _ = leaf_keys(db, queries, g)
    shown, tied = [], 0
    for b in np.nonzero((w != g).any(axis=1))[0]:
        m = w[b] >= 0
        tol = 1e-5 * float(tw[b][m].max())
        if np.abs(kw[b][m] - kg[b][m]).max() > tol:
            raise AssertionError(
                f"predict, query {b}: keys differ beyond {tol:.3g}: "
                f"{w[b].tolist()} {kw[b].tolist()} vs {g[b].tolist()} "
                f"{kg[b].tolist()}")
        key = kw[b][m]
        near = np.abs(key[:, None] - key[None, :]) <= tol
        tie = (near.sum(1) > 1) | (np.abs(key - key[-1]) <= tol)
        diff = w[b][m] != g[b][m]
        if (diff & ~tie).any():
            raise AssertionError(
                f"predict, query {b}: ids differ at an untied place: "
                f"{w[b].tolist()} vs {g[b].tolist()}, keys {key.tolist()}")
        tied += int(diff.sum())
        if len(shown) < 4:
            shown.append({"query": int(b), "want": w[b].tolist(),
                          "got": g[b].tolist(), "keys": key.tolist()})
    return {"queries_differing": int((w != g).any(axis=1).sum()),
            "tied_places": tied, "shown": shown}


# the stage names the callers print, each the device ms of these spans
# in one call (``engine.merge`` of the sweep's pool alone; kernel 5 is
# ``engine.rerank`` less the final top-k inside it)
STAGES = (("upload", "serve.upload"), ("whitening", "serve.whiten"),
          ("kernel 1", "engine.sweep"), ("pool merge", "engine.merge"),
          ("backstop pool", "engine.backstop"), ("union", "engine.union"),
          ("kernel 5", "engine.rerank"), ("final top-k", "engine.topk"),
          ("tiers", "tiers.merge"), ("to host", "probe.to_host"))
SMALL_FOREST_STAGES = (
    ("upload", "serve.upload"), ("whitening", "serve.whiten"),
    ("per-lane scoring", "engine.lane_scores"),
    ("per-lane and merge top-k", "engine.lane_merge"),
    ("kernel 5", "engine.rerank"), ("final top-k", "engine.topk"),
    ("to host", "probe.to_host"))


def stage_split(db, queries, k: int, pool: int) -> dict:
    """Stream ms of each stage of one served batch (``queries``, pool
    ``pool``), read from the device-timed spans of a real
    ``db.query_ids`` call: upload, whitening, kernel 1 (with the query
    terms), pool merge (``torch.topk``), the backstop pool (kernel 1 and
    its merge) and the union when the backstop is on, kernel 5, final
    ``torch.topk`` and gather, the pending and delta tiers and their merge
    when rows are pending, ids to the host.  The last of three calls,
    beside the host's wall time of that call; stages that do not run are
    left out.  On the host the stages are the spans' host ms."""
    return _span_split(db, queries, k, pool, STAGES)


def small_forest_split(db, queries, k: int, pool: int) -> dict:
    """Stream ms of each stage of one batch served by the small-forest
    engine, as ``stage_split``: upload, whitening, per-lane scoring (the
    lane-batched products and the per-hop path gather), per-lane and merge
    top-k, kernel 5, final top-k and gather, ids to the host."""
    return _span_split(db, queries, k, pool, SMALL_FOREST_STAGES)


def _span_split(db, queries, k: int, pool: int, stages) -> dict:
    """Three ``query_ids`` calls with tracing on, each ids to the host
    inside one ``probe.split`` span; the last call's stages by ``stages``
    (stream ms on the card, host ms on the host), their sum, the host's
    wall ms of the call and the batch size."""
    def sync():
        if db.device.type == "cuda":
            torch.cuda.synchronize(db.device)

    was = profiling.tracing(True)
    try:
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            with profiling.span("probe.split") as sp:
                ids = db.query_ids(queries, k, rerank=pool)
                with profiling.span("probe.to_host", device=ids.device):
                    ids.cpu()
            sync()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        profiling.tracing(was)
    ms: dict = {}
    for r in profiling.records():
        if r["request"] != sp.request or (
                r["name"] == "engine.merge"
                and r["attrs"].get("pool") != "sweep"):
            continue
        t = r["device_ms"]
        if t is None:
            t = 1e-6 * (r["t1_ns"] - r["t0_ns"])
        ms[r["name"]] = ms.get(r["name"], 0.0) + t
    if "engine.rerank" in ms:
        ms["engine.rerank"] -= ms.get("engine.topk", 0.0)
    split = {stage: ms[name] for stage, name in stages if name in ms}
    split["sum"] = sum(split.values())
    split["wall"] = wall
    split["B"] = len(queries)
    return split


# ---------------------------------------------------------------------------
# the multi-device engines (parallel/tp.py), held on one device
# ---------------------------------------------------------------------------

def _shard_pools(full, terms, n_shards: int, pool: int, tol):
    """Each of ``n_shards`` equal column ranges' top-``pool`` of (B, S)
    scores (the TP split: ``ceil(S / K)`` columns a shard, those past S
    -inf) -> (candidates (B,
    K * pool) global columns, their scores, and ``pool_tie(query, col)``:
    whether the column's score is within ``tol(score, terms)`` of its
    range's last pool score)."""
    B, S = full.shape
    w = -(-S // n_shards)
    pad = w * n_shards - S
    full = torch.nn.functional.pad(full, (0, pad), value=float("-inf"))
    terms = torch.nn.functional.pad(terms, (0, pad))
    cs, pos = torch.topk(full.view(B, n_shards, w), min(pool, w), dim=2)
    cand = pos + (torch.arange(n_shards, device=full.device) * w).view(
        1, -1, 1)
    last = cs[:, :, -1]

    def pool_tie(qi, col):
        sc, last_s = float(full[qi, col]), float(last[qi, col // w])
        return abs(sc - last_s) <= tol(abs(last_s), float(terms[qi, col]))

    return cand.reshape(B, -1), cs.reshape(B, -1), pool_tie


def _hold_shard_union(raw, qs, cand, cs, got, k: int, s: int, pool_tie):
    """The union of the shards' pools re-ranked by ``-||q - x||^2`` on the
    rows ``raw`` (the re-rank key at prior variance 1), held against the
    served ids of one batch -> (plain ids (B, k), tied ids)."""
    live = torch.isfinite(cs)
    cand = torch.where(live, cand, torch.zeros_like(cand))
    lp = _plain_keys(raw, qs, cand, live, 1.0)
    top = torch.topk(lp, k, dim=1)
    ids = cand.gather(1, top.indices)
    return ids, _hold_served(raw, qs, got, ids, top.values, k, 1.0, s,
                             pool_tie)


def tp_fused_plain(fidx, raw, queries_w, queries, served, k: int, pool: int,
                   n_shards: int, batch: int = 1024, targets=None) -> dict:
    """The fused TP engine's pipeline (``TPFusedPredictionIndex`` at
    ``rerank=pool`` on ``n_shards`` ranks) in plain PyTorch on one
    device, batch by batch, held against its ``served`` ids as
    ``plain_check`` holds the fused engine's: each shard's columns' top
    ``pool`` by the f32 scores of ``fidx`` (the whitened ``queries_w``),
    their union, the exact key on the raw rows ``raw`` (the raw
    ``queries``), the top ``k``.  A served id that differs must be a tie
    of the key or of its shard's pool's last score (within 1e-3 + 1e-5 of
    its terms).  Returns the record."""
    dev = fidx.GT.device
    raw = torch.as_tensor(np.asarray(raw, np.float32), device=dev)
    plain, ties = [], 0
    for s in range(0, len(queries), batch):
        qs = torch.as_tensor(queries[s:s + batch], device=dev)
        qw = torch.as_tensor(queries_w[s:s + batch], device=dev)
        qq = fused_topk.query_terms(qw, fidx.GT.dtype)
        full = fused_topk.slab_scores_plain(
            qq, fidx.GT, fidx.c, fidx.valid, float("-inf")).reshape(
                len(qq), -1)
        terms = (torch.matmul(qq.float().abs(), fidx.GT.float().abs())
                 + fidx.c.abs())
        cand, cs, pool_tie = _shard_pools(
            full, terms, n_shards, pool, lambda last, t: 1e-3 + 1e-5 * t)
        got = torch.as_tensor(served[s:s + batch], device=dev)
        ids, t = _hold_shard_union(raw, qs, cand, cs, got, k, s, pool_tie)
        plain.append(ids.cpu().numpy())
        ties += t
    return _plain_record(np.concatenate(plain), served, ties, targets, k, 0)


def tp_path_plain(index, raw, queries_w, queries, served, k: int, pool: int,
                  n_shards: int, batch: int = 1024) -> dict:
    """``TPPredictionIndex`` at ``rerank=pool`` with stored rows, in plain
    PyTorch on one device: each shard's sentences' (the S split) top
    ``pool`` path scores (``rank_scores``), their union, ``exact_rerank``'s
    order on ``raw`` (the key at prior variance 1), the top ``k``; held
    against ``served``.  A pool tie is a path score within 1e-3 + 1e-4 of
    the shard's last (the TP engine sums its node log-probs over the
    ranks: ``tests/test_tp.py``'s tolerance).  Returns the record."""
    dev = index.const.device
    raw = torch.as_tensor(np.asarray(raw, np.float32), device=dev)
    plain, ties = [], 0
    for s in range(0, len(queries), batch):
        qs = torch.as_tensor(queries[s:s + batch], device=dev)
        qw = torch.as_tensor(queries_w[s:s + batch], device=dev)
        full = index_mod.rank_scores(index, qw)
        cand, cs, pool_tie = _shard_pools(
            full, torch.zeros_like(full), n_shards, pool,
            lambda last, t: 1e-3 + 1e-4 * last)
        got = torch.as_tensor(served[s:s + batch], device=dev)
        ids, t = _hold_shard_union(raw, qs, cand, cs, got, k, s, pool_tie)
        plain.append(ids.cpu().numpy())
        ties += t
    return _plain_record(np.concatenate(plain), served, ties, None, k, 0)


def hold_ids_at_ties(want_ids, got_ids, want_keys, got_keys,
                     rtol: float = 1e-4) -> dict:
    """Two rankings of the same queries by one key computed in two ways:
    at each place the keys agree within ``rtol`` of the row's largest
    |key| (and 1), and the ids are equal at every place whose key ties no
    other key of the row nor its last within that.  Raises otherwise;
    returns the rows and places that differ."""
    want_keys, got_keys = np.asarray(want_keys), np.asarray(got_keys)
    rows, places = 0, 0
    for b in np.nonzero((np.asarray(want_ids) != np.asarray(got_ids))
                        .any(axis=1))[0]:
        key = want_keys[b]
        tol = rtol * max(float(np.abs(key[np.isfinite(key)]).max()), 1.0)
        fin = np.isfinite(key)
        if (np.abs(got_keys[b][fin] - key[fin]) > tol).any() or not \
                np.array_equal(np.isfinite(got_keys[b]), fin):
            raise AssertionError(f"query {b}: keys differ beyond {tol:.3g}:"
                                 f" {key.tolist()} vs {got_keys[b].tolist()}")
        near = np.abs(key[:, None] - key[None, :]) <= tol
        tied = (near.sum(1) > 1) | (np.abs(key - key[-1]) <= tol)
        diff = np.asarray(want_ids[b]) != np.asarray(got_ids[b])
        if (diff & ~tied).any():
            raise AssertionError(
                f"query {b}: ids differ at an untied place: "
                f"{list(want_ids[b])} vs {list(got_ids[b])}, keys "
                f"{key.tolist()}")
        rows += 1
        places += int(diff.sum())
    return {"queries_differing": rows, "tied_places": places}


def _event_split(run, B: int) -> dict:
    """``run(mark)`` three times, ``mark(name)`` recording a CUDA event
    after each stage; the stream ms between the last run's events, their
    sum, the host's wall ms of that run and the batch size."""
    for _ in range(3):
        ev = []

        def mark(name):
            ev.append((name, torch.cuda.Event(enable_timing=True)))
            ev[-1][1].record()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        run(mark)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    split = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(ev, ev[1:])}
    split["sum"] = sum(split.values())
    split["wall"] = wall
    split["B"] = B
    return split


def tp_split(tpf, queries_w, queries, k: int, pool: int) -> dict:
    """Stream ms of each stage of one batch served by a
    ``TPFusedPredictionIndex`` on this rank (``_event_split``): upload,
    kernel 1 (query terms, the slab's pools and their merge), kernel 5 on
    the rank's rows, the all-gather merge, ids to the host."""
    from rag_cobweb_tpu_torch.parallel import collectives
    kk = min(max(k, pool), tpf.slab.width)

    def run(mark):
        qw = torch.as_tensor(queries_w, device=tpf.device)
        qs = torch.as_tensor(queries, device=tpf.device)
        mark("upload")
        top, rows = tpf.local_pool(qw, kk)
        mark("kernel 1")
        key = tpf.local_rerank(qs, top, rows)
        mark("kernel 5")
        _, ids = collectives.merge_topk(key, tpf.slab.sid[rows], k,
                                        tpf.group)
        mark("all-gather merge")
        ids.cpu()
        mark("to host")

    return _event_split(run, len(queries))
