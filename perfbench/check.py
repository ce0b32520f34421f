"""What decides ``correct``: the answers the port served, held against the
plain reference (``reference.py``), once the window has closed.

A sample of the window's queries, drawn from the seed, is answered again
by the reference over the rows indexed and added at that query's time,
from pools of ``margin`` of the configured sizes (the same fraction of
each, best first):

* ``bad_ids``: answers with an id that is no row at that time, or that
  repeats (limit 0);
* ``rank_gap``: the widest gap, over the sample and the ``k`` places, by
  which the squared distance of the served row at a place exceeds the
  reference's at that place, over the reference's.  The reference's
  pools are those of the configuration cut to ``margin``, so a sound
  answer is never worse at any place, and a port that serves smaller
  pools, leaves a row out, orders wrongly or ranks in too low a
  precision is.  Where the window adds rows, the index that served a
  query came from a state that later adds changed: there the reference
  holds the window's answers with the backstop pool and the tiers, which
  it works out from the rows alone;
* ``sweep_gap``: the same gap for the calls answered after the window
  with the backstop off (``Setup.sweep_calls``), against the reference's
  sweep pool alone: with the backstop on, it may hold every answer by
  itself, and a sweep that returns garbage would show nowhere.  Where
  the window adds rows, these calls are answered from an index rebuilt
  over the final state;
* ``whiten_gap``: the port's whitened rows (its leaves' means) against the
  reference's whitening, turned to the port's basis;
* ``rows_missing`` (limit 0) and ``state_gap``: the forest state by itself.

``control`` puts the reference in the port's place, with the configured
pools and its re-rank rounded to bf16 (the precision below the
configuration's float32 re-rank), and reads the same numbers of its
answers.  ``margins`` (the control script) reads the gaps at other
margins too, and ``exact_miss``: the share of the exact top ``k`` over
every row the query could see that the served answer lacks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench import reference as ref

ORDER = ("bad_ids", "rank_gap", "sweep_gap", "whiten_gap", "rows_missing",
         "state_gap")


class Answers(NamedTuple):
    """Served answers to check: the queries, the ids, and per query the
    rows live and the rows the serving index covered at its time."""

    q: torch.Tensor
    served: torch.Tensor
    n_total: list
    n_idx: list


def _rows_fn(data):
    N = data.corpus.shape[0]

    def rows(ids):
        out = torch.empty(ids.shape + (data.corpus.shape[1],),
                          device=data.corpus.device)
        fresh = ids >= N
        out[~fresh] = data.corpus[ids[~fresh]]
        out[fresh] = data.fresh[ids[fresh] - N]
        return out
    return rows


def _sample(calls, n: int, seed: int):
    """(call, row) pairs of the window's queries, ``n`` of them drawn from
    the seed (all where fewer)."""
    pairs = [(ci, r) for ci, c in enumerate(calls) for r in range(c["B"])]
    rng = np.random.default_rng((int(seed) ^ 0x5A5A5A5A) & ((1 << 63) - 1))
    pick = (rng.choice(len(pairs), n, replace=False) if len(pairs) > n
            else np.arange(len(pairs)))
    return [pairs[i] for i in sorted(pick)]


def _answers(s, calls, picks) -> Answers:
    data, dev = s.data, s.dev

    def query(c, r):
        n = len(c["pool"])
        return (data.queries[int(c["pool"][r])] if r < n
                else data.fresh_queries[int(c["fresh"][r - n])])
    q = torch.stack([query(calls[ci], r) for ci, r in picks])
    served = torch.stack([calls[ci]["ids"][r] for ci, r in picks]).to(
        dev).long()
    return Answers(q, served, [calls[ci]["n_total"] for ci, _ in picks],
                   [calls[ci]["n_indexed"] for ci, _ in picks])


def _bad(a: Answers) -> torch.Tensor:
    """(B,) answers with an id that is no row at their time, or twice."""
    n = torch.tensor(a.n_total, device=a.served.device)[:, None]
    out_of = ((a.served < 0) | (a.served >= n)).any(1)
    srt = torch.sort(a.served, 1).values
    return out_of | (srt[:, 1:] == srt[:, :-1]).any(1)


def _gap(a: Answers, want: torch.Tensor, rows, bad=None) -> float:
    """The widest relative gap by which a served row's squared distance
    exceeds the reference's at the same place (answers with bad ids
    left to ``bad_ids``)."""
    bad = _bad(a) if bad is None else bad
    gap = 0.0
    for b0 in range(0, len(a.q), 64):
        sl = slice(b0, b0 + 64)
        q, s, w = a.q[sl], a.served[sl], want[sl]
        ok = ~bad[sl]
        d_s = ref._d2(q, rows(s.clamp(min=0)), torch.float64)
        d_w = ref._d2(q, rows(w.clamp(min=0)), torch.float64)
        g = (d_s - d_w) / d_w.clamp(min=1e-300)
        g = g[ok[:, None] & (w >= 0)]
        if len(g):
            gap = max(gap, float(g.max()))
    return gap


def _miss(a: Answers, exact: torch.Tensor) -> float:
    """Share of the exact top ``k`` (-1 padded) that the answers lack."""
    live = exact >= 0
    hit = (exact[:, :, None] == a.served[:, None, :]).any(2) & live
    return float(1.0 - hit.sum() / live.sum().clamp(min=1))


def _port_state(db):
    f = db.forest
    st = f.state
    leaf = torch.as_tensor(f._leaf_global(), device=st.counts.device)
    return ref.ForestState(st.counts, st.means, st.m2s, st.parent,
                           st.children, st.root, leaf)


class _Pools:
    """The reference's pools of each query at the configured sizes, best
    first: the sweep's (from the forest state, where it served the
    answers) and the backstop's (from the rows), each over the rows
    indexed at the query's time; ``cut(frac)`` unites the first ``frac``
    of each."""

    def __init__(self, s, a: Answers, zq, R, zrows, G, c, backstop=True):
        B, dev = len(a.q), s.dev
        self.sweep = torch.full((B, s.pool), -1, dtype=torch.long,
                                device=dev) if G is not None else None
        bmax = (max(s.backstop_size(n) for n in a.n_total) if backstop
                else 0)
        self.back = torch.full((B, bmax), -1, dtype=torch.long, device=dev)
        for ni in sorted(set(a.n_idx)):
            sel = [i for i, v in enumerate(a.n_idx) if v == ni]
            for b0 in range(0, len(sel), 256):
                part = sel[b0:b0 + 256]
                if G is not None:
                    # a state that lost rows has fewer: rows_missing
                    # says so
                    p = ref.sweep_pool(G, c, zq[part] @ R,
                                       min(ni, G.shape[0]), s.pool)
                    self.sweep[part, :p.shape[1]] = p
                bs = s.backstop_size(max(a.n_total[i] for i in part))
                if bs and backstop:
                    p = ref.backstop_pool(zrows, zq[part], ni, bs)
                    self.back[part, :p.shape[1]] = p
        self.pool, self.bs = s.pool, bmax

    def cut(self, frac: float) -> torch.Tensor:
        parts = [self.back[:, :int(frac * self.bs)]]
        if self.sweep is not None:
            parts.append(self.sweep[:, :int(frac * self.pool)])
        return torch.cat(parts, 1)


def check(s, seed: int, trace: bool, control: bool = False,
          margins=(), keep_port: bool = False) -> dict:
    """The numbers compared, each with its limit, and ``correct``.
    ``margins``: also the gaps at each of these margins (and the
    control's, and ``exact_miss``) under ``readings``; ``keep_port``:
    leave the program's state alive (the control script runs more
    windows on it)."""
    cfg, dev = s.cfg, s.dev
    ck = cfg["check"]
    adds = bool(int(s.mix.get("add_every", 0)))
    s.sweep_calls(int(ck["post_calls"]))
    data = s.data       # after the window's rows and the last add
    calls = [c for c in s.calls if not c["add"]]
    win = _answers(s, calls, _sample(calls, int(ck["sample"]), seed))
    post = _answers(s, s.post_calls, [(ci, r) for ci, c in
                                      enumerate(s.post_calls)
                                      for r in range(c["B"])])
    n_rows = s.N + s.added
    # the program's state that the reference follows; the rest is freed
    st = _port_state(s.db)
    if not keep_port:
        s.db = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rows = _rows_fn(data)
    tr, wh = cfg["tree"], cfg["index"]["whitener"]
    metric = ref.fit_metric(data.corpus[:int(wh["fit_rows"])],
                            wh["pca_dim"], int(wh["ica_sample_size"]))
    out = dict(ref.state_gaps(st, n_rows))
    if metric.dim != st.means.shape[2]:
        raise RuntimeError(f"the reference whitens to {metric.dim} "
                           f"dimensions, the port's tree has "
                           f"{st.means.shape[2]}")
    # the whitening: rows that are alone in their leaf
    K, N1 = st.counts.shape
    leaf = st.leaf_of_row[:n_rows]
    cnt = st.counts[leaf // (N1 - 1), leaf % (N1 - 1)]
    alone = torch.nonzero(cnt == 1).squeeze(1)[:int(ck["basis_rows"])]
    z = ref.whiten(metric, rows(alone))
    port_rows = st.means[leaf[alone] // (N1 - 1), leaf[alone] % (N1 - 1)]
    R, out["whiten_gap"] = ref.basis(z, port_rows)
    zrows = torch.cat([ref.whiten(metric, rows(torch.arange(
        r0, min(n_rows, r0 + (1 << 17)), device=dev))).float()
        for r0 in range(0, n_rows, 1 << 17)])
    # the sweep pool follows the state: that of the window's own index
    # where nothing was added, that of the rebuilt one after it where rows
    # were
    G, c = ref.path_terms(st, float(tr["prior_var"]),
                          bool(tr["acuity_cutoff"]))
    margin = float(ck["margin"])
    sets = {"rank_gap": win, "sweep_gap": post}
    work = {}
    for name, a in sets.items():
        zq = ref.whiten(metric, a.q)
        sweep = name == "sweep_gap" or not adds
        pools = _Pools(s, a, zq, R, zrows, G if sweep else None, c,
                       backstop=name == "rank_gap")
        tiers = ref.exact_top(a.q, list(zip(a.n_idx, a.n_total)), rows,
                              s.k)
        bad = _bad(a)
        want = ref.answer(a.q, pools.cut(margin), tiers, rows, s.k)
        out[name] = _gap(a, want, rows, bad)
        work[name] = (a, pools, tiers, bad)
    out["bad_ids"] = sum(int(_bad(a).sum()) for a in sets.values())
    lim = cfg["limits"]
    names = [k for k in ORDER if k in lim]
    res = {"numbers": {k: out[k] for k in names}}
    if control or margins:
        res["control"] = _controls(s, work, rows, st, n_rows, metric, alone,
                                   port_rows, margin)
    if margins:
        res["readings"] = _readings(s, work, rows, margins)
    if trace and not adds:
        res["rerank_work"] = _rerank_work(s, G, c, zrows, R, metric, calls)
    res["limits"] = {k: float(lim[k]) for k in names}
    res["correct"] = all(res["numbers"][k] <= res["limits"][k]
                         for k in names)
    return res


def _readings(s, work, rows, margins) -> dict:
    """The port's and the control's gaps at each margin, and the share of
    the exact top ``k`` that the served answers lack."""
    out = {}
    for name, (a, pools, tiers, bad) in work.items():
        ctrl = ref.answer(a.q, pools.cut(1.0), ref.exact_top(
            a.q, list(zip(a.n_idx, a.n_total)), rows, s.k,
            torch.bfloat16), rows, s.k, dtype=torch.bfloat16)
        for m in margins:
            want = ref.answer(a.q, pools.cut(m), tiers, rows, s.k)
            r = out.setdefault(str(m), {})
            r[name] = _gap(a, want, rows, bad)
            r["control_" + name] = _gap(a._replace(served=ctrl), want,
                                        rows)
        exact = ref.exact_top(a.q, [(0, n) for n in a.n_total], rows, s.k)
        out["exact_miss_" + name] = _miss(a, exact)
        out["missed_at_" + name] = _missed_at(a, pools, tiers, rows, s.k)
    return out


def _missed_at(a: Answers, pools, tiers, rows, k: int) -> list:
    """Where a gap at the full pools comes from: for each row of the
    reference's answer that the served one lacks, its place in the
    reference's pool (sweep's or backstop's, of the configured size)."""
    want = ref.answer(a.q, pools.cut(1.0), tiers, rows, k)
    found = []
    for b in range(len(a.q)):
        for r in want[b][want[b] >= 0].tolist():
            if r in a.served[b].tolist():
                continue
            for part, p in (("sweep", pools.sweep), ("backstop", pools.back)):
                if p is not None and (p[b] == r).any():
                    found.append((b, part, int((p[b] == r).nonzero()[0])))
    return found[:40]


def _rerank_work(s, G, c, zrows, R, metric, calls):
    """Kernel 5's work in one traced call, worked out by the reference:
    the live candidate pairs (distinct ids of each query's united pools)
    and the distinct rows among them."""
    call = ([c_ for c_ in calls if c_["traced"]] or calls)[0]
    data, dev = s.data, s.dev
    q = torch.cat([data.queries[torch.as_tensor(call["pool"], device=dev)],
                   data.fresh_queries[torch.as_tensor(call["fresh"],
                                                      device=dev)]])
    zq = ref.whiten(metric, q)
    ni, bs = call["n_indexed"], s.backstop_size(call["n_total"])
    pairs, seen = 0, []
    for b0 in range(0, len(q), 128):
        got = [ref.sweep_pool(G, c, zq[b0:b0 + 128] @ R, ni, s.pool)]
        if bs:
            got.append(ref.backstop_pool(zrows, zq[b0:b0 + 128], ni, bs))
        srt = torch.sort(torch.cat(got, 1), 1).values
        live = torch.ones_like(srt, dtype=torch.bool)
        live[:, 1:] = srt[:, 1:] != srt[:, :-1]
        pairs += int(live.sum())
        seen.append(torch.unique(srt))
    return {"B": len(q), "pairs": pairs,
            "rows": len(torch.unique(torch.cat(seen)))}


def _controls(s, work, rows, st, n_rows, metric, alone, port_rows,
              margin) -> dict:
    """The numbers of each stage computed one precision below the
    configuration's: the re-rank with rows and queries in bf16 (the
    reference in the port's place, with the configured pools), the
    whitening as a float32 product, the forest's statistics stored in bf16
    (the port's ``compress_stats``)."""
    out = {"bad_ids": 0}
    for name, (a, pools, _, _) in work.items():
        tiers = ref.exact_top(a.q, list(zip(a.n_idx, a.n_total)), rows,
                              s.k, torch.bfloat16)
        ctrl = ref.answer(a.q, pools.cut(1.0), tiers, rows, s.k,
                          dtype=torch.bfloat16)
        want = ref.answer(a.q, pools.cut(margin), work[name][2], rows, s.k)
        out[name] = _gap(a._replace(served=ctrl), want, rows)
    z32 = ((rows(alone).float() - metric.mean.float())
           @ metric.proj.float()).double()
    R, _ = ref.basis(ref.whiten(metric, rows(alone)), port_rows)
    p = port_rows.double()
    err = torch.linalg.vector_norm(z32 @ R - p, dim=1)
    out["whiten_gap"] = float(err.max()
                              / torch.linalg.vector_norm(p, dim=1).median())
    bf = st._replace(means=st.means.to(torch.bfloat16),
                     m2s=st.m2s.to(torch.bfloat16))
    out["state_gap"] = ref.state_gaps(bf, n_rows)["state_gap"]
    out["rows_missing"] = 0
    return out
