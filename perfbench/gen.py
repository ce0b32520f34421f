"""The one generator of the benchmark: a configuration's rows and query
pool, and a traffic mix's call schedule, from ``--seed``.

The rows follow the hard synthetic retrieval distribution of the port's
``bench/datasets.synthetic_retrieval_hard`` (copied here and rewritten in
PyTorch, so the rows are drawn on the device in a few large calls):
overlapping Gaussian cluster centres, Student-t noise (``df`` = 5, drawn
as a normal over the root mean square of five normals), one gold row per
query at a log-normal query radius, near-duplicate distractor groups at
log-uniform radii around a quarter of the golds, and the anisotropic
spectrum that whitening is for.  The same seed gives the same rows on
one device; the sizes come only from the configuration, never from the
seed.

The call schedule (which queries a call carries, when the adds come) is
host numpy from the same seed: indices only, the rows stay on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1


class Data(NamedTuple):
    corpus: torch.Tensor      # (N, D) f32 rows, indexed at set-up
    queries: torch.Tensor     # (Q, D) f32 query pool
    gold: torch.Tensor        # (Q,) int64 gold row of each pool query
    fresh: torch.Tensor       # (F, D) f32 rows the window adds, in order
    fresh_queries: torch.Tensor  # (F, D) f32: query i has gold fresh row i


def _generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & _SEED_MASK)
    return g


def _t_noise(shape, df: int, g: torch.Generator, device) -> torch.Tensor:
    """Unit-variance Student-t noise with integer ``df``: z / sqrt(chi2/df)
    with chi2 a sum of ``df`` squared normals."""
    z = torch.randn(shape, generator=g, device=device)
    chi = torch.zeros(shape, device=device)
    for _ in range(df):
        chi.add_(torch.randn(shape, generator=g, device=device).square_())
    t = z.mul_(torch.rsqrt(chi.div_(df)))
    return t.mul_(float(np.sqrt((df - 2.0) / df)))


def spectrum(dim: int, anisotropy: float) -> torch.Tensor:
    """Per-dimension scales: a few dominant directions, then a decay."""
    i = torch.arange(dim, dtype=torch.float64)
    s = torch.where(i < max(4, dim // 24), torch.ones_like(i),
                    (1.0 - anisotropy) + anisotropy * torch.exp(
                        -i / (dim / 6.0)))
    return s.float()


def _rows_fn(cfg: dict, seed: int, device, chunk: int):
    """``rows(n, gen)``: ``n`` rows drawn around the configuration's
    cluster centres (drawn first from the seed's stream 0), before the
    spectrum is applied."""
    a = cfg["assumed"]["generator"]
    D = int(cfg["dim"])
    df = int(a["df"])
    n_clusters = int(a["n_clusters"])
    g = _generator(seed, device, 0)
    centers = torch.randn((n_clusters, D), generator=g, device=device)

    def rows(n: int, gen):
        out = torch.empty((n, D), device=device)
        assign = torch.randint(n_clusters, (n,), generator=gen,
                               device=device)
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            out[s:s + m] = centers[assign[s:s + m]] + float(a["noise"]) \
                * _t_noise((m, D), df, gen, device)
        return out
    return g, rows


def _qscale(a: dict, n: int, gen, device):
    return float(a["query_noise"]) * torch.exp(
        float(a["query_noise_spread"])
        * torch.randn((n, 1), generator=gen, device=device))


def make_data(cfg: dict, seed: int, device, fresh_rows: int = 0,
              chunk: int = 1 << 17) -> Data:
    """The configuration's rows, query pool and the first ``fresh_rows``
    window rows (each with one query; ``fresh_chunk`` 0), on ``device``.
    ``cfg``: the ``rows``, ``dim``, ``queries`` and the ``assumed``
    generator parameters."""
    a = cfg["assumed"]["generator"]
    N, D, Q = int(cfg["rows"]), int(cfg["dim"]), int(cfg["queries"])
    df = int(a["df"])
    g, rows = _rows_fn(cfg, seed, device, chunk)
    scales = spectrum(D, float(a["anisotropy"])).to(device)

    corpus = rows(N, g)
    gold = torch.randperm(N, generator=g, device=device)[:Q]
    qs = _qscale(a, Q, g, device)
    queries = corpus[gold] + qs * _t_noise((Q, D), df, g, device)

    # near-duplicate groups over rows that are no gold
    n_dup_t = int(round(float(a["dup_targets_frac"]) * Q))
    group = int(a["dup_group"])
    if n_dup_t and group:
        free = torch.ones(N, dtype=torch.bool, device=device)
        free[gold] = False
        free_ids = free.nonzero().squeeze(1)
        n_dup_t = min(n_dup_t, len(free_ids) // group)
        dup_t = torch.randperm(Q, generator=g, device=device)[:n_dup_t]
        slots = free_ids[torch.randperm(len(free_ids), generator=g,
                                        device=device)[:n_dup_t * group]]
        src = gold[dup_t].repeat_interleave(group)
        lo, hi = np.log(float(a["dup_noise_min"])), np.log(
            float(a["dup_noise_max"]))
        r = torch.exp(lo + (hi - lo) * torch.rand(
            (n_dup_t, 1), generator=g, device=device))
        radius = (qs[dup_t] * r).repeat_interleave(group, dim=0)
        corpus[slots] = corpus[src] + radius * _t_noise(
            (len(slots), D), df, g, device)
    corpus.mul_(scales)
    queries.mul_(scales)
    fresh, fresh_queries = _fresh(cfg, seed, device, 0, fresh_rows, rows,
                                  scales)
    return Data(corpus, queries, gold.long(), fresh, fresh_queries)


def _fresh(cfg, seed, device, j, n, rows, scales):
    a = cfg["assumed"]["generator"]
    gf = _generator(seed, device, 1 + j)
    fresh = rows(n, gf)
    fresh_queries = fresh + _qscale(a, n, gf, device) * _t_noise(
        (n, fresh.shape[1]), int(a["df"]), gf, device)
    return fresh.mul_(scales), fresh_queries.mul_(scales)


def fresh_chunk(cfg: dict, seed: int, device, j: int, n: int,
                chunk: int = 1 << 17):
    """Chunk ``j`` of ``n`` window rows and their queries, from the seed:
    chunk 0 is ``make_data``'s ``fresh``, and a window that outruns the
    rows made in set-up draws chunks 1, 2, ... as it needs them, so no
    speed of the program exhausts them."""
    a = cfg["assumed"]["generator"]
    _, rows = _rows_fn(cfg, seed, device, chunk)
    scales = spectrum(int(cfg["dim"]), float(a["anisotropy"])).to(device)
    return _fresh(cfg, seed, device, j, n, rows, scales)


class Call(NamedTuple):
    """One step of a closed loop: a query call over ``pool`` rows of the
    corpus query pool and ``fresh`` rows of the fresh query pool, or an add
    of the next ``add`` fresh rows."""

    pool: np.ndarray     # indices into the corpus query pool
    fresh: np.ndarray    # indices into the fresh rows (gold = that row)
    add: int             # rows added by this step (0: a query call)


class Schedule:
    """A traffic mix's endless call sequence: query calls of ``batch``
    queries drawn in seeded order from the pool, and after every
    ``add_every``-th query call an add of ``add_rows`` fresh rows; once
    rows were added, ``fresh_share`` of each call's queries have their
    gold among them (drawn uniformly from the rows added so far)."""

    def __init__(self, mix: dict, n_pool: int, seed: int):
        self.batch = int(mix["batch"])
        self.add_every = int(mix.get("add_every", 0))
        self.add_rows = int(mix.get("add_rows", 0))
        self.fresh_share = float(mix.get("fresh_share", 0.0))
        self.n_pool = n_pool
        self.rng = np.random.default_rng(int(seed) & _SEED_MASK)
        self.order = self.rng.permutation(n_pool)
        self.pos = 0
        self.added = 0
        self.calls = 0

    def _pool_rows(self, n: int) -> np.ndarray:
        out = []
        while n:
            if self.pos == len(self.order):
                self.order = self.rng.permutation(self.n_pool)
                self.pos = 0
            m = min(n, len(self.order) - self.pos)
            out.append(self.order[self.pos:self.pos + m])
            self.pos += m
            n -= m
        return np.concatenate(out)

    def next(self) -> Call:
        if (self.add_every and self.calls and self.calls % self.add_every == 0
                and self._pending_add):
            self._pending_add = False
            self.added += self.add_rows
            return Call(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        self.add_rows)
        return self.next_query()

    def next_query(self) -> Call:
        """The next query call, whatever the cadence of the adds."""
        n_fresh = (int(round(self.fresh_share * self.batch))
                   if self.added else 0)
        fresh = (self.rng.integers(0, self.added, n_fresh)
                 if n_fresh else np.zeros(0, np.int64))
        self.calls += 1
        self._pending_add = True
        return Call(self._pool_rows(self.batch - n_fresh), fresh, 0)

    def add_now(self) -> Call:
        """An add of ``add_rows`` out of the cadence (the check's forced
        rebuild after the window)."""
        self.added += self.add_rows
        return Call(np.zeros(0, np.int64), np.zeros(0, np.int64),
                    self.add_rows)

    _pending_add = False
