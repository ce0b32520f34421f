"""The generator is deterministic from the seed, and the seed changes the
rows and the order, never the sizes."""

import numpy as np
import torch

from perfbench import gen
from perfbench.tests import tiny

BIG = 2**31 + 12345


def _cfg():
    cfg, _ = tiny.batch_cell()
    cfg.update(rows=3000, queries=200)
    return cfg


def test_same_seed_same_rows():
    a = gen.make_data(_cfg(), BIG, torch.device("cpu"), fresh_rows=64)
    b = gen.make_data(_cfg(), BIG, torch.device("cpu"), fresh_rows=64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_other_seed_other_rows_same_sizes():
    a = gen.make_data(_cfg(), BIG, torch.device("cpu"), fresh_rows=64)
    b = gen.make_data(_cfg(), BIG + 1, torch.device("cpu"), fresh_rows=64)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert not torch.equal(x, y)


def test_golds_are_distinct_rows_near_their_queries():
    d = gen.make_data(_cfg(), BIG, torch.device("cpu"))
    assert len(torch.unique(d.gold)) == len(d.gold)
    near = torch.cdist(d.queries, d.corpus).argmin(1)
    assert (near == d.gold).float().mean() > 0.5
    assert d.fresh.shape[0] == 0


def test_schedule_is_deterministic_and_mixes_fresh_golds():
    mix = {"batch": 32, "add_every": 8, "add_rows": 1024,
           "fresh_share": 0.25}
    a = gen.Schedule(mix, 10000, BIG)
    b = gen.Schedule(mix, 10000, BIG)
    steps = [(a.next(), b.next()) for _ in range(90)]
    for x, y in steps:
        assert x.add == y.add
        assert np.array_equal(x.pool, y.pool)
        assert np.array_equal(x.fresh, y.fresh)
    kinds = [x.add for x, _ in steps]
    assert kinds[:9] == [0] * 8 + [1024]
    assert kinds.count(1024) == 10
    first_q = [x for x, _ in steps[:8]]
    assert all(len(x.fresh) == 0 for x in first_q)
    later = [x for x, _ in steps[9:] if not x.add]
    assert all(len(x.fresh) == 8 and len(x.pool) == 24 for x in later)
    assert all(int(x.fresh.max()) < 1024 * 10 for x in later)


def test_fresh_rows_come_in_chunks_from_the_seed():
    cfg = _cfg()
    d = gen.make_data(cfg, BIG, torch.device("cpu"), fresh_rows=64)
    f0, q0 = gen.fresh_chunk(cfg, BIG, torch.device("cpu"), 0, 64)
    assert torch.equal(f0, d.fresh) and torch.equal(q0, d.fresh_queries)
    f1, _ = gen.fresh_chunk(cfg, BIG, torch.device("cpu"), 1, 64)
    g1, _ = gen.fresh_chunk(cfg, BIG, torch.device("cpu"), 1, 64)
    assert torch.equal(f1, g1) and not torch.equal(f1, f0)


def test_schedule_never_runs_out_of_fresh_rows():
    mix = {"batch": 32, "add_every": 1, "add_rows": 1024,
           "fresh_share": 0.25}
    sch = gen.Schedule(mix, 100, BIG)
    for _ in range(4000):
        sch.next()
    assert sch.added == 2000 * 1024
