"""The readers of the program's own spans, counters and rare events
(``spans.py`` and the metrics that use it): on the tiny mixed cell run
traced on the CPU, on hand-made stretches and records, and against a
program that has no spans (each reader then leaves its metric out)."""

import collections
import sys
import types

import pytest

from perfbench import spans, trace
from perfbench.run import reader
from perfbench.tests import tiny

NEW = ("rebuild_share.mixed", "insert_syncs_per_krow.mixed",
       "idle_in_insert.mixed", "merge_ms.batch")


@pytest.fixture(scope="module")
def mixed():
    spans.profiling().clear()
    return tiny.run(tiny.mixed_cell, seconds=2.0, trace=True)


def test_host_readers_read_the_tiny_mixed_cell(mixed):
    s = mixed["setup"]
    share = reader("rebuild_share.mixed")(mixed)
    # the window crosses a rebuild (``test_cells``), so its share is real
    assert 0 < share < 100
    syncs = reader("insert_syncs_per_krow.mixed")(mixed)
    # the traced adds' spans, where the short stretch holds an add
    traced_adds = [c for c in s.calls if c["add"] and c["traced"]]
    assert (syncs is None) == (not traced_adds)
    if traced_adds:
        # at least a done check a descent step, a step a round, a round
        # for every lane's share of 1024 rows
        assert syncs >= 1024 / s.cfg["index"]["lanes"]


def test_insert_syncs_read_the_spans_of_real_traced_adds(monkeypatch):
    """The port's adds under a recording profiler, timed as the harness
    times its calls: the reader sums their ``serve.add`` spans."""
    import time

    import numpy as np
    import torch

    api = tiny.port()
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(600, 16)).astype(np.float32)
    db = api.CobwebIndex(config=api.TreeConfig(dim=16), capacity=4096,
                         n_subtrees=4, device="cpu")
    db.add_sentences([None] * 200, rows[:200])
    p = spans.profiling()
    # a buffer of the test's own: the tiny cell's records stay as they are
    monkeypatch.setattr(p, "_records", collections.deque())
    calls = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for lo in (200, 328):
            t0 = time.perf_counter()
            db.add_sentences([None] * 128, rows[lo:lo + 128])
            calls.append({"add": 128, "t": t0,
                          "dt": time.perf_counter() - t0, "traced": True})
    adds = [r for r in p.records() if r["name"] == "serve.add"]
    assert len(adds) == 2
    n = sum(r["attrs"]["counters"]["insert.syncs"] for r in adds)
    assert n > 0
    got = reader("insert_syncs_per_krow.mixed")
    monkeypatch.setattr(spans, "profiling",
                        lambda: _fake_profiling(records=adds))
    assert got({"setup": _Setup(calls)}) == pytest.approx(1024 * n / 256)
    # an untraced add is left out
    calls[1]["traced"] = False
    assert got({"setup": _Setup(calls)}) == pytest.approx(
        1024 * adds[0]["attrs"]["counters"]["insert.syncs"] / 128)


def test_device_readers_read_nothing_on_the_cpu(mixed):
    assert mixed["stretch"] is not None and not mixed["stretch"].device
    assert reader("idle_in_insert.mixed")(mixed) is None
    assert reader("merge_ms.batch")(mixed) is None


def test_the_program_spans_are_ranges_of_the_stretch(mixed):
    """The spans of the stretch's calls are its host ranges, and none
    takes a name of the harness's own ranges, which set its edges."""
    st = mixed["stretch"]
    names = {n for _, _, n in st.host}
    prog = {r["name"] for r in spans.profiling().records()}
    assert "serve.query" in prog and prog <= names
    assert spans.has_ranges(st, "insert.") == ("serve.add" in prog)
    assert not prog & set(trace.HARNESS_RANGES)


def test_idle_inside_counts_idle_time_under_the_ranges():
    dev = [(0, 10, "k"), (5, 20, "k"), (30, 40, "k")]
    host = [(0, 100, "add"), (2, 25, "insert.rounds"),
            (22, 35, "insert.apply"), (50, 60, "insert.route"),
            (70, 80, "serve.query")]
    st = trace.Stretch(dev, host, 0.0, 100.0)
    # under insert.*: [2, 35] and [50, 60]; busy in [2, 35]: [2, 20] and
    # [30, 35] -> idle 10 + 10
    assert spans.idle_inside(st, "insert.") == pytest.approx(20.0)
    assert reader("idle_in_insert.mixed")({"stretch": st}) == \
        pytest.approx(100 * 20e-6 / st.window_s)


def test_by_call_takes_the_records_that_start_inside_each_call():
    calls = [{"t": 1.0, "dt": 0.5}, {"t": 2.0, "dt": 0.25}]
    recs = [{"t0_ns": int(t * 1e9)} for t in (0.9, 1.0, 1.2, 1.6, 2.1,
                                               2.3)]
    got = spans.by_call(recs, calls)
    assert [[r["t0_ns"] for r in g] for g in got] == [
        [1_000_000_000, 1_200_000_000], [2_100_000_000]]


def _fake_profiling(records=(), events=()):
    m = types.ModuleType("rag_cobweb_tpu_torch.utils.profiling")
    m.records = lambda: list(records)
    m.events = lambda: list(events)
    m.counters = dict
    return m


class _Setup:
    def __init__(self, calls):
        self.calls = calls


def test_merge_ms_is_the_mean_of_each_traced_call_sum(monkeypatch):
    calls = [{"add": 0, "t": 1.0, "dt": 0.1, "traced": True},
             {"add": 0, "t": 2.0, "dt": 0.1, "traced": True},
             {"add": 0, "t": 3.0, "dt": 0.1, "traced": False}]
    recs = [{"name": "engine.merge", "t0_ns": int(t * 1e9), "device_ms": ms}
            for t, ms in ((1.01, 2.0), (1.05, 1.0), (2.02, 5.0),
                          (3.01, 100.0))]
    recs.append({"name": "engine.sweep", "t0_ns": int(1.02e9),
                 "device_ms": 50.0})
    monkeypatch.setattr(spans, "profiling",
                        lambda: _fake_profiling(records=recs))
    assert reader("merge_ms.batch")({"setup": _Setup(calls)}) == \
        pytest.approx(4.0)


def test_insert_syncs_read_the_traced_adds(monkeypatch):
    calls = [{"add": 1024, "t": 10.0, "dt": 0.5, "traced": False},
             {"add": 1024, "t": 11.0, "dt": 0.5, "traced": True},
             {"add": 0, "t": 12.0, "dt": 0.5, "traced": True},
             {"add": 512, "t": 15.0, "dt": 0.5, "traced": True}]
    recs = [{"name": name, "parent": parent, "t0_ns": int(t * 1e9),
             "attrs": {"rows": rows, "counters": {"insert.syncs": n}}}
            for name, parent, t, rows, n in (
                ("serve.add", None, 10.1, 1024, 1),
                ("serve.add", None, 11.1, 1024, 300),
                ("serve.add", 7, 11.2, 64, 50),      # nested: not a call
                ("insert.rounds", 7, 11.3, 1024, 50),
                ("serve.add", None, 15.1, 512, 100))]
    monkeypatch.setattr(spans, "profiling",
                        lambda: _fake_profiling(records=recs))
    res = {"setup": _Setup(calls), "window_s": 10.0}
    assert reader("insert_syncs_per_krow.mixed")(res) == \
        pytest.approx(1024 * 400 / 1536)


def test_rebuild_share_reads_the_rebuilds_inside_the_window(monkeypatch):
    calls = [{"add": 0, "t": 10.0, "dt": 0.1, "traced": False}]
    ev = [{"name": "index.rebuild", "t0_ns": int(t * 1e9), "s": s}
          for t, s in ((9.0, 1.0), (12.0, 0.5), (13.0, 0.25),
                       (25.0, 3.0))]
    ev.append({"name": "insert.grow", "t0_ns": int(14e9), "s": 1.0})
    monkeypatch.setattr(spans, "profiling",
                        lambda: _fake_profiling(events=ev))
    res = {"setup": _Setup(calls), "window_s": 10.0}
    assert reader("rebuild_share.mixed")(res) == pytest.approx(7.5)


def test_rebuild_share_leaves_out_the_traced_stretch(monkeypatch):
    """A rebuild that starts inside the traced calls is left out, and so
    are the stretch's seconds: the profiler slows a rebuild's host part."""
    calls = [{"add": 0, "t": 10.0, "dt": 0.1, "traced": False},
             {"add": 0, "t": 14.0, "dt": 0.5, "traced": True},
             {"add": 0, "t": 14.5, "dt": 1.5, "traced": True},
             {"add": 0, "t": 16.0, "dt": 0.1, "traced": False}]
    ev = [{"name": "index.rebuild", "t0_ns": int(t * 1e9), "s": s}
          for t, s in ((12.0, 0.5), (14.6, 1.4), (17.0, 0.25))]
    monkeypatch.setattr(spans, "profiling",
                        lambda: _fake_profiling(events=ev))
    res = {"setup": _Setup(calls), "window_s": 10.0}
    # stretch [14.0, 16.0): 8 s left, 0.75 s of rebuilds in them
    assert reader("rebuild_share.mixed")(res) == pytest.approx(
        100 * 0.75 / 8.0)


def test_a_program_without_spans_leaves_the_metrics_out(monkeypatch,
                                                         mixed):
    """A profiling module without ``records``/``events`` (the program
    before its spans) and a stretch without ``insert.*`` ranges: every
    new reader gives None and raises nothing."""
    old = types.ModuleType("rag_cobweb_tpu_torch.utils.profiling")
    old.trace = lambda *a, **k: None
    monkeypatch.setitem(sys.modules, old.__name__, old)
    import rag_cobweb_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", old, raising=False)
    assert spans.profiling() is None
    st = mixed["stretch"]
    bare = st._replace(host=[h for h in st.host
                             if not h[2].startswith("insert.")],
                       device=[(st.t0_us, st.t0_us + 1.0, "k")])
    res = dict(mixed, stretch=bare)
    for name in NEW:
        assert reader(name)(res) is None, name
