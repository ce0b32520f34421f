"""The port's spans, counters and event log (``utils/profiling``): a
small whitened forest's adds and queries traced by the operator switch
and under ``torch.profiler``, tracing off, the rebuilds' events, the
launch counters' views (``bench/probes``) and the stage split read from a
real call's spans, on the host; on the card, each add's ``insert.syncs``
against the synchronising operations PyTorch reports.  Nothing here
imports JAX."""

import collections
import warnings

import numpy as np
import pytest
import torch

from rag_cobweb_tpu_torch.bench import probes
from rag_cobweb_tpu_torch.core.config import TreeConfig
from rag_cobweb_tpu_torch.core.wrapper import CobwebIndex
from rag_cobweb_tpu_torch.utils import profiling
from rag_cobweb_tpu_torch.whitening import PCAICAWhiteningModel

# tiny tensors: one thread each keeps parallel test workers off each
# other's cores
torch.set_num_threads(1)

K = 4


def _rows(n, d=24, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(6, d))
    return (centers[rng.integers(0, 6, n)]
            + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def rows():
    return _rows(1400)


@pytest.fixture(scope="module")
def whitener(rows):
    return PCAICAWhiteningModel.fit(rows[:800], pca_dim=12, ica_max_iter=50,
                                    seed=0)


def _db(rows, whitener, n=800):
    """A whitened 4-lane forest on the fused engine with the backstop on,
    the tiers' limits cut to the test's size."""
    db = CobwebIndex(config=TreeConfig(dim=whitener.dim_out),
                     capacity=K * 1024, n_subtrees=K, whitener=whitener,
                     device="cpu")
    db.blocked_threshold = 64
    db.backstop_threshold = 64
    db.stale_pending_limit = 32
    db.delta_rebuild_min = 128
    db.delta_rebuild_frac = 0.02
    db.add_sentences([None] * n, rows[:n])
    return db


@pytest.fixture
def traced():
    profiling.clear()
    was = profiling.tracing(True)
    yield
    profiling.tracing(was)
    profiling.clear()


def _by_request(recs):
    out = {}
    for r in recs:
        out.setdefault(r["request"], []).append(r)
    return out


def _root(group):
    roots = [r for r in group if r["parent"] is None]
    assert len(roots) == 1, [r["name"] for r in roots]
    return roots[0]


def test_a_call_is_one_request_of_nested_spans(rows, whitener, traced):
    db = _db(rows, whitener)
    db.query_ids(rows[:8], 5, rerank=32)     # builds the serving index
    profiling.clear()
    db.add_sentences([None] * 40, rows[800:840])        # into the tiers
    db.query_ids(rows[:8], 5, rerank=32)
    groups = list(_by_request(profiling.records()).values())
    assert [_root(g)["name"] for g in groups] == ["serve.add", "serve.query"]
    add, query = groups
    ids = {r["id"]: r for r in profiling.records()}
    for g in groups:
        root = _root(g)
        for r in g:
            # each span lies inside its parent, on the same request
            if r["parent"] is not None:
                p = ids[r["parent"]]
                assert p["request"] == r["request"]
                assert p["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= p["t1_ns"]
            assert r["t1_ns"] <= root["t1_ns"]
    names = {r["name"] for r in add}
    assert {"serve.upload", "serve.whiten", "insert.route", "insert.rounds",
            "insert.apply"} <= names, names
    root = _root(add)
    assert root["attrs"]["rows"] == 40
    c = root["attrs"]["counters"]
    rounds = [r for r in add if r["name"] == "insert.rounds"]
    assert c["insert.rounds"] == sum(r["attrs"]["rounds"] for r in rounds)
    # every descent step waits on its done check, and every round on its
    # leaves: at least a sync a step
    assert c["insert.syncs"] > c["insert.steps"] >= c["insert.rounds"] > 0
    names = {r["name"] for r in query}
    assert {"serve.upload", "serve.whiten", "engine.sweep", "engine.merge",
            "engine.backstop", "engine.union", "engine.rerank",
            "engine.topk", "tiers.merge"} <= names, names
    merges = sorted(r["attrs"]["pool"] for r in query
                    if r["name"] == "engine.merge")
    assert merges == ["backstop", "sweep"]
    q = _root(query)["attrs"]
    assert (q["B"], q["k"], q["rerank"]) == (8, 5, 32)
    tiers = next(r for r in query if r["name"] == "tiers.merge")
    assert tiers["attrs"] == {"pending": 0, "delta": 40}
    assert all(r["device_ms"] is None for r in query)   # no card here


def test_rebuild_past_the_rebuild_point_is_a_span_and_an_event(
        rows, whitener, traced):
    db = _db(rows, whitener)
    db.query_ids(rows[:8], 5, rerank=32)
    db.add_sentences([None] * 200, rows[800:1000])   # past the rebuild point
    profiling.clear()
    db.query_ids(rows[:8], 5, rerank=32)
    db.query_ids(rows[:8], 5, rerank=32)         # served from the new index
    first, second = _by_request(profiling.records()).values()
    rb = [r for r in first if r["name"] == "index.rebuild"]
    assert len(rb) == 1 and rb[0]["attrs"] == {"engine": "fused",
                                               "rows": 1000}
    assert rb[0]["parent"] == _root(first)["id"]
    assert not any(r["name"] == "index.rebuild" for r in second)
    ev = profiling.events()
    assert [e["name"] for e in ev] == ["index.rebuild"]
    assert ev[0]["attrs"] == {"engine": "fused", "rows": 1000}
    assert 0 <= rb[0]["t0_ns"] - ev[0]["t0_ns"] <= 1e9 * ev[0]["s"]
    assert 0 < ev[0]["s"] == ev[0]["host_s"]


def test_an_add_past_its_step_budgets_counts_its_retries_and_exact_rows(
        rows, whitener, traced, monkeypatch):
    """The ``serve.add`` span's counter deltas say why an add was slow: a
    primary budget and a retry budget of one step cut the descents, so
    the add shows retry waves and rows inserted alone on the exact path,
    each under its span, and every row still gets a leaf."""
    from rag_cobweb_tpu_torch.parallel import vforest
    db = _db(rows, whitener)
    monkeypatch.setattr(vforest, "_DEEP_STEPS", 1)
    db.forest._budget = 1
    profiling.clear()
    db.add_sentences([None] * 40, rows[800:840])
    add = _by_request(profiling.records())
    (group,) = add.values()
    root = _root(group)
    c = root["attrs"]["counters"]
    assert c["insert.retry_waves"] > 0 and c["insert.exact"] > 0
    names = [r["name"] for r in group]
    assert names.count("insert.retry") == 1
    assert names.count("insert.exact") == 1
    # a wave and the exact rows are lockstep rounds of their own
    assert c["insert.rounds"] > (40 + K - 1) // K
    assert min(db.forest._leaf_of_local[s][-1] for s in range(K)) >= 0


def test_tracing_off_records_nothing_and_serves_the_same_ids(rows,
                                                             whitener):
    profiling.clear()
    assert not profiling.enabled()
    db = _db(rows, whitener)
    q = rows[::37]
    off = [db.query_ids(q, 5, rerank=32)]
    db.add_sentences([None] * 40, rows[800:840])
    off.append(db.query_ids(q, 5, rerank=32))
    assert profiling.records() == []
    # the rebuilds are logged whatever the switch
    ev = profiling.events()
    assert [e["name"] for e in ev] == ["index.rebuild"]
    assert ev[0]["attrs"] == {"engine": "fused", "rows": 800}
    was = profiling.tracing(True)
    try:
        db2 = _db(rows, whitener)
        on = [db2.query_ids(q, 5, rerank=32)]
        db2.add_sentences([None] * 40, rows[800:840])
        on.append(db2.query_ids(q, 5, rerank=32))
    finally:
        profiling.tracing(was)
        profiling.clear()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_off_a_span_site_is_the_shared_no_op():
    assert not profiling.enabled()
    a = profiling.span("engine.sweep", device=True, B=3)
    b = profiling.span("serve.add", counters=profiling.INSERT_COUNTERS)
    assert a is b
    with a as sp:
        sp.set(rows=1)
    assert sp.request is None and profiling.records() == []


def test_a_logged_span_enters_the_event_log_alone_when_off():
    """Off, a span made with ``log`` is timed into ``events()`` with its
    counters' deltas, and leaves no record; on, it is both."""
    profiling.clear()
    assert not profiling.enabled()
    try:
        with profiling.span("index.rebuild", log=True,
                            counters=("insert.syncs",), rows=7) as sp:
            profiling.count("insert.syncs", 3)
        assert sp.request is None and profiling.records() == []
        (ev,) = profiling.events()
        assert ev["name"] == "index.rebuild"
        assert ev["attrs"] == {"rows": 7, "counters": {"insert.syncs": 3}}
        assert 0 <= ev["s"] == ev["host_s"] < 1
        was = profiling.tracing(True)
        try:
            with profiling.span("serve.query"):
                with profiling.span("index.rebuild", log=True, rows=8):
                    pass
        finally:
            profiling.tracing(was)
        recs = {r["name"]: r for r in profiling.records()}
        assert recs["index.rebuild"]["parent"] == recs["serve.query"]["id"]
        assert [e["attrs"]["rows"] for e in profiling.events()] == [7, 8]
    finally:
        profiling.clear()


def test_a_build_over_a_built_input_logs_each_build_alone(rows):
    """A single tree's fused engine builds its prediction index, then the
    fused one over it: two events, one after the other, so that their
    durations add up without counting a build twice."""
    profiling.clear()
    db = CobwebIndex([None] * 200, rows[:200], device="cpu")
    db.blocked_threshold = 64
    db.query_ids(rows[:8], 5, rerank=32)
    ev = profiling.events()
    profiling.clear()
    assert [e["attrs"]["engine"] for e in ev] == ["prediction", "fused"]
    assert ev[0]["t0_ns"] + 1e9 * ev[0]["host_s"] <= ev[1]["t0_ns"]


def test_spans_are_ranges_of_a_recording_profiler(rows, whitener):
    """With the switch off, a recording profiler turns the spans on: each
    is one of its ranges, and no span takes the names a benchmark gives
    its own ranges."""
    db = _db(rows, whitener)
    db.query_ids(rows[:8], 5, rerank=32)
    profiling.clear()
    acts = [torch.profiler.ProfilerActivity.CPU]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            db.add_sentences([None] * 8, rows[800:808])
            db.query_ids(rows[:8], 5, rerank=32)
        recs = profiling.records()
    finally:
        profiling.clear()
    ranges = {e.name for e in prof.events()}
    spans = {r["name"] for r in recs}
    assert {"serve.add", "serve.query", "insert.rounds",
            "engine.sweep"} <= spans
    assert spans <= ranges
    assert not spans & {"query", "add"}
    assert all("." in n for n in spans)
    assert profiling.records() == []


def test_probe_counters_are_views_of_the_registry():
    probes.zero_counters()
    assert not any(probes.read_counters().values())
    profiling.count("launch.slab_topk", 3)
    profiling.count("launch.slab_topk_f32")
    profiling.count("launch.rerank_lp", 2)
    profiling.count("launch.rerank_lp_bf16")
    profiling.count("launch.backstop", 2)
    got = probes.read_counters()
    assert (got["fused_topk"], got["fused_topk_f32"]) == (2, 1)
    assert (got["rerank_l2"], got["rerank_l2_bf16"]) == (1, 1)
    assert (got["backstop"], got["pending"]) == (2, 0)
    assert set(got) == {"fused_topk", "fused_topk_f32", "fused_group_topk",
                        "fused_group_topk_f32", "blocked_topk",
                        "blocked_topk_f32", "rerank_l2", "rerank_l2_bf16",
                        "backstop", "pending"}
    probes.zero_counters()
    assert not any(probes.read_counters().values())


def test_the_plain_kernels_launch_nothing(rows, whitener):
    """On the host every kernel runs its plain version: served calls over
    the pending and the delta tier and the adds between count no
    launch."""
    db = _db(rows, whitener)
    db.query_ids(rows[:8], 5, rerank=32)
    probes.zero_counters()
    db.add_sentences([None] * 20, rows[800:820])
    db.query_ids(rows[:8], 5, rerank=32)
    db.add_sentences([None] * 20, rows[820:840])     # past the pending limit
    db.query_ids(rows[:8], 5, rerank=32)
    assert (len(db._pending_sids), db._delta_n) == (0, 40)
    assert not any(probes.read_counters().values())


def test_stage_split_reads_one_real_call(rows, whitener):
    db = _db(rows, whitener)
    db.query_ids(rows[:8], 5, rerank=32)
    db.add_sentences([None] * 20, rows[800:820])        # rows pending
    was = profiling.enabled()
    split = probes.stage_split(db, rows[:8], 5, 32)
    assert profiling.enabled() == was
    assert [k for k in split if k not in ("sum", "wall", "B")] == [
        "upload", "whitening", "kernel 1", "pool merge", "backstop pool",
        "union", "kernel 5", "final top-k", "tiers", "to host"]
    assert split["B"] == 8
    assert split["sum"] == pytest.approx(sum(
        v for k, v in split.items() if k not in ("sum", "wall", "B")))
    assert 0 < split["sum"] <= split["wall"]


def test_small_forest_split_reads_one_real_call(rows):
    db = CobwebIndex([None] * 300, rows[:300], n_subtrees=K, device="cpu")
    split = probes.small_forest_split(db, rows[:8], 5, 32)
    assert [k for k in split if k not in ("sum", "wall", "B")] == [
        "upload", "per-lane scoring", "per-lane and merge top-k",
        "kernel 5", "final top-k", "to host"]
    assert 0 < split["sum"] <= split["wall"]


def test_the_records_buffer_is_bounded(traced, monkeypatch):
    from collections import deque
    monkeypatch.setattr(profiling, "_records", deque(maxlen=5))
    for i in range(8):
        with profiling.span("bench.step", i=i):
            pass
    assert [r["attrs"]["i"] for r in profiling.records()] == [3, 4, 5, 6, 7]
    assert len({r["request"] for r in profiling.records()}) == 5


def _sync_waits(db, rows):
    """``add_sentences(rows)`` under PyTorch's sync debug mode -> (the
    synchronising operations it reported, the ``insert.syncs`` the add
    counted)."""
    c0 = profiling.counter("insert.syncs")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            db.add_sentences([None] * len(rows), rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    waits = [f"{w.filename}:{w.lineno}" for w in got
             if "synchroniz" in str(w.message)]
    return waits, profiling.counter("insert.syncs") - c0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,routing", [(4, "round_robin"),
                                           (4, "content"), (1, None)])
def test_insert_syncs_count_every_wait_of_an_add_on_the_card(
        whitener, lanes, routing):
    """On the card each add counts on ``insert.syncs`` exactly the
    synchronising CUDA operations that PyTorch's sync debug mode reports
    inside it: from the first add (step graph captured), through adds into
    the pending tier, ones that consolidate it, and ones that grow the
    state and capture the step graph again.  The whitener's first
    transform on a device, which uploads its matrices once, is made
    first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the count is held against the "
                    "card's own synchronisations")
    dev = torch.device("cuda")
    whitener.transform_torch(torch.zeros((1, whitener.mean.shape[0]),
                                         device=dev))
    n, step = (4800, 400) if lanes > 1 else (1200, 100)
    data = _rows(n, seed=1)
    kw = {"routing": routing} if routing else {}
    db = CobwebIndex(config=TreeConfig(dim=whitener.dim_out),
                     capacity=lanes * 1024, n_subtrees=lanes,
                     whitener=whitener, device=dev, **kw)
    db.blocked_threshold = 64
    db.backstop_threshold = 64
    db.stale_pending_limit = step // 2
    db.delta_rebuild_min = 4 * step
    db.delta_rebuild_frac = 0.02
    grows = profiling.counter("insert.grows")
    captures = profiling.counter("insert.graph_captures")
    consolidated = 0
    for s in range(0, n, step // 2):
        delta = db._delta_n
        waits, counted = _sync_waits(db, data[s:s + step // 2])
        assert counted == len(waits), (s, collections.Counter(waits))
        consolidated += db._delta_n > delta
        db.query_ids(data[:8], 5, rerank=32)    # a serving index again
    assert consolidated
    assert profiling.counter("insert.grows") > grows
    assert profiling.counter("insert.graph_captures") > captures + 1
