"""What the readers of the program's own spans, counters and rare events
share.  The port keeps them in ``utils/profiling`` (``records()``,
``events()``, ``counters()``); a program without them gives None here,
and each reader then leaves its metric out.  Spans and events are
stamped on ``time.perf_counter_ns``, the clock of the calls' ``t`` and
``dt``, so a reader picks those of the window, or of the traced calls,
by time: an operator who leaves tracing on all the time gets the same
readings."""

from __future__ import annotations

from bisect import bisect_right

from perfbench import trace as trace_mod


def profiling():
    """The port's ``utils/profiling`` where it has spans, counters and the
    event log; else None."""
    try:
        from rag_cobweb_tpu_torch.utils import profiling as p
    except ImportError:
        return None
    if not all(hasattr(p, n) for n in ("records", "events", "counters")):
        return None
    return p


def window(res) -> tuple:
    """(start, end) of the window in seconds on ``time.perf_counter``: the
    first call's start and ``window_s`` after it."""
    calls = res["setup"].calls
    t0 = min(c["t"] for c in calls)
    return t0, t0 + res["window_s"]


def traced_span(res) -> tuple:
    """(start, end) on ``time.perf_counter`` of the traced calls, from the
    first one's start to the last one's end; (0, 0) without any."""
    traced = [c for c in res["setup"].calls if c["traced"]]
    if not traced:
        return 0.0, 0.0
    return (min(c["t"] for c in traced),
            max(c["t"] + c["dt"] for c in traced))


def by_call(records: list, calls: list) -> list:
    """For each call (each with ``t`` and ``dt``), the records that
    started inside it."""
    recs = sorted(records, key=lambda r: r["t0_ns"])
    starts = [r["t0_ns"] for r in recs]
    out = []
    for c in calls:
        lo = bisect_right(starts, int(c["t"] * 1e9) - 1)
        hi = bisect_right(starts, int((c["t"] + c["dt"]) * 1e9))
        out.append(recs[lo:hi])
    return out


def _union(spans) -> list:
    """Disjoint, sorted intervals covering ``spans`` ((start, end, ...))."""
    out = []
    for s, t, *_ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def idle_inside(stretch: trace_mod.Stretch, prefix: str) -> float:
    """Microseconds of the stretch in which the host is inside a range
    whose name starts with ``prefix`` and no device operation runs."""
    inside = _union((max(s, stretch.t0_us), min(t, stretch.t1_us))
                    for s, t, n in stretch.host if n.startswith(prefix)
                    and t > stretch.t0_us and s < stretch.t1_us)
    busy = _union(stretch.device)
    idle, j = 0.0, 0
    for s, t in inside:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < t:
            covered += min(t, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (t - s) - covered
    return idle


def has_ranges(stretch: trace_mod.Stretch, prefix: str) -> bool:
    return any(n.startswith(prefix) for _, _, n in stretch.host)
