"""Percent of the window spent rebuilding the serving index: the
rebuilds that the program's event log holds with a start inside the
window, their summed durations (CUDA events at each rebuild's edges on
the card, so its device tail counts) over the window's seconds.  The
traced stretch is left out of both, since the profiler slows the host's
part of a rebuild."""

from perfbench import spans


def read(res):
    p = spans.profiling()
    if p is None:
        return None
    lo, hi = spans.window(res)
    t0, t1 = spans.traced_span(res)
    s = sum(e["s"] for e in p.events() if e["name"] == "index.rebuild"
            and lo <= 1e-9 * e["t0_ns"] < hi
            and not t0 <= 1e-9 * e["t0_ns"] < t1)
    return 100.0 * s / (res["window_s"] - (t1 - t0))
