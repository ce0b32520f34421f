"""95th percentile over every query call of the window, each timed from
the call until its ids are on the host."""

from perfbench import readers, stats


def read(res):
    dt = [c["dt"] for c in readers.queries(res)]
    return 1e3 * stats.percentile(dt, 95) if dt else None
