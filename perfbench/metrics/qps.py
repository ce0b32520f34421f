"""Queries answered over the whole window, per second."""

from perfbench import readers, stats


def read(res):
    n = sum(c["B"] for c in readers.queries(res))
    return stats.rate(n, res["window_s"]) if n else None
