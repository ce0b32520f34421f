"""Rows that ``add_sentences`` acknowledged over the whole window, per
second."""

from perfbench import readers, stats


def read(res):
    n = sum(c["add"] for c in readers.adds(res))
    return stats.rate(n, res["window_s"]) if n else None
