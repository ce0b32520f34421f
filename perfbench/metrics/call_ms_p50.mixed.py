"""Median of the window's query calls (those outside the traced
stretch), on the harness clock."""

from perfbench import readers


def read(res):
    return readers.median_ms([c["dt"] for c in
                              readers.untraced_queries(res)])
