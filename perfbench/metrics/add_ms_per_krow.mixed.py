"""Milliseconds of ``add_sentences`` per 1024 rows: the harness clock
around each add, ending in a synchronise, over every add of the window
outside the traced stretch."""

from perfbench import readers


def read(res):
    a = [c for c in readers.adds(res) if not c["traced"]]
    rows = sum(c["add"] for c in a)
    return 1e3 * 1024 * sum(c["dt"] for c in a) / rows if rows else None
