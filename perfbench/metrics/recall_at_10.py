"""Share of the window's queries whose gold row is among the ten ids
returned."""

from perfbench import readers


def read(res):
    hit = n = 0
    for c in readers.queries(res):
        ids = c["ids"].numpy()[:, :10]
        hit += int((ids == c["gold"][:, None]).any(1).sum())
        n += len(ids)
    return hit / n if n else None
