"""Points where an add waited on the device, per 1024 rows: the
``insert.syncs`` deltas that the program's ``serve.add`` spans carry, over
the traced adds, per 1024 rows those adds added."""

from perfbench import readers, spans


def read(res):
    p = spans.profiling()
    if p is None:
        return None
    recs = [r for r in p.records() if r["name"] == "serve.add"
            and r["parent"] is None]
    syncs = rows = 0
    for got in spans.by_call(recs, [c for c in readers.adds(res)
                                    if c["traced"]]):
        for r in got:
            syncs += r["attrs"]["counters"]["insert.syncs"]
            rows += r["attrs"]["rows"]
    return 1024.0 * syncs / rows if rows else None
