"""Stream milliseconds a call of the pools' merges: the program's
``engine.merge`` spans (the sweep pool's and the backstop's), timed by
their CUDA events, summed over each traced call, the mean over the
traced calls."""

from perfbench import readers, spans


def read(res):
    p = spans.profiling()
    if p is None:
        return None
    recs = [r for r in p.records() if r["name"] == "engine.merge"
            and r["device_ms"] is not None]
    per = [sum(r["device_ms"] for r in got) for got in
           spans.by_call(recs, readers.traced_queries(res)) if got]
    return sum(per) / len(per) if per else None
