"""What the metric readers of ``metrics/`` share: the window's calls and
the work that the traced calls asked of each kernel."""

from __future__ import annotations

from perfbench import roofline, stats
from perfbench import trace as trace_mod


def queries(res) -> list:
    return [c for c in res["setup"].calls if not c["add"]]


def adds(res) -> list:
    return [c for c in res["setup"].calls if c["add"]]


def untraced_queries(res) -> list:
    """The query calls the profiler did not slow."""
    return [c for c in queries(res) if not c["traced"]]


def traced_queries(res) -> list:
    return [c for c in queries(res) if c["traced"]]


def kernel1_work(res) -> roofline.Work:
    """Kernel 1's work in the traced calls: the sweep over the (2 Dw, S)
    fused index and, where the backstop serves, the sweep over the (Dw, S)
    whitened store; S the rows the serving index covers."""
    s = res["setup"]
    dw = s.whitener.dim_out
    work = roofline.NONE
    for c in traced_queries(res):
        work = work + roofline.kernel1(c["B"], 2 * dw, c["n_indexed"],
                                       s.pool)
        bs = s.backstop_size(c["n_total"])
        if bs:
            work = work + roofline.kernel1(c["B"], dw, c["n_indexed"], bs)
    return work


def device_share(res, work, match):
    """Percent of ``work``'s least time over the device time of the
    operations ``match`` accepts; None without a trace or that time."""
    st = res["stretch"]
    if st is None or work.flops <= 0:
        return None
    return roofline.share(work, trace_mod.device_s_by(st, match))


def kernel1_roofline(res):
    return device_share(res, kernel1_work(res),
                        lambda n: "slab_topk" in n)


def device_idle(res):
    st = res["stretch"]
    if st is None or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace_mod.busy_s(st) / st.window_s)


def median_ms(values):
    return 1e3 * stats.percentile(values, 50) if values else None
