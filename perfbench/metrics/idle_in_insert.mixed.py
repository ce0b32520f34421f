"""Percent of the traced stretch in which no device operation runs
while the host is inside one of the program's ``insert.*`` spans (its
ranges in the profiler's host list, on the device's clock)."""

from perfbench import spans


def read(res):
    st = res["stretch"]
    if (st is None or not st.device or st.window_s <= 0
            or not spans.has_ranges(st, "insert.")):
        return None
    return 1e-4 * spans.idle_inside(st, "insert.") / st.window_s
