"""The window's arithmetic: rates over the whole window, the tail over
every call, and a stall anywhere in the window moves them."""

import numpy as np
import pytest
import torch

from perfbench import stats
from perfbench.run import reader


class _Setup:
    def __init__(self, calls):
        self.calls = calls


def _res(dts, adds=(), window_s=None):
    calls = [{"add": 0, "dt": dt, "B": 1024, "traced": False,
              "ids": torch.zeros((1024, 10), dtype=torch.long),
              "gold": np.zeros(1024, np.int64)} for dt in dts]
    calls += [{"add": m, "dt": dt, "traced": False} for m, dt in adds]
    w = window_s if window_s is not None else sum(c["dt"] for c in calls)
    return {"setup": _Setup(calls), "window_s": w, "setup_s": 1.0,
            "stretch": None, "verdict": {}}


def test_rate_is_over_the_whole_window():
    res = _res([0.05] * 200)
    assert reader("qps")(res) == pytest.approx(1024 * 200 / 10.0)


def test_a_stall_moves_qps_and_inserts():
    calm = _res([0.05] * 200, adds=[(1024, 0.2)] * 10)
    stalled = _res([0.05] * 199 + [2.0], adds=[(1024, 0.2)] * 10)
    assert reader("qps")(stalled) < 0.9 * reader("qps")(calm)
    assert reader("inserts_per_s")(stalled) < \
        0.9 * reader("inserts_per_s")(calm)


def test_p95_is_over_every_call():
    dts = [0.001] * 94 + [0.1] * 6
    assert reader("p95_ms")(_res(dts)) > 50
    # a stall on fewer than 5% of the calls leaves the p95 alone
    assert reader("p95_ms")(_res([0.001] * 96 + [0.1] * 4)) < 10


def test_recall_counts_golds_in_the_top_ten():
    res = _res([0.05] * 2)
    res["setup"].calls[0]["ids"][:512, 3] = 7
    res["setup"].calls[0]["gold"][:] = 7
    assert reader("recall_at_10")(res) == pytest.approx(
        (512 + 1024) / 2048)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)
