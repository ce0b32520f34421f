"""The traced stretch's readings: busy time, idle gaps named by the host's
range, device time by kernel name."""

import pytest

from perfbench import trace


def _stretch():
    dev = [(0, 10, "slab_topk_wgmma"), (5, 20, "slab_topk_wgmma"),
           (30, 40, "rerank_l2_kernel"), (90, 100, "copy")]
    host = [(0, 45, "query"), (2, 8, "aten::to"), (50, 100, "add"),
            (55, 80, "aten::nonzero")]
    return trace.Stretch(dev, host, 0.0, 100.0)


def test_busy_is_the_union_of_device_intervals():
    st = _stretch()
    assert trace.busy_s(st) == pytest.approx(40e-6)
    assert trace.device_s_by(st, lambda n: "slab_topk" in n) == \
        pytest.approx(25e-6)


def test_gaps_are_named_by_the_host_range():
    b = trace.breakdown(_stretch())
    assert b["idle_gaps"][0] == ["add:aten::nonzero", pytest.approx(50e-6)]
    assert b["idle_gaps"][1][0] == "query"
    assert b["device_ops"][0] == ["slab_topk_wgmma", pytest.approx(25e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
