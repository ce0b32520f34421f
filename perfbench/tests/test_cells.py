"""Both cells end to end at a tiny size on the CPU: set-up, window, the
result's metrics, and the comparison with the reference, which the port
passes and the control (the reference one precision below, in the port's
place) fails."""

import pytest

from perfbench import cell as cell_mod
from perfbench.run import load_bench, reader
from perfbench.tests import tiny

CELLS = {"msmarco_dpr_1m.batch": tiny.batch_cell,
         "quora_roberta_523k.mixed": tiny.mixed_cell}


def _cell(name):
    return next(w for w in load_bench()["workloads"] if w["name"] == name)


@pytest.fixture(scope="module")
def runs():
    return {name: tiny.run(make, seconds=2.0, trace=True, control=True)
            for name, make in CELLS.items()}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_port_is_correct_against_the_reference(runs, name):
    v = runs[name]["verdict"]
    assert v["correct"], v
    assert v["numbers"]["rank_gap"] <= v["limits"]["rank_gap"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_a_number(runs, name):
    v = runs[name]["verdict"]
    ctrl = v["control"]
    failed = [k for k, x in ctrl.items() if x > v["limits"][k]]
    assert "rank_gap" in failed, (ctrl, v["limits"])
    assert "state_gap" in failed, (ctrl, v["limits"])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_every_metric_of_the_cell_is_read(runs, name):
    bench, cell = load_bench(), _cell(name)
    res = runs[name]
    e2e = cell_mod.result_metrics(res, bench, cell, False, reader)
    want = {m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(e2e) == want
    layer = cell_mod.result_metrics(res, bench, cell, True, reader)
    # on the CPU no device operation is traced: the readers of device
    # shares find nothing and leave their metrics out
    host_only = {m["name"] for m in bench["per_layer"]
                 if name in m["workloads"] and m["source"] == "host_clock"}
    assert host_only <= set(layer)
    assert all(v["value"] > 0 for v in e2e.values())


def test_mixed_window_crosses_a_rebuild(runs):
    s = runs["quora_roberta_523k.mixed"]["setup"]
    idx = {c["n_indexed"] for c in s.calls if not c["add"]}
    assert len(idx) >= 2 and s.added > 0


def test_window_outruns_its_set_up_rows():
    """A program faster than the mix was sized for draws more window rows
    from the seed, and the reference holds its answers over them."""
    def small(make=tiny.mixed_cell):
        cfg, mix = make()
        mix.update(fresh_rows=256)
        return cfg, mix
    res = tiny.run(small, seconds=1.5)
    s = res["setup"]
    assert s.added > 256 and s.data.fresh.shape[0] >= s.added
    assert res["verdict"]["correct"], res["verdict"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_on_the_card(cuda_device, name):
    """The same tiny cells through the port's CUDA kernels, traced: the
    reference holds them, the control fails, the device readers read."""
    res = tiny.run(CELLS[name], seconds=3.0, trace=True, control=True,
                   device=cuda_device)
    v = res["verdict"]
    assert v["correct"], v
    assert v["control"]["rank_gap"] > v["limits"]["rank_gap"]
    layer = cell_mod.result_metrics(res, load_bench(), _cell(name), True,
                                    reader)
    assert all(0 < m["value"] <= 100 for k, m in layer.items()
               if m["unit"] == "%" and "roofline" in k), layer


@pytest.mark.parametrize("path,value", [
    (("index", "engine"), "blocked"),
    (("index", "store"), "bf16"),
    (("index", "whitener", "kind"), "zca"),
])
def test_a_value_the_harness_does_not_drive_is_refused(path, value):
    cfg, mix = tiny.batch_cell()
    d = cfg
    for key in path[:-1]:
        d = d[key]
    d[path[-1]] = value
    with pytest.raises(ValueError, match=path[-1]):
        cell_mod.validate(cfg, mix)
    cfg, mix = tiny.batch_cell()
    mix["loop"] = "open, poisson"
    with pytest.raises(ValueError, match="loop"):
        cell_mod.validate(cfg, mix)
