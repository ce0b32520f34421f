"""The host half of ``bench/build_divergence.py`` on the CPU: the two
recorded cases of card-versus-host build differences (phase 3g (d)'s
32-lane PCA+ICA forest and the 8-lane, 64-d PCA+ZCA forest), each cut to
its first rows, built by the port on the host with every descent step
recorded and by the JAX package from the same whitened rows.

The rule is the one the probe's verdict on the card set (``PERF.md`` §7):
trees are equal slot for slot, except in a lane where some decision up
to the first insert that differs was a tie or a near tie, its two values
within the float32 rounding bound of their terms (``near_ties``).  The
probe's own machinery is held too: a recorded build equals an unrecorded
one, a build compared with itself differs nowhere, and the verdicts of
constructed flips."""

import jax
import numpy as np
import pytest
import torch

from rag_cobweb_tpu.core.config import TreeConfig as JCfg
from rag_cobweb_tpu.parallel.vforest import VForest as JForest
from rag_cobweb_tpu_torch.bench import build_divergence as bd
from rag_cobweb_tpu_torch.core import tree as tree_mod

torch.set_num_threads(1)

STRUCT = ("counts", "parent", "children", "n_children", "root", "n_alloc",
          "free_top")


def jax_lane_equal(jf, trace, lane) -> bool:
    st = jax.device_get(jf.state)
    return (all(np.array_equal(np.asarray(getattr(st, f))[lane],
                               trace.arrays[f][lane]) for f in STRUCT)
            and jf._leaf_of_local[lane] == trace.forest._leaf_of_local[lane])


@pytest.fixture(scope="module", params=[("a", 512), ("b", 400)],
                ids=["a-512", "b-400"])
def case(request):
    name, n = request.param
    x, cfg, lanes = bd.case_rows(name, n, "cpu")
    trace = bd.traced_build(x, cfg, lanes, "cpu")
    f = bd.make_forest(cfg, lanes, n, "cpu")
    jf = JForest(JCfg(dim=cfg.dim), n_subtrees=lanes,
                 capacity_per_tree=f.state.capacity, seed=0)
    jf.add(x.numpy())
    return name, x, cfg, lanes, trace, jf


def test_host_build_equals_the_jax_build_but_at_near_ties(case):
    """Each lane of the port's host build against the JAX package's: slot
    for slot, or else the port's record shows a tie within the rounding
    bound at or before the first insert whose leaf differs."""
    name, _, _, lanes, trace, jf = case
    for lane in range(lanes):
        if jax_lane_equal(jf, trace, lane):
            continue
        want, got = jf._leaf_of_local[lane], trace.forest._leaf_of_local[lane]
        first = next((i for i, (a, b) in enumerate(zip(want, got))
                      if a != b), min(len(want), len(got)))
        assert bd.near_ties(trace, lane, first), (name, lane, first)


def test_recorded_build_equals_the_plain_build(case):
    """Recording the steps changes nothing: a plain host build of the same
    rows has the same state arrays and leaves."""
    _, x, cfg, lanes, trace, _ = case
    f = bd.make_forest(cfg, lanes, len(x), "cpu")
    f.add(x)
    arrays = tree_mod.state_to_numpy(f.state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, trace.arrays[k], err_msg=k)
    assert f._leaf_of_local == trace.forest._leaf_of_local


def test_build_compared_with_itself_differs_nowhere(case):
    _, x, cfg, lanes, trace, _ = case
    again = bd.traced_build(x, cfg, lanes, "cpu")
    rec = bd.compare(trace, again)
    assert rec["lanes_differing"] == [] and rec["lanes"] == lanes
    # every lane's inserts were all recorded, in the forest's order
    for lane in range(lanes):
        leaves = [leaf for _, _, leaf in trace.attempts(lane)]
        assert leaves == trace.forest._leaf_of_local[lane]


def test_run_case_on_the_host_records_the_host_build():
    rec = bd.run_case("b", rows=64, device="cpu")
    assert rec["rows"] == 64 and rec["lanes"] == 8 and rec["dim"] == 64
    assert "card" not in rec and rec["host"].device == "cpu"
    assert bd.summary(rec) == {"case": "b", "rows": 64, "lanes": 8,
                               "dim": 64}


def _internal_step(trace):
    """A recorded step with a live internal lane of 3+ children."""
    for rec in trace.rec.steps:
        ok = rec["internal"] & rec["live"] & (rec["mask"].sum(1) >= 3)
        if ok.any():
            return rec, int(np.nonzero(ok)[0][0])
    raise AssertionError("no internal step")


def test_flip_verdicts(case):
    """A flip's verdict from its values: both gaps 0 is an exact tie (the
    noise decided), gaps within n x 2^-24 x the magnitudes a near tie,
    anything wider beyond the bound; the noise of both entries and the
    bound are recorded."""
    _, _, cfg, _, trace, _ = case
    rec, lane = _internal_step(trace)
    b1 = int(rec["best1"][lane])
    other = int(next(i for i in np.nonzero(rec["mask"][lane])[0]
                     if i != b1))

    def flipped(values):
        h = {k: (v.copy() if isinstance(v, np.ndarray) else v)
             for k, v in rec.items()}
        c = {k: (v.copy() if isinstance(v, np.ndarray) else v)
             for k, v in rec.items()}
        for r, (va, vb) in ((h, values[0]), (c, values[1])):
            r["gains"][lane, b1], r["gains"][lane, other] = va, vb
            r["counts"][lane, [b1, other]] = 3.0
        c["best1"][lane] = other
        return bd._flip(h, c, lane, "child", cfg)

    mag = float(rec["gain_mag"][lane, b1] + rec["gain_mag"][lane, other])
    bound = bd.decision_terms("child", cfg) * bd.U * mag
    tie = flipped(((1.0, 1.0), (1.0, 1.0)))
    assert tie["verdict"] == "exact tie"
    assert tie["host"]["noise_decided"] and tie["card"]["noise_decided"]
    near = flipped(((1.0, 1.0 - 0.5 * bound), (1.0, 1.0 + 0.5 * bound)))
    assert near["verdict"] == "near tie"
    assert near["host"]["bound"] == pytest.approx(bound)
    assert not near["host"]["noise_decided"]
    far = flipped(((1.0, 1.0 - 3 * bound), (1.0, 1.0 + 3 * bound)))
    assert far["verdict"] == "beyond bound"
    assert far["choice"] == {"host": b1, "card": other}
    assert far["host"]["noise"] == [float(rec["noise_two"][lane, b1]),
                                    float(rec["noise_two"][lane, other])]
