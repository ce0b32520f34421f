"""The run driven with its timed path broken underneath, past the look for
a card: ``correct`` comes out false for each fault the cells can have.
(One card: no exchange between chips to leave out.)"""

import pytest

from perfbench import faults
from perfbench.tests import tiny


@pytest.mark.parametrize("make,fault", [
    (tiny.mixed_cell, faults.state_unchanged),
    (tiny.batch_cell, faults.half_batch),
    (tiny.mixed_cell, faults.half_batch),
    (tiny.batch_cell, faults.answer_altered),
    (tiny.batch_cell, faults.pools_halved),
    (tiny.mixed_cell, faults.pools_halved),
    (tiny.batch_cell, faults.sweep_garbage),
    (tiny.mixed_cell, faults.sweep_garbage),
], ids=["mixed-state-unchanged", "batch-half", "mixed-half",
        "batch-altered", "batch-pools-halved", "mixed-pools-halved",
        "batch-sweep-garbage", "mixed-sweep-garbage"])
def test_fault_makes_the_run_incorrect(make, fault):
    undo = []
    try:
        v = tiny.run(make, seconds=1.5,
                     fault=lambda s: undo.append(fault(s)))["verdict"]
    finally:
        for u in undo:
            u()
    assert not v["correct"], v["numbers"]
