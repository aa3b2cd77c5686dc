"""A run with the timed path broken underneath comes out not correct, and
the control (the reference one precision below the configuration's, in the
program's place) does too; the unbroken run comes out correct. The
harness's look for a card is skipped: the cells run on the CPU at a tiny
size, with the cells' own limits (the train cell's widened for the tiny
model's rounding noise: tiny.LIMITS)."""

import pytest

from benchmark import faults, harness, spec
from benchmark.tests import tiny

# The faults each cell can have (one chip: no exchange between chips; the
# stream runs one row: no half of a batch).
CASES = [(c, f) for c in tiny.CELLS for f in faults.NAMES
         if not (f == "stale" and "train" not in c)
         and not (f == "half_batch" and "stream" in c)
         and not (f == "half_batch" and "b1" in c)]


def _run(cell, seed=tiny.SEED):
    return harness.run(cell, seed, 0.3, False, "cpu", overrides=tiny.overrides(cell))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
    c = spec.cell(cell)
    drv = harness.make_driver(c, tiny.SEED, "cpu", tiny.overrides(cell))
    drv.setup()
    drv.window(0.3)
    drv.release()
    ok, rows = harness.check(drv, {**c.limits, **tiny.overrides(cell)["limits"]}, control=True)
    assert not ok, rows
