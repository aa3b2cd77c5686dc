"""On the card, at each cell's own size: a sound run is correct, and the
control (the reference one precision below the configuration's in the
program's place) and each fault the cell can have, planted in the port
(benchmark/faults.py), are not. Skips without a card.

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import pytest
import torch

from benchmark import faults, harness, spec
from benchmark.tests import test_bench_faults, tiny

SEED = 2 ** 31 + 4242


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_at_its_size_program_passes_control_fails(card, cell):
    res = harness.run(cell, SEED, 1.0, False, card)
    assert res["correct"], res["checks"]
    c = spec.cell(cell)
    drv = harness.make_driver(c, SEED, card)
    drv.setup()
    drv.window(1.0)
    drv.release()
    torch.cuda.empty_cache()
    ok, rows = harness.check(drv, c.limits, control=True)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", test_bench_faults.CASES)
def test_fault_at_the_cells_size_is_not_correct(card, cell, fault):
    with faults.plant(fault):
        res = harness.run(cell, SEED + 1, 1.0, False, card)
    assert not res["correct"], res["checks"]
