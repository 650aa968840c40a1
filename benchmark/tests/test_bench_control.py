"""The control, the program with its own int8 serving mode on, comes out as
not correct and the program as correct, against each cell's limits: on the
card at the cell's own size (``cuda``), and for the served cell at a size
the CPU holds."""

import pytest
import torch

import control
import harness
from conftest import ROOT

SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


def readings(cell, seeds, dev):
    fn = control.cases_readings if cell.mix["kind"] == "cases" else control.train_readings
    return list(fn(cell, seeds, dev, ("program", "program_int8")))


def verdicts(cell, rows):
    """A seed's (the program passes every limit, the control fails one),
    over the numbers the cell holds to a limit."""
    for _seed, row in rows:
        program, control_ = ({k: v for k, v in row[side].items() if k in cell.limits}
                             for side in ("program", "program_int8"))
        yield (all(v <= cell.limits[k] for k, v in program.items()),
               any(v > cell.limits[k] for k, v in control_.items()))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["b.predict", "7b.train", "b.train"])
def test_control_fails_and_program_passes_at_cell_size(card, workload):
    cell = harness.Cell(ROOT, workload)
    harness.program_env(ROOT, cell.cfg)
    assert all(p and c for p, c in verdicts(cell, readings(cell, SEEDS, card)))


def test_served_control_fails_at_a_cpu_size(tiny_root):
    cell = harness.Cell(tiny_root, "t.predict")
    harness.program_env(tiny_root, cell.cfg)
    assert all(p and c for p, c in verdicts(cell, readings(cell, SEEDS, torch.device("cpu"))))
