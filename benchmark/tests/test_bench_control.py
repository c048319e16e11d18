"""The control of `correct`: the reference in TF32, put in the program's
place at the same rows, fails the cell's limits, where the program's own
outputs pass them (cells shrunk to the host; on the card at the cells' own
sizes by `benchmark/control.py`)."""

import pytest

import control
import harness
import traffic
from _small_cells import SEED, SMALL, load


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_tf32_control_fails_where_the_program_passes(cell):
    c = load(cell)
    prog, ctl, _ = control.readings(c, SEED, 0.01, "cpu", **SMALL[cell])
    assert set(prog) == set(ctl) == set(
        traffic.loop_module(c.mix["loop"]).NUMBERS)
    assert harness.passed(harness.judge(prog, c.limits)), prog
    assert not harness.passed(harness.judge(ctl, c.limits)), ctl
