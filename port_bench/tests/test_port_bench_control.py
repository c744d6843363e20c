"""The output check's control, on the card: the reference put in the
program's place with TF32 matrix products comes out not correct against
each cell's limits, on three seeds, at a size a test run can hold (the
sweep at 60 points and one round). At the cells' own sizes the same
readings come from ``python3 port_bench/control.py``."""

import pytest

from conftest import ROOT

SMALL = {"num_points": 60, "rounds": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["syn240.sweep", "syn861.sweep"])
def test_tf32_control_is_not_correct(cuda_card, workload):
    from port_bench import bench, control

    cell = bench.load_cell(ROOT, workload)
    cell.config = dict(cell.config, **SMALL)
    for seed in (1, 2, 3):
        out = control.readings(cell, seed, cuda_card)
        ok, rows = bench.judge(out["control"], cell.limits)
        assert not ok, (workload, seed, rows)
