"""Each cell's control, the reference computed in the precision below its
configuration's, and each fault of a training cell planted in the
reference, fail one of the cell's limits at a size a test run holds; the
reference against itself passes them all.  ``control.py`` reads the same
at the cell's own size on the card."""

import pytest
import torch

from gnnbench import check, control, spec

CUT = dict(nodes=3000, edges=120000, split=dict(train=2000, val=500,
                                                test=500))
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(scope="module", params=CELLS)
def cell_readings(request):
    return request.param, control.readings(request.param, 2**31 + 3,
                                           torch.device("cpu"), CUT)


def test_control_and_faults_fail(cell_readings):
    cell, readings = cell_readings
    limits = spec.limits(cell)
    for case in control.CASES:
        g = readings[case]
        assert not check.judge(g, limits), (case, g, limits)
