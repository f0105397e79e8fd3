"""A cut run of each cell on the card, through the kernels (a graph of 2M
edges is tiled) and the profiler.  Skips without a CUDA card.

    python -m pytest gnnbench/tests -q -m chip

The cells' limits are set at their own size, where K2's bf16 blocks carry
about half of GCN's edges; at this size they carry nearly all, so the run
is held to the cell's upper readings (its control's) instead.
"""

import json

import pytest
import torch

from gnnbench import check, run, spec

CUT = dict(nodes=20000, edges=2_000_000,
           split=dict(train=13000, val=3000, test=4000))


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cut_run_on_the_card(capsys, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 17),
                   "--seconds", "2", "--trace", "1"], device="cuda",
                  graph_override=CUT)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"]["busy_s"] > 0
    assert {"spmm_ms", "dense_ms", "device_idle_pct"} <= set(line["metrics"])
    upper = spec.limits(cell)["readings"]["upper"]
    for k in check.NAMES:
        assert line["checks"][k]["value"] < upper[k], (k, line["checks"])
