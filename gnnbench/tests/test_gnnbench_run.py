"""A whole run of each cell on the CPU at a cut size, past the look for a
card: the last line's keys, and ``correct`` false under each fault of a
training cell planted in the program underneath."""

import importlib
import json
import sys
import types

import pytest
import torch

from gnnbench import run, spec
from gnnbench.reference.plain import half_mask

CUT = dict(nodes=1500, edges=30000, features=48, classes=5,
           split=dict(train=900, val=300, test=300))
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def drive(capsys, cell, trace=0, seed=2**31 + 11):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu",
                  graph_override=CUT)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(capsys, cell, trace):
    line = drive(capsys, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = spec.benchmark()
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec.metrics_of(bench, section, cell)}
    assert set(line["metrics"]) <= names
    if not trace:   # the device metrics of a trace are not read on a CPU
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def half_batch(monkeypatch):
    from isplib_tpu_torch.train import loop
    real = loop._loss_fn
    monkeypatch.setattr(loop, "_loss_fn", lambda logits, y, mask, loss:
                        real(logits, y, half_mask(mask), loss))


def lane(monkeypatch):
    spmm = importlib.import_module("isplib_tpu_torch.ops.spmm")
    real = spmm.SpMM.forward

    def forward(ctx, *args):
        out = real(ctx, *args)
        out[:, 0] = 0.0
        return out
    monkeypatch.setattr(spmm.SpMM, "forward", staticmethod(forward))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch, lane])
def test_a_fault_is_not_correct(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = drive(capsys, cell)
    assert line["correct"] is False


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


def test_jax_loaded_no_result(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "0.1"], device="cpu", graph_override=CUT)
    assert rc == 3
    assert capsys.readouterr().out == ""
