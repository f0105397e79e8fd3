"""The readers of the port's own spans and stages: the device readers on a
hand-made summary, the set-up readers on a hand-made stage log, a cut run
of each cell on the CPU (and of a cell added to an in-memory
``BENCHMARK.json``), and two runs in one process."""

import json

import pytest

from gnnbench import run, spec, stages
from gnnbench.trace import Summary
from isplib_tpu_torch.utils import profiling

CUT = dict(nodes=1500, edges=30000, features=48, classes=5,
           split=dict(train=900, val=300, test=300))
DEVICE = ("k1_ms", "k2_ms", "k3_ms", "route_ms")
SETUP = ("k2_edge_share_pct", "sort_s", "host_copy_s", "norm_self_s",
         "plan_mm_s")
PLAN = ("k2_edge_share_pct", "plan_mm_s")


def read(name, summary=None):
    rec = run.RunRecord(config={}, graph={}, counts=None, peak=None,
                        summary=summary, spans={})
    return spec.module("metrics", name).read(rec)


def summary(**group_s):
    return Summary(window_s=1.0, epochs=4, busy_s=0.9, device_s=0.8,
                   group_s=dict(spmm=0.5, **group_s), device_ops=[],
                   idle_gaps=[])


@pytest.mark.parametrize("name", DEVICE)
def test_device_reader(name):
    group = name[:-3]
    assert read(name, summary(**{group: 0.02})) == pytest.approx(5.0)
    assert read(name, summary(**{group: 0.0})) is None
    assert read(name, summary()) is None
    assert read(name, None) is None


def stage(i, name, t0, t1, parent=None, **attrs):
    return dict(id=i, parent=parent, name=name, t0_ns=int(t0 * 1e9),
                t1_ns=int(t1 * 1e9), attrs=attrs)


# an earlier run's stages, then this run's: the harness's graph build, the
# transform's, the plans'
LOG = [
    stage(0, "graph.build", 0, 10),
    stage(1, "graph.sort", 1, 4, 0, order="csr"),
    stage(2, "plan.mm", 11, 12),
    stage(3, "graph.build", 20, 30),
    stage(4, "graph.sort", 21, 23, 3, order="csr"),
    stage(5, "graph.sort", 24, 25, 3, order="csc"),
    stage(6, "graph.upload", 26, 27, 3),
    stage(7, "norm.gcn", 30, 50),
    stage(8, "norm.readback", 30, 31, 7),
    stage(9, "graph.build", 31, 40, 7),
    stage(10, "graph.sort", 32, 34, 9, order="csr"),
    stage(11, "norm.readback", 41, 42, 7),
    stage(12, "plan.build", 50, 60),
    stage(13, "plan.readback", 50, 51.5, 12),
    stage(14, "plan.v5", 51.5, 53, 12, direction="A", blocks=3,
          dense_edges=300, residual_edges=700),
    stage(15, "plan.v5", 53, 54, 12, direction="AT", blocks=1,
          dense_edges=100, residual_edges=900),
    stage(16, "plan.mm", 54, 56, 12, direction="A", schedule=True),
    stage(17, "plan.sched", 55, 56, 16, kind="K3"),
    stage(18, "plan.mm", 56, 56.5, 12, direction="AT", schedule=False),
]
WANT = dict(k2_edge_share_pct=30.0, sort_s=5.0, host_copy_s=4.5,
            norm_self_s=20.0 - 11.0, plan_mm_s=2.5)


@pytest.fixture
def log(monkeypatch):
    held = list(LOG)
    monkeypatch.setattr(profiling, "stages", lambda: list(held))
    return held


@pytest.mark.parametrize("name", SETUP)
def test_setup_reader(log, name):
    assert read(name) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SETUP)
def test_setup_reader_without_its_stages(log, name):
    keep = {"graph.build", "graph.sort"} if name != "sort_s" else set()
    log[:] = [s for s in log if s["name"] in keep] or [LOG[0]]
    assert read(name) is None


@pytest.mark.parametrize("name", SETUP)
def test_setup_reader_without_a_stage_log(monkeypatch, name):
    """The parent of the stage log: the port has no ``stages``."""
    monkeypatch.delattr(profiling, "stages")
    assert read(name) is None


def test_a_run_starts_at_its_last_root_graph_build(log):
    assert [s["id"] for s in stages.of_run()] == list(range(3, 19))
    log.append(stage(19, "graph.build", 70, 71))
    log.append(stage(20, "graph.sort", 70, 70.5, 19))
    assert read("sort_s") == pytest.approx(0.5)
    assert read("plan_mm_s") is None


def drive(capsys, cell, seed):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", "1"], device="cpu", graph_override=CUT)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", [*[w["name"] for w in
                                    spec.benchmark()["workloads"]], "added"])
def test_a_cut_run_reads_its_own_stages(capsys, request, cell):
    """What a cell reports is what ``BENCHMARK.json`` lists for it, and
    its sorts are two a graph build of its own run's stage log."""
    if cell == "added":   # a cell that only the in-memory file has
        cell = request.getfixturevalue("added_cell")
    listed = {m["name"] for m in spec.metrics_of(spec.benchmark(),
                                                 "per_layer", cell)}
    # numbers from the host stages; none from a plan (a CPU graph is never
    # tiled) or from a device trace
    got = (listed & set(SETUP)) - set(PLAN)
    first = drive(capsys, cell, 2**31 + 5)["metrics"]
    log = profiling.stages()
    second = drive(capsys, cell, 2**31 + 6)["metrics"]
    for m in (first, second):
        assert got <= set(m)
        assert all(m[n]["value"] > 0 for n in got)
        assert not {*PLAN, *DEVICE} & set(m)
    # the second run's readings are its own stages', not both runs'
    new = [s for s in profiling.stages() if s["id"] > log[-1]["id"]]
    assert new[0]["name"] == "graph.build" and new[0]["parent"] is None
    builds = [s for s in new if s["name"] == "graph.build"]
    sorts = [stages.seconds(s) for s in new if s["name"] == "graph.sort"]
    assert len(sorts) == 2 * len(builds)
    assert read("sort_s") == pytest.approx(sum(sorts))
    if "sort_s" in got:
        assert second["sort_s"]["value"] == pytest.approx(sum(sorts))
    every = [stages.seconds(s) for s in profiling.stages()
             if s["name"] == "graph.sort"]
    assert read("sort_s") < sum(every)
