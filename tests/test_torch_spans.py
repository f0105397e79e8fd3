"""The port's tracing (``utils/profiling.py``): hot-path spans that cost a
flag read with no profiler running and name the kernels' wrappers, the
winner routing and the training step under one; set-up stages that nest as
the calls do, carry their attributes and stay within a bounded log."""

import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import isplib_tpu_torch as pt
from isplib_tpu_torch.kernels import spmm_bsr, spmm_minmax_v4, spmm_stream
from isplib_tpu_torch.nn import GCN, gcn_norm
from isplib_tpu_torch.ops.semiring import Reduce
from isplib_tpu_torch.sparse.graph import from_edge_index
from isplib_tpu_torch.sparse.tiling import build_tiling
from isplib_tpu_torch.train import make_train_step
from isplib_tpu_torch.utils import profiling

HOT_SPANS = ("isplib.K1", "isplib.K2", "isplib.K3", "isplib.route",
             "isplib.step")


@pytest.fixture(autouse=True)
def fresh_log():
    profiling.clear_stages()
    yield
    profiling.clear_stages()


def edges(seed=0, n=400, nnz=6000):
    """A (2, nnz) edge_index: half the edges in a 130x130 corner, so v5
    finds dense blocks at a threshold of 16, half uniform."""
    rng = np.random.default_rng(seed)
    h = nnz // 2
    src = np.concatenate([rng.integers(0, 130, h), rng.integers(0, n, h)])
    dst = np.concatenate([rng.integers(0, 130, h), rng.integers(0, n, h)])
    return np.stack([src, dst])


def tiled_graph():
    g = from_edge_index(edges(), num_nodes=400, device="cpu")
    return build_tiling(g, version=5, k=8, dense_threshold=16)


def run_hot_path(tg):
    """Each wrapper once on CPU tensors, a max SpMM forward and backward
    on the tiled graph, and one GCN training step."""
    base = tg.graph
    x = torch.randn(base.num_cols, 8)
    out = spmm_bsr.spmm_bsr(tg.fwd, x)
    spmm_stream.spmm_stream(tg.fwd, x, out)
    spmm_minmax_v4.spmm_minmax_v4(tg.fwd_mm, base.col, base.value, x,
                                  Reduce.MAX, base.nnz_padded - 1)
    xg = x.clone().requires_grad_()
    pt.spmm(tg, xg, "max").sum().backward()
    model = GCN(8, hidden=4, num_classes=3, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    y = torch.randint(0, 3, (base.num_rows,))
    mask = torch.ones(base.num_rows, dtype=torch.bool)
    make_train_step(model, opt, tg)(x, y, mask)


def by_name(log, name):
    return [s for s in log if s["name"] == name]


def children(log, parent):
    return [s for s in log if s["parent"] == parent["id"]]


def inside(child, parent) -> bool:
    return (parent["t0_ns"] <= child["t0_ns"] <= child["t1_ns"]
            <= parent["t1_ns"])


# ---------------------------------------------------------------------------
# hot-path spans
# ---------------------------------------------------------------------------

def test_span_off_is_the_shared_null_and_enters_no_range(monkeypatch):
    tg = tiled_graph()
    entered = []

    def counting(real):
        def enter(name, *a, **kw):
            entered.append(name)
            return real(name, *a, **kw)
        return enter

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    assert profiling.span("isplib.K1") is profiling._NULL
    assert profiling.span("other") is profiling.span("isplib.K1")
    run_hot_path(tg)
    assert entered == []
    # the same counters do see the ranges a profiler opens
    with profile(activities=[ProfilerActivity.CPU]):
        run_hot_path(tg)
    assert set(HOT_SPANS) <= set(entered)


def test_spans_name_the_wrappers_routing_and_step_under_a_profiler():
    tg = tiled_graph()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_hot_path(tg)
    names = {e.name for e in prof.events()}
    assert set(HOT_SPANS) <= names
    # the routing runs inside the SpMM's backward, the kernels inside a step
    route = [e for e in prof.events() if e.name == "isplib.route"]
    assert route
    for e in route:
        up, p = set(), e.cpu_parent
        while p is not None:
            up.add(p.name)
            p = p.cpu_parent
        assert any("SpMMBackward" in n for n in up)


def test_span_is_off_again_after_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("x") is not profiling._NULL
    assert profiling.span("x") is profiling._NULL


# ---------------------------------------------------------------------------
# set-up stages
# ---------------------------------------------------------------------------

def test_from_edge_index_is_one_root_build_of_two_sorts_and_an_upload():
    ei = edges()
    g = from_edge_index(ei, num_nodes=400, device="cpu")
    log = profiling.stages()
    builds = by_name(log, "graph.build")
    assert len(builds) == 1
    root = builds[0]
    assert root["parent"] is None
    assert root["attrs"] == dict(nnz=ei.shape[1], rows=400, cols=400)
    kids = children(log, root)
    sorts = by_name(kids, "graph.sort")
    assert [s["attrs"]["order"] for s in sorts] == ["csr", "csc"]
    assert all(s["attrs"]["nnz"] == g.nnz for s in sorts)
    uploads = by_name(kids, "graph.upload")
    assert len(uploads) == 1
    assert uploads[0]["attrs"]["bytes"] == sum(
        getattr(g, f).nbytes for f in ("rowptr", "row", "col", "value",
                                       "csc_colptr", "csc_row", "csc_col",
                                       "csc_value", "csc2csr", "deg",
                                       "deg_t"))
    assert all(inside(k, root) for k in kids)
    assert len(log) == 4


def test_from_scipy_is_a_graph_build():
    sp = pytest.importorskip("scipy.sparse")
    mat = sp.random(50, 40, density=0.1, format="csr", random_state=0)
    pt.from_scipy(mat, device="cpu")
    (root,) = by_name(profiling.stages(), "graph.build")
    assert root["attrs"] == dict(nnz=mat.nnz, rows=50, cols=40)


def test_gcn_norm_holds_two_builds_and_two_readbacks():
    g = from_edge_index(edges(), num_nodes=400, device="cpu")
    profiling.clear_stages()
    gn = gcn_norm(g)
    log = profiling.stages()
    (norm,) = by_name(log, "norm.gcn")
    assert norm["parent"] is None and norm["attrs"] == dict(nnz=g.nnz)
    kids = children(log, norm)
    assert sorted(k["name"] for k in kids) == [
        "graph.build", "graph.build", "norm.readback", "norm.readback"]
    assert all(inside(k, norm) for k in kids)
    reads = by_name(kids, "norm.readback")
    assert reads[0]["attrs"]["bytes"] == 12 * g.nnz
    assert reads[1]["attrs"]["bytes"] == 12 * (gn.nnz)


def test_build_tiling_holds_readback_v5_and_mm_stages():
    g = from_edge_index(edges(), num_nodes=400, device="cpu")
    profiling.clear_stages()
    tg = build_tiling(g, version=5, k=8, dense_threshold=16)
    log = profiling.stages()
    (plan,) = by_name(log, "plan.build")
    assert plan["parent"] is None
    assert plan["attrs"] == dict(version=5, k=8,
                                 cfg=dict(dense_threshold=16),
                                 cached=False)
    kids = children(log, plan)
    assert [k["name"] for k in kids] == [
        "plan.readback", "plan.v5", "plan.v5", "plan.mm", "plan.mm"]
    assert all(inside(k, plan) for k in kids)
    assert kids[0]["attrs"]["bytes"] > 12 * g.nnz
    v5 = by_name(kids, "plan.v5")
    assert [s["attrs"]["direction"] for s in v5] == ["A", "AT"]
    for s, p in zip(v5, (tg.fwd, tg.bwd)):
        a = s["attrs"]
        assert a["dense_edges"] + a["residual_edges"] == g.nnz
        assert a["blocks"] == p.nb > 0
        assert a["dense_edges"] == p.dense_edges > 0
    mm = by_name(kids, "plan.mm")
    assert [(s["attrs"]["direction"], s["attrs"]["schedule"])
            for s in mm] == [("A", True), ("AT", False)]
    # the schedules' derivations are stages of their own
    scheds = [s for s in log if s["name"] == "plan.sched"]
    assert {s["attrs"]["kind"] for s in scheds} == {"v5", "K3"}


def test_build_tiling_from_numpy_opens_its_own_plan_build_once():
    tg = from_edge_index(edges(), num_nodes=400, device="cpu",
                         tiling=dict(version=5, k=8, dense_threshold=16))
    assert isinstance(tg, pt.TiledGraph)
    log = profiling.stages()
    (root,) = by_name(log, "graph.build")
    (plan,) = by_name(log, "plan.build")
    assert plan["parent"] == root["id"] and inside(plan, root)
    assert by_name(children(log, plan), "plan.readback") == []


def test_a_cached_plan_is_marked(tmp_path):
    g = from_edge_index(edges(), num_nodes=400, device="cpu")
    for _ in range(2):
        build_tiling(g, version=5, k=8, cache_tag="spans",
                     cache_dir=str(tmp_path), dense_threshold=16)
    plans = by_name(profiling.stages(), "plan.build")
    assert [p["attrs"]["cached"] for p in plans] == [False, True]
    assert by_name(children(profiling.stages(), plans[1]), "plan.v5") == []


def test_plan_log_lines_take_their_seconds_from_the_stages(caplog):
    g = from_edge_index(edges(), num_nodes=400, device="cpu")
    with caplog.at_level(logging.INFO, logger="isplib_tpu_torch"):
        build_tiling(g, version=5, k=8, dense_threshold=16)
    text = caplog.text
    assert "version 5 plan of A built in" in text
    assert "v5 schedule:" in text and "K3 schedule:" in text
    log = profiling.stages()
    v5 = by_name(log, "plan.v5")
    secs = [(s["t1_ns"] - s["t0_ns"]) / 1e9 for s in v5]
    assert (f"version 5 plan of A built in {secs[0]:.3f}s, of Aᵀ in "
            f"{secs[1]:.3f}s") in text


def test_stages_nest_under_a_profiler_as_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        from_edge_index(edges(), num_nodes=400, device="cpu")
    names = {e.name for e in prof.events()}
    assert {"graph.build", "graph.sort", "graph.upload"} <= names


def test_stage_records_on_error_and_pops_its_parent():
    with pytest.raises(KeyError):
        with profiling.stage("outer"):
            with profiling.stage("inner", a=1) as st:
                st.attrs["b"] = 2
                raise KeyError("inside")
    with profiling.stage("after"):
        pass
    log = profiling.stages()
    outer, inner, after = log
    assert inner["parent"] == outer["id"] and after["parent"] is None
    assert inner["attrs"] == dict(a=1, b=2)
    assert all(s["t1_ns"] >= s["t0_ns"] for s in log)


def test_the_log_is_bounded_and_counts_what_it_drops():
    n = profiling.STAGE_LOG_LIMIT + 10
    for i in range(n):
        with profiling.stage("s", i=i):
            pass
    log = profiling.stages()
    assert len(log) == profiling.STAGE_LOG_LIMIT
    assert profiling.dropped_stages() == 10
    assert log[0]["attrs"]["i"] == 10 and log[-1]["attrs"]["i"] == n - 1
    profiling.clear_stages()
    assert profiling.stages() == [] and profiling.dropped_stages() == 0


def test_stages_returns_a_copy():
    with profiling.stage("s", a=1):
        pass
    log = profiling.stages()
    log[0]["attrs"]["a"] = 2
    log[0]["name"] = "t"
    again = profiling.stages()[0]
    assert again["name"] == "s" and again["attrs"] == {"a": 1}


def test_timer_sections_are_stages():
    t = profiling.Timer()
    with t.section("epoch", sync=torch.device("cpu"), k=32) as st:
        with profiling.stage("inner"):
            pass
    (epoch,) = by_name(profiling.stages(), "epoch")
    assert epoch["attrs"] == {"k": 32}
    assert t.sections["epoch"] == st.seconds
    (inner,) = by_name(profiling.stages(), "inner")
    assert inner["parent"] == epoch["id"]
