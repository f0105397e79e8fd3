"""The trace's reduction on a hand-made list of profiler events: busy time
as a union, attribution through enclosing host ranges, idle gaps named by
what the host was doing."""

import types

import pytest

from torch.autograd import DeviceType

from gnnbench import trace


def ev(name, start, end, device=False, parent=None, kernels=(), thread=1):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        cpu_parent=parent, thread=thread,
        kernels=[types.SimpleNamespace(duration=d) for d in kernels])


def test_summarize():
    window = ev(trace.WINDOW_RANGE, 0, 100)
    spmm = ev("SpMM", 10, 30, parent=window)
    mm = ev("aten::mm", 40, 45, parent=window, kernels=[20])
    inner = ev("aten::zeros", 11, 12, parent=spmm, kernels=[5])
    events = [
        window, spmm, mm, inner,
        ev("cudaLaunchKernel", 50, 60, parent=window),
        ev("aten::nonzero", 33, 39, parent=window),
        ev("early", -50, -40, device=True),          # a lead kernel
        ev("fill", 12, 17, device=True),
        ev("walk_kernel", 15, 35, device=True),      # overlaps fill
        ev("gemm", 45, 65, device=True),
        ev(trace.WINDOW_RANGE, 12, 65, device=True),   # its annotation
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    s = trace.summarize(prof, epochs=2, groups={"spmm": {"SpMM"}})
    assert s.window_s == 100e-6 and s.epochs == 2
    assert s.busy_s == pytest.approx((35 - 12 + 65 - 45) * 1e-6)
    assert s.device_s == pytest.approx((5 + 20 + 20) * 1e-6)
    assert s.group_s == {"spmm": pytest.approx(5e-6)}
    assert s.device_ops[0][0] in ("walk_kernel", "gemm")
    # gaps: 0-12 and 65-100 with no range open but the window's, 35-45
    # begun inside aten::nonzero
    assert dict(s.idle_gaps) == {
        "(no host range)": pytest.approx(47e-6),
        "aten::nonzero": pytest.approx(10e-6)}


def test_host_at_takes_the_innermost_latest_range():
    host = [(0, 100, "outer", 1), (10, 20, "inner", 1), (15, 50, "bwd", 2)]
    assert trace._host_at([5, 12, 18, 30, 60], host) == \
        ["outer", "inner", "bwd", "bwd", "outer"]
    assert trace._host_at([200], host) == ["(no host range)"]


def test_no_window_no_summary():
    prof = types.SimpleNamespace(events=lambda: [ev("x", 0, 1)])
    assert trace.summarize(prof, 1, {}) is None
