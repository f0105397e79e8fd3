"""The traced stretch of a ``--trace 1`` run and its reduction.

``capture`` runs the epochs under ``torch.profiler``, inside a host range
``gnnbench.window`` that ends with a synchronise, so the range spans the
first launch to the device's last operation.  The profiler drops the first
4 or 5 device records of a session on the H100, so the window opens with
``LEAD_KERNELS`` small kernels and a synchronise, outside the range.

``summarize`` keeps what the per-layer readers need: the window's length,
the device's busy time (the union of its operations' intervals), device
seconds by attribution group (an operation belongs to a group when a host
range named in ``attribution/<group>/`` encloses its launch), the device
operations by time and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

LEAD_KERNELS = 16
WINDOW_RANGE = "gnnbench.window"
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    epochs: int
    busy_s: float
    device_s: float                 # all operations' seconds, summed
    group_s: dict                   # attribution group -> device seconds
    device_ops: list                # [name, seconds], most first
    idle_gaps: list                 # [host activity, seconds], most first


def capture(run_epochs, device: torch.device):
    """Profile ``run_epochs()``; return the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if device.type == "cuda":
            lead = torch.zeros(1, device=device)
            for _ in range(LEAD_KERNELS):
                lead.add_(1.0)
            torch.cuda.synchronize()
        with record_function(WINDOW_RANGE):
            run_epochs()
            if device.type == "cuda":
                torch.cuda.synchronize()
    return prof


def _union(intervals) -> tuple[float, list]:
    """Length of the union of (start, end) intervals, and the merged list."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _open_at(points, host_events) -> list:
    """The innermost range (start, name) of one thread open at each of the
    ascending ``points``, or None; the ranges of one thread nest."""
    found, stack, i = [], [], 0
    for t in points:
        while i < len(host_events) and host_events[i][0] <= t:
            s, e, name = host_events[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        found.append((stack[-1][0], stack[-1][2]) if stack else None)
    return found


def _host_at(points, host_events) -> list[str]:
    """What the host was doing at each point: the range entered last among
    the innermost ranges open on each thread."""
    by_thread = collections.defaultdict(list)
    for s, e, name, thread in host_events:
        by_thread[thread].append((s, e, name))
    per_thread = [_open_at(points, sorted(v)) for v in by_thread.values()]
    names = []
    for i in range(len(points)):
        open_ = [f[i] for f in per_thread if f[i] is not None]
        names.append(max(open_)[1] if open_ else "(no host range)")
    return names


def summarize(prof, epochs: int, groups: dict) -> Summary | None:
    """None when the trace holds no window or no device operation."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW_RANGE
              and e.device_type == DeviceType.CPU]
    if not window:
        return None
    w = window[0]
    w0, w1 = w.time_range.start, w.time_range.end
    # the window's range is mirrored on the device as an annotation, not
    # an operation
    device = [e for e in events if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)
              and e.name != WINDOW_RANGE
              and w0 <= e.time_range.start <= w1]
    if not device:
        return None
    ivals = [(e.time_range.start, min(e.time_range.end, w1)) for e in device]
    busy_us, merged = _union(ivals)
    by_name = collections.Counter()
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    device_s = sum(by_name.values())

    # attribution: each host op's device kernels, by its enclosing ranges
    group_s = {g: 0.0 for g in groups}
    for e in events:
        if (e.device_type != DeviceType.CPU or not e.kernels
                or not w0 <= e.time_range.start <= w1):
            continue
        names, p = set(), e
        while p is not None:
            names.add(p.name)
            p = p.cpu_parent
        for g, ranges in groups.items():
            if names & ranges:
                group_s[g] += sum(k.duration for k in e.kernels) / 1e6

    # idle gaps inside the window, named by what the host was doing when
    # each began
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [(e.time_range.start, e.time_range.end, e.name, e.thread)
            for e in events if e.device_type == DeviceType.CPU
            and e.name != WINDOW_RANGE and e.time_range.end >= w0
            and e.time_range.start <= w1]
    idle = collections.Counter()
    for (s, e), name in zip(gaps, _host_at([g[0] for g in gaps], host)):
        idle[name] += (e - s) / 1e6
    return Summary(
        window_s=(w1 - w0) / 1e6, epochs=epochs, busy_s=busy_us / 1e6,
        device_s=device_s, group_s=group_s,
        device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
        idle_gaps=[[n, s] for n, s in idle.most_common(TOP)])

