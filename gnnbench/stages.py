"""The port's set-up stages of the run in this process, for the per-layer
readers of ``metrics/``.

The port records each stage of its set-up (``isplib_tpu_torch.utils.
profiling.stages()``: ``{id, parent, name, t0_ns, t1_ns, attrs}``, oldest
first).  A run's stages are those from its last root ``graph.build`` (the
harness's own ``from_edge_index``) onward, so two runs in one process are
not summed together.  A port without the stage log gives None, as does a
run without a root ``graph.build``.
"""

from __future__ import annotations


def of_run() -> list[dict] | None:
    """The closed stages of the run in this process, or None."""
    try:
        from isplib_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "stages", None)
    if read is None:
        return None
    log = read()
    roots = [i for i, s in enumerate(log)
             if s["name"] == "graph.build" and s["parent"] is None]
    if not roots:
        return None
    return [s for s in log[roots[-1]:] if s["t1_ns"] is not None]


def seconds(s: dict) -> float:
    return (s["t1_ns"] - s["t0_ns"]) / 1e9


def total_s(names: tuple[str, ...]) -> float | None:
    """Seconds summed over the run's stages named in ``names``; None when
    the run has none of them."""
    run = of_run()
    if run is None:
        return None
    found = [seconds(s) for s in run if s["name"] in names]
    return sum(found) if found else None


def self_s(name: str) -> float | None:
    """The last stage ``name``'s seconds less its child stages' (its self
    time); None when the run has no such stage."""
    run = of_run()
    top = [s for s in run or [] if s["name"] == name]
    if not top:
        return None
    s = top[-1]
    return seconds(s) - sum(seconds(c) for c in run
                            if c["parent"] == s["id"])


def last(name: str, **attrs) -> dict | None:
    """The run's last stage ``name`` whose attributes hold ``attrs``."""
    run = of_run()
    found = [s for s in run or [] if s["name"] == name
             and all(s["attrs"].get(k) == v for k, v in attrs.items())]
    return found[-1] if found else None
