"""A cell added to an in-memory ``BENCHMARK.json``, for the tests whose
cells are parametrised over the file's (their parameter ``added``)."""

import copy

import pytest

from gnnbench import spec


@pytest.fixture
def added_cell(monkeypatch):
    """The name of a cell that ``BENCHMARK.json`` lacks, added the way a
    later change adds one, as entries and files only: an existing
    configuration on a graph of ``graphs/`` that it does not run on yet,
    copied from a cell of that configuration, appended to ``workloads``
    and to each metric's ``workloads`` list that names the copied cell.
    The copied cell's limits stand for the limits file the change would
    add.  No file is written."""
    bench = spec.benchmark()
    have = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    graphs = sorted(p.stem for p in (spec.HERE / "graphs").glob("*.json"))
    like, traffic = next(
        ((w, g) for w in bench["workloads"] for g in graphs
         if (w["config"], g) not in have),
        (bench["workloads"][0], bench["workloads"][0]["traffic"]))
    name = f"{like['config']}.{traffic}.added"
    bench["workloads"].append(dict(like, name=name, traffic=traffic))
    for m in bench["per_layer"]:
        if like["name"] in m.get("workloads", []):
            m["workloads"].append(name)
    monkeypatch.setattr(spec, "benchmark", lambda: copy.deepcopy(bench))
    limits = spec.limits
    monkeypatch.setattr(spec, "limits", lambda cell: limits(
        like["name"] if cell == name else cell))
    return name
