"""Finding the benchmark's pieces by name: ``BENCHMARK.json``, a cell's
configuration, graph and limits, and the modules of ``reference/``,
``counts/`` and ``metrics/``.  A later cell, configuration, graph or
per-layer metric adds files here; no file is edited."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def graph(name: str) -> dict:
    return load_json(HERE / "graphs" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def peaks() -> dict:
    return load_json(HERE / "peaks.json")


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gnnbench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, section: str, cell_name: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


def attribution() -> dict[str, frozenset]:
    """Host range names by group: every line of ``attribution/<group>/*.txt``
    names a range whose device work belongs to the group."""
    groups = {}
    for d in sorted((HERE / "attribution").iterdir()):
        if d.is_dir():
            names = set()
            for f in sorted(d.glob("*.txt")):
                names.update(ln.strip() for ln in f.read_text().splitlines()
                             if ln.strip() and not ln.startswith("#"))
            groups[d.name] = frozenset(names)
    return groups
