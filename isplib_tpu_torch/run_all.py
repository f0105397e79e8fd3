"""The benchmark sweep, the counterpart of the JAX system's
``scripts/run_all.sh``: datasets × backends × model rows through
``run_model``, each row's output appended to its model's file.

    python -m isplib_tpu_torch.run_all [scale] [epochs]

Positional defaults: scale 0.02, 2 epochs.  Output goes to ``$BENCH_OUT``
(default ``bench_results``): ``gcn.txt``, ``sage-sum.txt``,
``sage-mean-nopad.txt`` and ``gin.txt``, each row's ``run_model`` output
appended, its last line but one the CSV row TRG_TM,TRG_STD,TST_TM,TRG_ACC,
TST_ACC.  The order and the banners are the shell script's: datasets
reddit, reddit2, protein, mag; in each, backends pt1, xla, pallas; in each,
GCN, SAGE-sum, SAGE-mean ``--nopad`` and GIN.  The JAX backends map to the
port's: ``pt1`` → ``pt1``, ``xla`` → ``reference``, ``pallas`` → ``auto``
with ``--tiling v5``, the JAX CLI's default plan, which the shell's pallas
rows take.

The sweep runs in one process, so the kernels are built once.  Each
dataset is loaded once, tiled as the pallas rows' ``--tiling`` says when
one will run (``run_model.tile``, at the padded width), and every row reads
it: the ``--nopad`` row its features as loaded, the others a padded copy;
all share one graph.  A stand-in is a function of its seed, so this
is the graph a fresh ``load`` gives.  A row that raises is printed with its
error and the sweep goes on; ``main`` lists the failed rows and exits 1 if
there was any.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import sys
import time
import traceback
from typing import Optional

import torch

from . import run_model
from .bench import counted
from .data import load, pad_features
from .device import resolve_device
from .sparse.tiling import TiledGraph

__all__ = ["DATASETS", "BACKENDS", "BACKEND_OF", "ROWS", "Row", "RowResult",
           "sweep", "record", "main"]

DATASETS = ("reddit", "reddit2", "protein", "mag")
BACKENDS = ("pt1", "xla", "pallas")
BACKEND_OF = {"pt1": ("pt1",), "xla": ("reference",),
              "pallas": ("auto", "--tiling", "v5")}


@dataclasses.dataclass(frozen=True)
class Row:
    """One model row of the sweep: its banner (``{d}`` the dataset, ``{b}``
    the shell's backend), ``run_model``'s model and flags, and its file."""
    banner: str
    model: str
    flags: tuple[str, ...]
    file: str


ROWS = (
    Row("=== GCN {d} {b} ===", "gcn", (), "gcn.txt"),
    Row("=== SAGE-sum {d} {b} ===", "sage", ("--aggr", "sum"),
        "sage-sum.txt"),
    Row("=== SAGE-mean {d} {b} (nopad) ===", "sage",
        ("--aggr", "mean", "--nopad"), "sage-mean-nopad.txt"),
    Row("=== GIN {d} {b} ===", "gin", (), "gin.txt"),
)


@dataclasses.dataclass
class RowResult:
    """What one row did: its ``TrainResult`` (None if it failed), its
    error, the kernels it launched, the plan it trained on (a
    TiledGraph's sum plans: version, threshold, blocks and edges) and the
    peak device memory of the row in bytes (0 on the CPU)."""
    dataset: str
    backend: str
    row: Row
    argv: list[str]
    result: object = None
    error: Optional[str] = None
    launches: dict = dataclasses.field(default_factory=dict)
    plan: Optional[dict] = None
    peak_bytes: int = 0
    seconds: float = 0.0
    nodes: int = 0
    edges: int = 0
    features: int = 0

    @property
    def label(self) -> str:
        return self.row.banner.format(d=self.dataset, b=self.backend)


def argv_of(row: Row, dataset: str, backend: str, scale: float,
            epochs: int, device: str) -> list[str]:
    """``run_model``'s arguments for ``row``, as the shell passes them."""
    return [row.model, dataset, *BACKEND_OF[backend], *row.flags,
            "--scale", str(scale), "--epochs", str(epochs),
            "--device", device]


PLAN_FIELDS = ("dense_threshold", "nb", "dense_edges", "sparse_edges")


def plan_summary(graph: TiledGraph) -> dict:
    """The sum plans of A and Aᵀ as the PERF tables give them: the type
    and, for a v5 plan, the threshold after the block cap, the blocks,
    dense and residual edges."""
    return {side: dict(type=type(p).__name__,
                       **{f: int(getattr(p, f)) for f in PLAN_FIELDS
                          if hasattr(p, f)})
            for side, p in (("fwd", graph.fwd), ("bwd", graph.bwd))}


def _run_row(r: RowResult, ds, out_dir: str) -> None:
    args = run_model.parser().parse_args(r.argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            r.result, r.launches = counted(lambda: run_model.run_one(args,
                                                                     ds))
        if args.backend == "auto" and isinstance(ds.graph, TiledGraph):
            r.plan = plan_summary(ds.graph)
    except Exception as e:  # noqa: BLE001 - a row's failure is reported
        r.error = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    finally:
        r.seconds = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
            r.peak_bytes = torch.cuda.max_memory_allocated()
        text = buf.getvalue()
        sys.stdout.write(text)
        with open(os.path.join(out_dir, r.row.file), "a") as f:
            f.write(text)
    if r.error is not None:
        print(f"FAILED {r.label}: {r.error}", flush=True)
        gc.collect()  # what the failed row held, before the next one
        if cuda:
            torch.cuda.empty_cache()


def sweep(scale: float = 0.02, epochs: int = 2,
          out_dir: str = "bench_results", datasets=DATASETS,
          backends=BACKENDS, device: str = "cuda") -> list[RowResult]:
    """Run every (dataset, backend, row) in the shell script's order and
    return what each did.  ``backends`` are the shell's names (keys of
    ``BACKEND_OF``)."""
    resolve_device(device)  # no card and no device="cpu": raise now
    os.makedirs(out_dir, exist_ok=True)
    unknown = sorted(set(backends) - set(BACKEND_OF))
    if unknown:
        raise ValueError(f"unknown backends {unknown}; known: "
                         f"{list(BACKEND_OF)}")
    results = []
    for d in datasets:
        results += _sweep_dataset(d, scale, epochs, out_dir, backends,
                                  device)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return results


def _sweep_dataset(d, scale, epochs, out_dir, backends,
                   device) -> list[RowResult]:
    """The rows of one dataset, loaded once (tiled for the pallas rows); a
    failed load fails each of its rows, as it would fail each of the
    shell's processes."""
    results = [RowResult(d, b, row, argv_of(row, d, b, scale, epochs,
                                            device))
               for b in backends for row in ROWS]
    t0 = time.time()
    try:
        loaded = load(d, scale=scale, device=device)
        padded = pad_features(loaded)
        if "pallas" in backends:
            pallas = run_model.parser().parse_args(argv_of(
                ROWS[0], d, "pallas", scale, epochs, device))
            graph = run_model.tile(pallas, padded).graph
            loaded, padded = (dataclasses.replace(v, graph=graph)
                              for v in (loaded, padded))
    except Exception as e:  # noqa: BLE001 - a failed load fails its rows
        traceback.print_exc()
        for r in results:
            r.error = f"loading {d}: {type(e).__name__}: {e}"
            print(f"{r.label}\nFAILED {r.label}: {r.error}", flush=True)
        return results
    views = {True: loaded, False: padded}
    print(f"loaded {loaded.name}: {loaded.num_nodes} nodes, "
          f"{loaded.graph.nnz} edges, {loaded.num_features} features, "
          f"{loaded.num_classes} classes ({time.time() - t0:.1f}s)",
          file=sys.stderr, flush=True)
    for r in results:
        print(r.label, flush=True)
        ds = views["--nopad" in r.row.flags]
        r.nodes, r.edges, r.features = (ds.num_nodes, ds.graph.nnz,
                                        ds.num_features)
        _run_row(r, ds, out_dir)
    return results


def record(r: RowResult) -> dict:
    """A row as JSON: its place, the five numbers, what it ran on."""
    res = r.result
    return dict(
        label=r.label, dataset=r.dataset, backend=r.backend,
        model=r.row.model, flags=list(r.row.flags), nodes=r.nodes,
        edges=r.edges, features=r.features, error=r.error,
        seconds=r.seconds, peak_bytes=r.peak_bytes,
        launches=r.launches, plan=r.plan,
        **({} if res is None else dict(
            train_time_avg=res.train_time_avg,
            train_time_std=res.train_time_std, test_time=res.test_time,
            train_acc=res.train_acc, test_acc=res.test_acc,
            epoch_times=res.epoch_times, losses=res.losses)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m isplib_tpu_torch.run_all")
    ap.add_argument("scale", nargs="?", type=float, default=0.02)
    ap.add_argument("epochs", nargs="?", type=int, default=2)
    ap.add_argument("--json", default=None,
                    help="write every row's record to this file")
    args = ap.parse_args(argv)
    results = sweep(args.scale, args.epochs,
                    os.environ.get("BENCH_OUT", "bench_results"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([record(r) for r in results], f, indent=1)
    failed = [r for r in results if r.error is not None]
    for r in failed:
        print(f"failed: {r.label}: {r.error}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
