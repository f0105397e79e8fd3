"""The port's sweep (``python -m isplib_tpu_torch.run_all``) against the JAX
system's ``scripts/run_all.sh``, and ``run_model --tiling``, on the CPU.

* the sweep's plan (datasets, backends through their mapping, the four
  model rows with their flags, banners and files, the defaults) is the
  shell script's, parsed from the script itself;
* ``sweep`` at a tiny scale writes the four files, one CSV row per backend,
  and goes on past a row that raises; ``main`` then exits 1;
* ``get_padding_size`` and ``pad_features(multiple=)`` equal the JAX
  package's on the same arrays;
* ``--tiling RB,CT,EB`` gives the version 2 plans of ``build_tiling`` at the
  feature width, ``--tiling v5`` version 5 at threshold 128, and ``auto``
  (no plans until ``train_node_classifier`` tiles) is the default, where
  the JAX CLI's is ``v5``.
"""

import dataclasses
import functools
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from isplib_tpu.data.loaders import get_padding_size as jax_padding_size
from isplib_tpu.data.loaders import pad_features as jax_pad_features
from isplib_tpu.data.synthetic import NodeDataset as JaxNodeDataset
from isplib_tpu_torch import run_all, run_model
from isplib_tpu_torch.data import (NodeDataset, get_padding_size, load,
                                   pad_features)
from isplib_tpu_torch.sparse.graph import CSRGraph
from isplib_tpu_torch.sparse.tiling import TiledGraph, build_tiling
from isplib_tpu_torch.sparse.tiling_v2 import TiledPlanV2
from isplib_tpu_torch.sparse.tiling_v5 import HybridPlan

ROOT = Path(__file__).resolve().parent.parent
SHELL = (ROOT / "scripts" / "run_all.sh").read_text()
JAX_CLI = (ROOT / "scripts" / "run_model.py").read_text()
TINY = 0.0005          # mag at this scale: 368 nodes, ~5.4k edges


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads, which the native graph and plan build also
    takes, while this module runs: the suite runs several test files at
    once, one a worker, and a wall-clock test may run beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the sweep's plan is the shell script's
# ---------------------------------------------------------------------------

def shell_rows():
    """(banner, model, flags, file) of each ``run_model`` line of the shell
    script, its banner the ``echo`` just before it."""
    rows = []
    lines = SHELL.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r'python scripts/run_model\.py (\w+)\s+"\$d" "\$b"'
                      r'(.*?) --scale "\$SCALE" --epochs "\$EPOCHS" \| '
                      r'tee -a "\$OUT_DIR/([\w.-]+)"', ln)
        if m:
            echo = re.search(r'echo "(.*)"', lines[i - 1]).group(1)
            rows.append((echo.replace("$d", "{d}").replace("$b", "{b}"),
                         m.group(1), tuple(m.group(2).split()), m.group(3)))
    return rows


def shell_default(pattern: str) -> str:
    return re.search(pattern, SHELL).group(1)


def test_sweep_plan_is_the_shell_scripts():
    assert run_all.DATASETS == tuple(
        shell_default(r'datasets="([^"]*)"').split())
    assert run_all.BACKENDS == tuple(
        shell_default(r'backends="([^"]*)"').split())
    rows = shell_rows()
    assert len(rows) == 4
    assert [(r.banner, r.model, r.flags, r.file) for r in run_all.ROWS] == rows
    # the positional and environment defaults
    sig = inspect.signature(run_all.sweep).parameters
    assert sig["scale"].default == float(shell_default(r'SCALE="\$\{1:-([^}]*)\}"'))
    assert sig["epochs"].default == int(shell_default(r'EPOCHS="\$\{2:-([^}]*)\}"'))
    assert sig["out_dir"].default == shell_default(
        r'OUT_DIR="\$\{BENCH_OUT:-([^}]*)\}"')
    assert sig["datasets"].default == run_all.DATASETS
    assert sig["backends"].default == run_all.BACKENDS


def test_backends_map_to_the_ports():
    """pt1 → pt1, xla → reference, pallas → auto on the JAX CLI's default
    plan (the shell passes no --tiling), which ``tiling_config`` gives as
    the JAX CLI's v5 dict less its TPU knobs."""
    jax_default = re.search(r'add_argument\("--tiling", default="(\w+)"',
                            JAX_CLI).group(1)
    assert run_all.BACKEND_OF == {
        "pt1": ("pt1",), "xla": ("reference",),
        "pallas": ("auto", "--tiling", jax_default)}
    thr = int(re.search(r"version=5, rb=\d+, dense_threshold=(\d+)",
                        JAX_CLI).group(1))
    assert run_model.tiling_config(jax_default, 128) == dict(version=5,
                                                        dense_threshold=thr)
    for b, port in run_all.BACKEND_OF.items():
        args = run_model.parser().parse_args(
            run_all.argv_of(run_all.ROWS[2], "mag", b, 0.5, 3, "cpu"))
        assert (args.backend, args.aggr, args.nopad, args.scale,
                args.epochs, args.dataset) == (port[0], "mean", True, 0.5, 3,
                                               "mag")


# ---------------------------------------------------------------------------
# the sweep at a tiny scale
# ---------------------------------------------------------------------------

NUMBER = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?"
CSV = re.compile(rf"^{NUMBER}(?:,{NUMBER}){{4}}$")


def csv_rows(path: Path) -> list[list[float]]:
    """The CSV rows (five numbers) of a sweep file."""
    return [[float(p) for p in ln.split(",")]
            for ln in path.read_text().splitlines() if CSV.match(ln)]


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_results")
    return out, run_all.sweep(TINY, 2, str(out), datasets=("mag",),
                              device="cpu")


def test_sweep_writes_the_four_files(swept):
    out, results = swept
    assert sorted(p.name for p in out.iterdir()) == sorted(
        r.file for r in run_all.ROWS)
    assert [(r.backend, r.row) for r in results] == [
        (b, row) for b in run_all.BACKENDS for row in run_all.ROWS]
    for r in results:
        assert r.error is None
        assert np.isfinite(r.result.losses).all()
        assert (r.plan is not None) == (r.backend == "pallas")
    for row in run_all.ROWS:
        text = (out / row.file).read_text()
        rows = csv_rows(out / row.file)
        assert len(rows) == len(run_all.BACKENDS)
        assert all(np.isfinite(v).all() for v in rows)
        modes = re.findall(r"Mode: (\w+)", text)
        assert modes == ["pt1", "reference", "auto"]
        mine = [r for r in results if r.row == row]
        for r, csv in zip(mine, rows):
            res = r.result
            assert csv == pytest.approx(
                [res.train_time_avg, res.train_time_std, res.test_time,
                 res.train_acc, res.test_acc], rel=1e-3, abs=1e-12)


def test_sweep_pallas_rows_train_on_one_v5_plan(swept):
    """Every pallas row trains on the dataset's one v5 plan at 128, and the
    kernel path's accuracies are the reference path's here (the plain
    versions run on the CPU)."""
    _, results = swept
    plans = [r.plan for r in results if r.backend == "pallas"]
    assert all(p == plans[0] for p in plans)
    assert plans[0]["fwd"]["type"] == "HybridPlan"
    assert plans[0]["fwd"]["dense_threshold"] == 128
    ref = {r.row: r.result for r in results if r.backend == "xla"}
    for r in results:
        if r.backend == "pallas":
            assert abs(r.result.train_acc - ref[r.row].train_acc) <= 0.02
            assert abs(r.result.test_acc - ref[r.row].test_acc) <= 0.02


def test_sweep_goes_on_past_a_failed_row(tmp_path, monkeypatch, capsys):
    real = run_model.run_one

    def run_one(args, ds):
        if args.backend == "reference" and args.model == "gin":
            raise RuntimeError("out of memory (a test's)")
        return real(args, ds)

    monkeypatch.setattr(run_model, "run_one", run_one)
    results = run_all.sweep(TINY, 1, str(tmp_path), datasets=("mag",),
                            backends=("xla", "pallas"), device="cpu")
    failed = [r for r in results if r.error is not None]
    assert [r.label for r in failed] == ["=== GIN mag xla ==="]
    assert failed[0].result is None
    assert "RuntimeError: out of memory (a test's)" in failed[0].error
    assert all(r.result is not None for r in results if r not in failed)
    assert len(csv_rows(tmp_path / "gin.txt")) == 1      # pallas only
    assert len(csv_rows(tmp_path / "gcn.txt")) == 2
    out = capsys.readouterr().out
    assert "FAILED === GIN mag xla ===" in out
    assert out.index("=== GIN mag xla ===") < out.index("=== GCN mag pallas")

    # main lists the failed rows and exits 1
    monkeypatch.setenv("BENCH_OUT", str(tmp_path / "main"))
    monkeypatch.setattr(run_all, "sweep", functools.partial(
        run_all.sweep, datasets=("mag",), backends=("xla",), device="cpu"))
    assert run_all.main([str(TINY), "1"]) == 1
    err = capsys.readouterr().err
    assert "failed: === GIN mag xla ===" in err
    assert len(csv_rows(tmp_path / "main" / "gcn.txt")) == 1


def test_sweep_without_a_card_raises(tmp_path, monkeypatch):
    """The device defaults to cuda; without a card the sweep raises before
    it loads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_all.sweep(TINY, 1, str(tmp_path / "out"), datasets=("mag",))
    assert not (tmp_path / "out").exists()


def test_main_takes_the_shells_positional_defaults(monkeypatch):
    seen = []
    monkeypatch.delenv("BENCH_OUT", raising=False)
    monkeypatch.setattr(run_all, "sweep",
                        lambda *a, **kw: seen.append((a, kw)) or [])
    assert run_all.main([]) == 0
    assert run_all.main(["0.5"]) == 0
    assert run_all.main(["0.5", "3"]) == 0
    assert [a for a, _ in seen] == [(0.02, 2, "bench_results"),
                                    (0.5, 2, "bench_results"),
                                    (0.5, 3, "bench_results")]
    assert [kw for _, kw in seen] == [{}] * 3
    with pytest.raises(SystemExit):
        run_all.main(["1", "2", "3"])


def test_sweep_tiles_as_the_pallas_argv_says(tmp_path, monkeypatch):
    """The plan of the pallas rows comes from their argv alone: a version 2
    ``--tiling`` there gives version 2 plans at the padded width, the
    plans ``run_model.load_dataset`` builds for that row; the other rows
    share its graph and record no plan."""
    monkeypatch.setitem(run_all.BACKEND_OF, "pallas",
                        ("auto", "--tiling", "256,512,512"))
    results = run_all.sweep(TINY, 1, str(tmp_path), datasets=("mag",),
                            backends=("xla", "pallas"), device="cpu")
    assert all(r.error is None for r in results)
    assert [r.plan is not None for r in results] == [False] * 4 + [True] * 4
    assert all(r.plan["fwd"] == dict(type="TiledPlanV2")
               for r in results if r.plan is not None)
    args = run_model.parser().parse_args(results[4].argv)
    want = run_model.load_dataset(args).graph
    assert isinstance(want.fwd, TiledPlanV2)
    monkeypatch.setattr(run_model, "load_dataset", lambda a: pytest.fail(
        "the sweep loads once, not per row"))
    seen = []
    real = run_model.run_one
    monkeypatch.setattr(run_model, "run_one",
                        lambda a, ds: seen.append(ds.graph) or real(a, ds))
    run_all.sweep(TINY, 1, str(tmp_path / "again"), datasets=("mag",),
                  backends=("xla", "pallas"), device="cpu")
    assert len(seen) == 8 and all(g is seen[0] for g in seen)
    for f in ("fwd", "bwd", "fwd_mm", "bwd_mm"):
        same_plan(getattr(seen[0], f), getattr(want, f))


# ---------------------------------------------------------------------------
# get_padding_size and pad_features against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 34, 127, 128, 129, 349, 602])
@pytest.mark.parametrize("multiple", [None, 16, 128, 256])
def test_padding_equals_jax(n, multiple):
    kw = {} if multiple is None else dict(multiple=multiple)
    assert get_padding_size(n, **kw) == jax_padding_size(n, **kw)
    rng = np.random.default_rng(n)
    x = rng.normal(size=(5, n)).astype(np.float32)
    y = np.zeros(5, np.int32)
    m = np.ones(5, bool)
    got = pad_features(NodeDataset("d", None, x, y, m, m, m, 2), **kw)
    want = jax_pad_features(JaxNodeDataset("d", None, x, y, m, m, m, 2),
                            **kw)
    assert got.x.dtype == want.x.dtype
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.x is x) == (want.x is x)


# ---------------------------------------------------------------------------
# run_model --tiling
# ---------------------------------------------------------------------------

def same_plan(p, q) -> None:
    assert type(p) is type(q)
    if dataclasses.is_dataclass(p):
        for f in dataclasses.fields(p):
            same_plan(getattr(p, f.name), getattr(q, f.name))
    elif isinstance(p, torch.Tensor):
        assert p.dtype == q.dtype
        if p.dtype == torch.bfloat16:  # bit for bit
            p, q = p.view(torch.int16), q.view(torch.int16)
        assert torch.equal(p, q)
    elif isinstance(p, (list, tuple)):
        assert len(p) == len(q)
        for a, b in zip(p, q):
            same_plan(a, b)
    else:
        assert p == q


def cli(*argv):
    return run_model.parser().parse_args([*argv, "--device", "cpu"])


@pytest.mark.parametrize("dataset,nopad,width", [
    ("karate", False, 128), ("reddit-sim", False, 640),
    ("reddit-sim", True, 602)])
def test_tiling_rb_ct_eb_is_version_2_at_the_feature_width(dataset, nopad,
                                                           width):
    flags = ["--scale", "0.0002"] + (["--nopad"] if nopad else [])
    ds = run_model.load_dataset(cli("gcn", dataset, "--tiling",
                                    "256,512,512", *flags))
    assert ds.num_features == width
    assert isinstance(ds.graph, TiledGraph)
    assert isinstance(ds.graph.fwd, TiledPlanV2)
    plain = load(dataset, scale=0.0002, device="cpu")
    want = build_tiling(plain.graph, version=2, rb=256, ct=512, eb=512,
                        k=width)
    for f in ("fwd", "bwd", "fwd_mm", "bwd_mm"):
        same_plan(getattr(ds.graph, f), getattr(want, f))
    assert run_model.tiling_config("256,512,512", width) == dict(
        version=2, rb=256, ct=512, eb=512, k=width)


def test_tiling_v5_is_version_5_at_128(capsys):
    ds = run_model.load_dataset(cli("gcn", "karate", "--tiling", "v5"))
    assert isinstance(ds.graph.fwd, HybridPlan)
    assert ds.graph.fwd.dense_threshold == 128
    assert ds.graph.bwd.dense_threshold == 128
    assert run_model.main(["gcn", "karate", "--tiling", "v5", "--epochs",
                           "2", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()[-2].split(",")) == 5


def test_tiling_auto_is_the_default():
    """The port's default departs from the JAX CLI's fixed v5: the loader
    builds no plans, ``train_node_classifier`` calls ``auto_tile``.  Only
    the auto backend takes a tiling."""
    jax_default = re.search(r'add_argument\("--tiling", default="(\w+)"',
                            JAX_CLI).group(1)
    args = cli("gcn", "karate")
    assert args.tiling == "auto" != jax_default
    assert run_model.tiling_config(args.tiling, 128) is None
    assert type(run_model.load_dataset(args).graph) is CSRGraph
    for backend in ("reference", "pt1"):
        ds = run_model.load_dataset(cli("gcn", "karate", backend,
                                        "--tiling", "v5"))
        assert type(ds.graph) is CSRGraph
    for bad in ("v4", "256,512", "a,b,c"):
        with pytest.raises(ValueError):
            run_model.tiling_config(bad, 128)
