"""Run one cell of ``BENCHMARK.json``: full-batch GNN training of the port.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up follows the port's public path: the inputs made on the card from the
seed (``gen.py``); ``sparse.graph.from_edge_index``; the configuration's
transform (``nn.gcn_norm`` for GCN); ``sparse.tiling.auto_tile`` at the
feature width; the model of ``nn.models`` with the seed's parameters;
``train.make_train_step`` with Adam; one warm-up epoch, after which the
parameters and the optimizer state are restored; then the first
``CHECKED_STEPS`` steps of the same step object, which the reference
follows afterwards.  The window launches further epochs of that object
until ``--seconds`` have passed, with a CUDA event at each epoch boundary
and no synchronise until its end.  With ``--trace 1`` the last
``TRACE_SECONDS`` of the window run under the profiler, and the line holds
the per-layer metrics instead of the end-to-end ones.

After the window: the peak memory is read, the program's state freed, and
the reference (``reference/<config>.py``) follows the checked steps from
the same inputs; ``check.py`` decides ``correct``.  The last line of
standard output is the result; the numbers compared, each with its limit,
end standard error and the line.  Exits 2 without a card (or fewer than
the cell asks for), 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gnnbench import check, gen, spec, trace  # noqa: E402
from gnnbench.reference.plain import follow  # noqa: E402

CHECKED_STEPS = 3
TRACE_SECONDS = 2.0
CACHE = ROOT / ".gnnbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "isplib_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def fix_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port's nvcc and g++ libraries live in its own ``_build/``; the tune
    cache is pointed at a file nothing writes, so ``auto_tile`` takes its
    occupancy rule whatever a user tuned."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["ISPLIB_TPU_TORCH_CACHE_DIR"] = str(CACHE / "plans")
    os.environ["ISPLIB_TPU_TORCH_TUNE_CACHE"] = str(CACHE / "tune.json")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers (``metrics/<name>.py``) read."""

    config: dict
    graph: dict
    counts: object
    peak: dict | None
    summary: trace.Summary | None
    spans: dict


class Clock:
    """Epoch boundaries: CUDA events on a card, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(dev, fn, /, *args, **kwargs):
    """``fn``'s result and its host seconds, to a synchronise."""
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    sync(dev)
    return out, time.perf_counter() - t


def peak_gib(device: torch.device) -> float:
    return (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else 0.0)


def gradient_as_adam_got_it(opt, params: dict, b1: float) -> dict:
    """The gradient of Adam's first step, from its state: ``exp_avg`` /
    (1 − β1); zero for a parameter without state (a step that left the
    state unchanged)."""
    return {k: (opt.state[p]["exp_avg"] / (1.0 - b1)
                if "exp_avg" in opt.state[p] else torch.zeros_like(p))
            .detach().clone() for k, p in params.items()}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def build_program(device: torch.device) -> None:
    """Compile (first run in a checkout) or load the port's libraries."""
    if device.type == "cuda":
        from isplib_tpu_torch.kernels import build as kbuild
        from isplib_tpu_torch.native import build as nbuild
        kbuild.build_all()
        nbuild.build()


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, graph_override: dict | None = None
             ) -> dict:
    """One run of a cell; the result line as a dict.  ``graph_override``
    replaces keys of the graph's file (a cut size for tests on the CPU)."""
    from isplib_tpu_torch import nn as pnn
    from isplib_tpu_torch.nn import models
    from isplib_tpu_torch.sparse.graph import from_edge_index
    from isplib_tpu_torch.sparse.tiling import auto_tile
    from isplib_tpu_torch.train import make_train_step

    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    graph = {**spec.graph(cell["traffic"]), **(graph_override or {})}
    limits = spec.limits(cell_name)
    ref = spec.module("reference", cell["config"])
    counts = spec.module("counts", cell["config"])
    n, f, c = graph["nodes"], graph["features"], graph["classes"]
    spans = {"start_s": time.perf_counter() - T_START}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, spans["build_s"] = timed(device, build_program, device)

    inputs, spans["gen_s"] = timed(device, gen.make_inputs, graph,
                                   ref.parameters(cfg, f, c), seed, device)
    log(f"gen_s {spans['gen_s']!r} (inputs made on the {device.type} from "
        f"seed {seed}: {n} nodes, {inputs.edge_index.shape[1]} edges)")
    edges_host, spans["to_host_s"] = timed(
        device, lambda e: e.cpu().numpy(), inputs.edge_index)
    inputs.edge_index = None

    g, spans["graph_build_s"] = timed(device, from_edge_index, edges_host,
                                      num_nodes=n, device=device)
    if cfg["transform"]:
        g, spans["norm_build_s"] = timed(
            device, getattr(pnn, cfg["transform"]), g)
    peaks = {"graph": peak_gib(device)}
    tiled, spans["plan_build_s"] = timed(device, auto_tile, g, k=f)
    peaks["plans"] = peak_gib(device)
    del g

    model = getattr(models, cfg["model"])(
        in_features=f, num_classes=c, device=device, **cfg["model_args"])
    model.load_state_dict(inputs.params)
    opt_cfg = cfg["optimizer"]
    opt = torch.optim.Adam(model.parameters(), lr=opt_cfg["lr"],
                           betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"],
                           weight_decay=opt_cfg["weight_decay"])
    step = make_train_step(model, opt, tiled, loss=cfg["loss"])
    x, y, train = inputs.x, inputs.y, inputs.train

    t = time.perf_counter()
    init_model = copy.deepcopy(model.state_dict())
    init_opt = copy.deepcopy(opt.state_dict())
    step(x, y, train, torch.Generator(device=device).manual_seed(seed + 2))
    sync(device)
    model.load_state_dict(init_model)
    opt.load_state_dict(init_opt)
    spans["warmup_s"] = time.perf_counter() - t
    peaks["warmup"] = peak_gib(device)

    t = time.perf_counter()
    # the checked steps, through the window's own call and feed
    params = dict(model.named_parameters())
    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1)
    checked_losses, first_grad = [], None
    for _ in range(CHECKED_STEPS):
        lval, _ = step(x, y, train, dropout_gen)
        checked_losses.append(lval)
        if first_grad is None:
            first_grad = gradient_as_adam_got_it(opt, params,
                                                 opt_cfg["betas"][0])
    after = {k: p.detach().clone() for k, p in params.items()}
    sync(device)
    spans["checked_s"] = time.perf_counter() - t

    # the window
    clock = Clock(device)
    losses, summary = [], None

    def epochs_until(deadline: float) -> int:
        count = 0
        while True:
            lval, _ = step(x, y, train, dropout_gen)
            losses.append(lval)
            clock.mark()
            count += 1
            if time.perf_counter() >= deadline:
                return count

    setup_s = time.perf_counter() - T_START
    t0 = time.perf_counter()
    clock.mark()
    if not traced:
        epochs_until(t0 + seconds)
        sync(device)
    else:
        epochs_until(t0 + max(seconds - TRACE_SECONDS, 0.0))
        sync(device)
        held = {}
        prof = trace.capture(
            lambda: held.update(n=epochs_until(
                time.perf_counter() + TRACE_SECONDS)), device)
    window_s = time.perf_counter() - t0
    epochs = len(losses)
    peak_bytes = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                  else 0)
    if traced:
        summary = trace.summarize(prof, held["n"], spec.attribution())
        del prof
    epoch_ms = clock.intervals_ms()
    finite = torch.isfinite(torch.stack(losses))
    failed = int((~finite).sum())
    program = dict(losses=[float(v) for v in checked_losses],
                   first_grad=first_grad, params=after)
    log(f"setup_s {setup_s!r} ({json.dumps(spans)}; peak GiB after "
        f"{json.dumps(peaks)})")
    log(f"window_s {window_s!r}, {epochs} epochs, {failed} non-finite "
        f"losses, peak {peak_bytes} bytes")
    if device.type == "cuda":
        log("card:", card_line(), "| torch", torch.__version__,
            torch.version.cuda)

    # the program's state goes before the reference runs
    del step, opt, model, tiled, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    edge_index = torch.from_numpy(edges_host).to(device)
    plain = ref.Model(edge_index, n, x, y, cfg)
    reference = follow(plain, inputs.params, cfg, train, CHECKED_STEPS,
                       seed + 1)
    del plain, edge_index
    gaps = check.gaps(program, reference, inputs.params)
    correct = check.judge(gaps, limits) and failed == 0
    log(f"reference_s {time.perf_counter() - t!r}")

    result = {"correct": correct, "attempted": epochs, "failed": failed}
    if not traced:
        values = dict(
            epoch_ms=1e3 * window_s / epochs,
            epoch_p95_ms=float(np.percentile(epoch_ms, 95)),
            peak_mem_gib=peak_bytes / 2**30,
            setup_s=setup_s)
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.metrics_of(bench, "end_to_end", cell_name)}
    else:
        kind = (torch.cuda.get_device_name() if device.type == "cuda"
                else None)
        run = RunRecord(cfg, graph, counts, spec.peaks().get(kind),
                        summary, spans)
        result["metrics"] = {}
        for m in spec.metrics_of(bench, "per_layer", cell_name):
            v = spec.module("metrics", m["name"]).read(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
    result["device"] = device_record(device, cell, peak_bytes, summary)
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    for line in check.lines(gaps, limits):
        log(line)
    result["checks"] = check.record(gaps, limits)
    return result


def device_record(device, cell, peak_bytes, summary) -> dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name() if device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak_bytes)}
    if summary is not None:
        rec["busy_s"] = summary.busy_s
        rec["window_s"] = summary.window_s
    return rec


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str | None = None,
         graph_override: dict | None = None) -> int:
    """The command line.  ``device`` other than None skips the look for a
    card (tests drive a cut run on the CPU that way)."""
    args = parse(argv)
    if device is None:
        chips = spec.cell(spec.benchmark(), args.workload)["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"no result: the cell needs {chips} CUDA card(s), "
                f"{torch.cuda.device_count()} found")
            return 2
        device = "cuda"
    fix_caches()
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device(device),
                          graph_override)
    found = forbidden_modules()
    if found:
        log(f"no result: {found} loaded in the process")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
