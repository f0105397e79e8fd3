"""The upper readings of a cell's limits: the reference put in the
program's place, in the precision below the configuration's (its
``control``) and with each fault a training cell can have, against the
reference in the configuration's own.

    python3 gnnbench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed and case on standard output, with the three numbers
of ``check.py``.  The cases:

* ``control``: the configuration's ``control`` precision;
* ``unchanged``: a step that returns its state unchanged;
* ``half_batch``: the loss over every other training node;
* ``lane``: one feature of every aggregation's output left at zero.

The benchmark's runs do not run this; it imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gnnbench import check, gen, spec  # noqa: E402
from gnnbench.reference.plain import Precision, follow  # noqa: E402

CASES = ("control", "unchanged", "half_batch", "lane")
STEPS = 3


def readings(cell_name: str, seed: int, device,
             graph_override: dict | None = None) -> dict:
    """Each case's numbers on one seed's inputs."""
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    graph = {**spec.graph(cell["traffic"]), **(graph_override or {})}
    ref = spec.module("reference", cell["config"])
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = gen.make_inputs(graph, ref.parameters(cfg, graph["features"],
                                                   graph["classes"]),
                             seed, device)
    model = ref.Model(inputs.edge_index, graph["nodes"], inputs.x, inputs.y,
                      cfg)
    base = follow(model, inputs.params, cfg, inputs.train, STEPS, seed + 1)
    out = {}
    for case in CASES:
        if case == "control":
            run = follow(model, inputs.params, cfg, inputs.train, STEPS,
                         seed + 1, Precision(**cfg["control"]))
        else:
            run = follow(model, inputs.params, cfg, inputs.train, STEPS,
                         seed + 1, fault=case)
        out[case] = check.gaps(run, base, inputs.params)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for case, g in readings(args.workload, seed, device).items():
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  case=case, **g)), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
