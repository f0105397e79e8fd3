"""Benchmark CLI, the counterpart of the JAX package's ``scripts/run_model.py``.

    python -m isplib_tpu_torch.run_model sage reddit --aggr max \\
        [auto|reference] [--epochs N] [--embedding 32] [--scale S] \\
        [--seed 0] [--nopad] [--device cuda]

``auto`` trains through the kernels (a large graph is tiled on CUDA);
``reference`` through the plain PyTorch SpMM.  Prints the reference's
TRG_TM / TRG_STD / TST_TM / TRG_ACC / TST_ACC table and a CSV line of the
same five numbers.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m isplib_tpu_torch.run_model")
    ap.add_argument("model", choices=["gcn", "sage", "gin"])
    ap.add_argument("dataset")
    ap.add_argument("backend", nargs="?", default="auto",
                    choices=["auto", "reference"])
    ap.add_argument("--aggr", default="sum",
                    choices=["sum", "mean", "max", "min"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--embedding", type=int, default=32)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nopad", action="store_true",
                    help="skip padding the features to a multiple of 128")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"Running {args.model.upper()}, Epoch: {args.epochs}, "
          f"Embedding: {args.embedding}, Dataset: {args.dataset}, "
          f"Mode: {args.backend}")

    from .data import load, pad_features
    from .nn import MODEL_REGISTRY
    from .train import train_node_classifier

    t0 = time.time()
    ds = load(args.dataset, scale=args.scale, device=args.device)
    if not args.nopad:
        ds = pad_features(ds)
    print(f"loaded {ds.name}: {ds.num_nodes} nodes, {ds.graph.nnz} edges, "
          f"{ds.num_features} features, {ds.num_classes} classes "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)

    kwargs = dict(hidden=args.embedding, num_classes=ds.num_classes,
                  device=args.device, seed=args.seed)
    if args.model == "sage":
        kwargs["aggr"] = args.aggr
    model = MODEL_REGISTRY[args.model](ds.num_features, **kwargs)
    res = train_node_classifier(model, ds, epochs=args.epochs,
                                seed=args.seed, device=args.device,
                                tile=args.backend == "auto")
    print()
    print(res.table())
    print()
    print(f"{res.train_time_avg:.4},{res.train_time_std:.4},"
          f"{res.test_time:.4},{res.train_acc:.4},{res.test_acc:.4}")
    print("---")
    return 0


if __name__ == "__main__":
    sys.exit(main())
