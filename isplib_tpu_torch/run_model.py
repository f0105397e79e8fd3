"""Benchmark CLI, the counterpart of the JAX package's ``scripts/run_model.py``.

    python -m isplib_tpu_torch.run_model sage reddit --aggr max \\
        [auto|reference|pt1] [--epochs N] [--embedding 32] [--scale S] \\
        [--seed 0] [--nopad] [--tiling auto|v5|RB,CT,EB] [--device cuda]

``auto`` trains through the kernels; ``reference`` through the plain
PyTorch SpMM; ``pt1`` trains the plain-torch baseline
(``interop.torch_baseline``: ``torch.sparse.mm``, the reference's comparison
column; under ``iSpLibPlugin.patch_pyg`` it runs on the port's kernels).
Prints the reference's TRG_TM / TRG_STD / TST_TM / TRG_ACC / TST_ACC table
and a CSV line of the same five numbers.

``--tiling`` picks the plans of the ``auto`` backend, as a dict of the
loaders' ``tiling=`` keys that ``build_tiling`` applies once the features
are padded: ``auto`` (the default) lets
``train_node_classifier`` call ``auto_tile`` at the feature width (a graph
of fewer than ``AUTO_TILE_MIN_NNZ`` edges, or one on the CPU, then stays on
the reference path); ``v5`` is version 5 at dense threshold 128;
``RB,CT,EB`` is a version 2 plan of that geometry, its superblocks sized
for the feature width.  The JAX CLI's default is its ``v5``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

__all__ = ["main", "parser", "load_dataset", "run_one", "tile",
           "tiling_config"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m isplib_tpu_torch.run_model")
    ap.add_argument("model", choices=["gcn", "sage", "gin"])
    ap.add_argument("dataset")
    ap.add_argument("backend", nargs="?", default="auto",
                    choices=["auto", "reference", "pt1"])
    ap.add_argument("--aggr", default="sum",
                    choices=["sum", "mean", "max", "min"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--embedding", type=int, default=32)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nopad", action="store_true",
                    help="skip padding the features to a multiple of 128")
    ap.add_argument("--tiling", default="auto",
                    help="plans of the auto backend: 'auto' (auto_tile at "
                         "the feature width), 'v5' (version 5 at threshold "
                         "128) or RB,CT,EB (version 2)")
    ap.add_argument("--device", default="cuda")
    return ap


def tiling_config(spec: str, k: int) -> dict | None:
    """``--tiling`` as the loaders' ``tiling=`` dict (``build_tiling``'s
    keys): None for ``auto``, version 5 at threshold 128 for ``v5``, and
    for ``RB,CT,EB`` version 2 of that geometry at the feature width
    ``k``."""
    if spec == "auto":
        return None
    if spec == "v5":
        return dict(version=5, dense_threshold=128)
    try:
        rb, ct, eb = (int(v) for v in spec.split(","))
    except ValueError:
        raise ValueError(f"--tiling takes auto, v5 or RB,CT,EB; got "
                         f"{spec!r}") from None
    return dict(version=2, rb=rb, ct=ct, eb=eb, k=k)


def tile(args: argparse.Namespace, ds):
    """``ds`` with its graph tiled as ``--tiling`` says at its feature
    width, for the ``auto`` backend; any other backend's ``ds`` as it
    is."""
    from .sparse.tiling import build_tiling

    cfg = (tiling_config(args.tiling, ds.num_features)
           if args.backend == "auto" else None)
    if cfg is None:
        return ds
    return dataclasses.replace(ds, graph=build_tiling(ds.graph, **cfg))


def load_dataset(args: argparse.Namespace):
    """``args.dataset`` loaded onto ``args.device``, its features padded
    unless ``--nopad``, then tiled (``tile``)."""
    from .data import load, pad_features

    ds = load(args.dataset, scale=args.scale, device=args.device)
    return tile(args, ds if args.nopad else pad_features(ds))


def run_one(args: argparse.Namespace, ds):
    """Train ``args.model`` on the loaded ``ds`` with ``args.backend`` and
    print the banner, the table and the CSV line; returns the
    ``TrainResult``."""
    from .interop.torch_baseline import train_torch_baseline
    from .nn import MODEL_REGISTRY
    from .train import train_node_classifier

    print(f"Running {args.model.upper()}, Epoch: {args.epochs}, "
          f"Embedding: {args.embedding}, Dataset: {args.dataset}, "
          f"Mode: {args.backend}")
    if args.backend == "pt1":
        res = train_torch_baseline(args.model, ds, epochs=args.epochs,
                                   hidden=args.embedding, aggr=args.aggr,
                                   seed=args.seed, device=args.device)
    else:
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
    return res


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    t0 = time.time()
    ds = load_dataset(args)
    print(f"loaded {ds.name}: {ds.num_nodes} nodes, {ds.graph.nnz} edges, "
          f"{ds.num_features} features, {ds.num_classes} classes "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)
    run_one(args, ds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
