#!/usr/bin/env python3
"""Time K1's plain version (``spmm_stream_plain``) on the full graph's
residual edges, in the form the port ships and in variants of it.

    python3 probe_plain.py

The graph is ``chip_smoke.py`` phase 11's reddit-full (114.8M edges) and
its v5 plan of A, whose 54.46M residual edges the plain version sums.  At
K = 32, 41, 602 and 640 it times, with CUDA events (2 calls after 1):

* ``chunked``: the plain version as shipped, over chunks of features
  within ``CHUNK_BYTES`` (4 features a chunk here), each chunk's gather
  ``x[:, chunk].index_select(0, col)`` and ``index_add_`` into the
  output's columns (a strided view);
* ``temp``: the same, ``index_add_`` into a contiguous copy of the
  output's columns, copied back;
* ``temp_xc``: as ``temp``, x's columns made contiguous before the gather;
* ``whole``: one piece, as before the chunks (K = 32 and 41 only: at K =
  602 its temporaries would take 262 GB).

Each variant's error against the float64 plain function is printed beside
its time; the card's name and power limit first.  Exits 2 without a CUDA
card.
"""

from __future__ import annotations

import os
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_plain: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from isplib_tpu_torch import graph_from_arrays
    from isplib_tpu_torch.data import gen_gcnsig_graph
    from isplib_tpu_torch.kernels import spmm_stream
    from isplib_tpu_torch.ops.reference import (_SUM_EDGE_FEATURE_BYTES,
                                                _chunks)
    from isplib_tpu_torch.sparse.tiling import auto_tile

    print(f"card: {cs.card_line()}", flush=True)
    arrays = gen_gcnsig_graph(cs.N_REAL, cs.E_REAL, cs.CLASSES, cs.FEATURES,
                              cs.SEED, cs.EDGE_MULTIPLE, native_stream=True)
    plan = auto_tile(graph_from_arrays(arrays, "cuda")).fwd
    del arrays
    rows = torch.repeat_interleave(
        torch.arange(plan.num_rows, device="cuda"),
        plan.res_rowptr.diff().long())
    col, val = plan.res_col, plan.res_val[:, None]

    def chunks(x):
        return _chunks(col.shape[0], x.shape[1], _SUM_EDGE_FEATURE_BYTES,
                       x.element_size())

    def chunked(x, out):
        spmm_stream.spmm_stream_plain(plan, x, out)

    def temp(x, out, contiguous_x=False):
        for f in chunks(x):
            xs = x[:, f].contiguous() if contiguous_x else x[:, f]
            part = out[:, f].contiguous()
            part.index_add_(0, rows, val * xs.index_select(0, col))
            out[:, f] = part

    def whole(x, out):
        out.index_add_(0, rows, val * x.index_select(0, col))

    variants = (("chunked", chunked), ("temp", temp),
                ("temp_xc", lambda x, out: temp(x, out, True)),
                ("whole", whole))
    for k in (32, 41, 602, 640):
        x = torch.randn(plan.num_cols, k, device="cuda")
        exact = spmm_stream.spmm_stream_oracle(
            plan, x, torch.zeros(plan.num_rows, k, device="cuda"))
        print(f"K={k}: {len(chunks(x))} chunks", flush=True)
        for name, fn in variants:
            if name == "whole" and k > 41:
                continue
            out = torch.zeros(plan.num_rows, k, device="cuda")
            fn(x, out)
            err = float((out.double() - exact).abs().max())
            ms = cs.cuda_ms(lambda: fn(x, out), iters=2, warmup=1)
            print(f"K={k} {name}: {ms:.1f} ms, err {err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
