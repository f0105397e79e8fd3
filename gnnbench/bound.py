"""The yardstick of the aggregations: the least time one could take on the
card, counted from the graph and the configuration's equations, never
from a plan, so that it is the same work whatever implements it.

An aggregation ``dict(kind, rows, cols, nnz, k)`` over ``rows × cols`` with
``nnz`` entries at width ``k`` moves at least 4·nnz + 4·(rows + 1) bytes of
structure (one int32 column index an entry and the row pointers; no edge
values, since the configurations derive theirs from the structure) plus
4·cols·k read and 4·rows·k written.  A structure stored in under 4 bytes
an entry would need this count revised.  Operations:

* ``sum``: 2·nnz·k at the bf16 tensor-core peak;
* ``max``: nnz·k comparisons at the fp32 issue rate;
* ``route`` (a max's gradient sent to the winners): no structure; rows·k
  cotangents and winners read, cols·k written; rows·k adds.
"""

from __future__ import annotations


def aggregation_bytes(a: dict) -> int:
    if a["kind"] == "route":
        return 8 * a["rows"] * a["k"] + 4 * a["cols"] * a["k"]
    return (4 * a["nnz"] + 4 * (a["rows"] + 1) + 4 * a["cols"] * a["k"]
            + 4 * a["rows"] * a["k"])


def aggregation_ops(a: dict) -> tuple[int, str]:
    """Operations and the peak they run at (a key of a peaks entry)."""
    if a["kind"] == "sum":
        return 2 * a["nnz"] * a["k"], "bf16_tensor_flops_per_s"
    if a["kind"] == "max":
        return a["nnz"] * a["k"], "fp32_ops_per_s"
    if a["kind"] == "route":
        return a["rows"] * a["k"], "fp32_ops_per_s"
    raise ValueError(f"unknown aggregation kind {a['kind']!r}")


def aggregation_bound_s(a: dict, peak: dict) -> float:
    ops, rate = aggregation_ops(a)
    return max(aggregation_bytes(a) / peak["hbm_bytes_per_s"],
               ops / peak[rate])
