"""One GAT training epoch, counted from the configuration's equations (see
``reference/gat.py``) and the graph: its aggregations, its operations,
and the least time each role of the attention could take.

The attention runs over nnz = edges + nodes entries (a self loop a node;
the graph's law has none of its own).  A layer of H heads at K = H·C
features has three passes over them, one a span role of the port:

* ``fwd``: the softmax (exp, max and sum at the fp32 rate) and the weighted
  sum Σ α x;
* ``bwd_x``: the transposed weighted sum Σ α g, x's gradient;
* ``bwd_e``: the per-entry products ⟨g, x⟩, the softmax's and the
  LeakyReLU's backward and the scores' gradients.

Each pass moves at least 4·nnz + 4·(rows + 1) bytes of structure, 4·nnz·H
of logits or α (written by the forward, read by each backward), and
4·(rows + cols)·K of features (each row read or written once; the gathers
that read a row once an entry are the kernels' choice, not the work's).
Its weighted sum or products count 2·nnz·K at the bf16 tensor-core peak,
as ``bound.py``'s kind ``sum``; its softmax work 4·nnz·H at the fp32 rate.
A pass takes at least the larger of its bytes over the bandwidth and its
operations over their rates.

``aggregations`` hands ``spmm_roofline_pct`` the weighted sums alone, each
layer's forward and transposed pass, as kind ``sum``: that count holds no
α bytes, no per-entry products and no softmax, so that metric reads low
for GAT; the roles' bounds (``role_bound_s``) count all of them.

A dense product (m × k) · (k × n) counts 2·m·k·n in the forward pass and
for each gradient training needs (none for the input features); the
scores, ELU, skip, bias, log-softmax and Adam are not counted.
"""

from __future__ import annotations

ROLES = ("fwd", "bwd_x", "bwd_e")


def _nnz(graph: dict) -> int:
    if graph["law"]["self_loops"]:
        raise ValueError("gat's count assumes a graph without self loops")
    return graph["edges"] + graph["nodes"]


def _layers(cfg: dict, graph: dict) -> list[tuple[int, int, int]]:
    """(fan in, heads, K) of each layer."""
    c, (h1, h2, h3) = cfg["hidden"], cfg["heads"]
    return [(graph["features"], h1, h1 * c), (h1 * c, h2, h2 * c),
            (h2 * c, h3, h3 * graph["classes"])]


def aggregations(cfg: dict, graph: dict) -> list[dict]:
    n, nnz = graph["nodes"], _nnz(graph)
    out = []
    for i, (_, _, k) in enumerate(_layers(cfg, graph), 1):
        out += [dict(name=f"{d}.layer{i}", kind="sum", rows=n, cols=n,
                     nnz=nnz, k=k) for d in ("A", "At")]
    return out


def role_passes(cfg: dict, graph: dict, role: str) -> list[dict]:
    """The role's passes, one a layer: ``bytes``, ``mm_ops`` (at the bf16
    tensor-core peak) and ``fp32_ops``."""
    if role not in ROLES:
        raise ValueError(f"unknown role {role!r}")
    n, nnz = graph["nodes"], _nnz(graph)
    out = []
    for _, h, k in _layers(cfg, graph):
        out.append(dict(
            bytes=4 * nnz + 4 * (n + 1) + 4 * nnz * h + 4 * (n + n) * k,
            mm_ops=2 * nnz * k,
            fp32_ops=0 if role == "bwd_x" else 4 * nnz * h))
    return out


def role_bound_s(cfg: dict, graph: dict, role: str, peak: dict) -> float:
    """The least seconds the role's passes of one epoch could take."""
    return sum(max(p["bytes"] / peak["hbm_bytes_per_s"],
                   p["mm_ops"] / peak["bf16_tensor_flops_per_s"]
                   + p["fp32_ops"] / peak["fp32_ops_per_s"])
               for p in role_passes(cfg, graph, role))


def model_flops(cfg: dict, graph: dict) -> int:
    n, nnz = graph["nodes"], _nnz(graph)
    dense = 0
    for i, (fan_in, _, k) in enumerate(_layers(cfg, graph)):
        # x W, W's gradient, and x's gradient past the first layer
        dense += 2 * n * fan_in * k * (2 if i == 0 else 3)
    # the forward's weighted sum, the transposed sum and the products
    att = sum(3 * 2 * nnz * k for _, _, k in _layers(cfg, graph))
    return dense + att
