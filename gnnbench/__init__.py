"""The benchmark of ``isplib_tpu_torch``: full-batch GNN training on one card.

``python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, graph, cell or per-layer metric sits in files of its own that
the harness finds by name (``configs/``, ``reference/``, ``counts/``,
``graphs/``, ``limits/``, ``metrics/``, ``attribution/``).  Nothing here
imports the JAX package; ``reference/`` and ``gen.py`` import nothing of the
port either.
"""
