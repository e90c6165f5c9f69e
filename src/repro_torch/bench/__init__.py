"""The paper's experiments on the port: Table 2 (``tree_scan``), Fig. 4
(``gups``) and Fig. 3 (``stack``), counterparts of the reference's
``benchmarks/bench_tree_scan.py``, ``bench_gups.py`` and
``bench_stack.py``.  Each prints ``name,us,derived`` rows under the
reference's row names and runs as ``python -m repro_torch.bench.<name>``
(on the card by default; ``--device cpu`` runs the plain versions)."""
