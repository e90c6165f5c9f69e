"""The paper's experiments on the port: Table 2 (``tree_scan``), Fig. 4
(``gups``), Fig. 3 (``stack``) and Fig. 5 (``end2end``: paged vs
contiguous decode), counterparts of the reference's
``benchmarks/bench_tree_scan.py``, ``bench_gups.py``, ``bench_stack.py``
and ``bench_end2end.py``.  Each prints ``name,us,derived`` rows under the
reference's row names and runs as ``python -m repro_torch.bench.<name>``
(on the card by default; ``--device cpu`` runs the plain versions).
``serve`` is the reference's ``benchmarks/bench_serve.py`` on the port's
engine, with its probes, gates and ``BENCH_*.json`` reports."""
