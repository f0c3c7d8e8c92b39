"""The port's benches, the torch twins of the JAX package's ``bench.py``
and ``scripts/{serve_bench,latency_table,trace_ops}.py``. Each is a module
with a ``main`` that prints one JSON line stamped with the card
(``utils/benchkit.py`` ``card_provenance``) and runs on the card unless
asked for the CPU (``--device cpu``: a rehearsal whose device metrics are
null); a failure prints a line with ``error`` and exits non-zero."""
