"""The port's benchmark harness: one cell, one seed, one run
(``portbench/run.py``)."""
