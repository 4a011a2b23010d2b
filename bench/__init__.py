"""The benchmark of ``repro_torch``: one cell a run, driven by
``BENCHMARK.json`` and the data files under this folder (``run.py``)."""
