"""The benchmark of the PyTorch and CUDA port (`repro_torch`): one run of
one cell of `BENCHMARK.json` (`run.py`), the plain reference and the
comparison that decides a run's ``correct``, the yardstick's counts, and
the control readings its limits are set from (`control.py`)."""
