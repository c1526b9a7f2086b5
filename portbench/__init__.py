"""The benchmark of rectipy_tpu_torch: one cell a run (``portbench/run.py``)."""
