"""Part of the benchmark of exonerate_tpu_torch (see ../harness.py)."""
