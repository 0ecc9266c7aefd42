"""The benchmark of vicalib_tpu_torch (see run.py)."""
