"""The H100 benchmark of ``bigdl_tpu_torch``: see ``h100_bench/run.py``."""
