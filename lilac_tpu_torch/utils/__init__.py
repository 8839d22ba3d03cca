"""Observability (profiling.py) and checkpoint / resume (checkpoint.py);
counterpart of lilac_tpu/utils/."""
