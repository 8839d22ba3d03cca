"""Seconds from the start of the run's process (the top of run.py, before
torch is imported) to the first timed step: imports, the CUDA context,
loading or building the kernels' libraries and the plan, the warm-up."""


def read(r):
    return r.setup_s
