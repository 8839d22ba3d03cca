"""lilac_tpu_torch: the PyTorch / CUDA port of lilac_tpu.

Same sub-package and module names as the JAX package so a reader finds
each counterpart (ops/dfloat.py, solvers/cg.py, kernels/routed.py, ...).
The port imports torch and numpy only. Every constructor and entry point
takes an explicit ``device`` argument whose default is "cuda"; the CPU
tests pass ``device="cpu"``.

The hand-written Hopper kernels live under csrc/ and are compiled at
first use (kernels/_cuda.py); each has a plain PyTorch version beside
its wrapper, which is what a CPU tensor gets.
"""

__version__ = "0.1.0"
