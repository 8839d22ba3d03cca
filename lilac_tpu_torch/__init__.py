"""lilac_tpu_torch: the PyTorch / CUDA port of lilac_tpu.

Same sub-package and module names as the JAX package so a reader finds
each counterpart (ops/dfloat.py, solvers/cg.py, kernels/routed.py, ...).
The port imports torch and numpy only. Every constructor and entry point
takes an explicit ``device`` argument whose default is "cuda"; the CPU
tests pass ``device="cpu"``.

The hand-written Hopper kernels live under csrc/ and are compiled at
first use (kernels/_cuda.py); each has a plain PyTorch version beside
its wrapper, which is what a CPU tensor gets. Importing the package
builds nothing: kernels/_cuda.py compiles a kernel library at its first
launch.
"""

__version__ = "0.1.0"

from lilac_tpu_torch.formats.sparse import BSR, COO, CSR, ELL  # noqa: F401
from lilac_tpu_torch.ops.spmv import spmv  # noqa: F401
from lilac_tpu_torch.plan import SpmvPlan  # noqa: F401
