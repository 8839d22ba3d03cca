from lilac_tpu_torch.solvers.algebra import FloatAlg, DF64Alg, get_algebra  # noqa: F401
from lilac_tpu_torch.solvers.cg import npb_conj_grad, npb_power_method  # noqa: F401
