"""Kernels of the port: the routed-network applier and the fused df64
multiply-reduce (hand-written CUDA, csrc/), the operators built on them,
and the gather operator on plain torch indexing."""
