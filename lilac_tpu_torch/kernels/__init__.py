"""Kernels of the port: the routed-network appliers and the fused df64
multiply-reduce (hand-written CUDA, csrc/), the operators built on them,
the dense f32 product of Parboil sgemm (csrc/gemm.cu), the gather
operators on plain torch indexing, and the registry that names them."""
