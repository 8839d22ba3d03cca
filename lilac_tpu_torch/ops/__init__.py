from lilac_tpu_torch.ops import dfloat  # noqa: F401
