from lilac_tpu_torch.workloads import npb_cg  # noqa: F401
