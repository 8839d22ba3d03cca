from lilac_tpu_torch.generate import npb  # noqa: F401
