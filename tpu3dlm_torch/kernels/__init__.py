"""tpu3dlm_torch.kernels — see the package docstring."""
