"""tpu3dlm_torch.ops.kernels — see the package docstring."""
