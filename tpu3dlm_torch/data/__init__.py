"""tpu3dlm_torch.data — see the package docstring."""
