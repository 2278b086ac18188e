"""tpu3dlm_torch.parallel — see the package docstring."""
