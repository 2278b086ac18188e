"""tpu3dlm_torch.mapper — see the package docstring."""
