"""tpu3dlm_torch.models — see the package docstring."""
