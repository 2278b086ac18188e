"""tpu3dlm_torch.utils — see the package docstring."""
