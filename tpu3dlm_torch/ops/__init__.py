"""tpu3dlm_torch.ops — see the package docstring."""
