"""tpu3dlm_torch.pipeline — see the package docstring."""
