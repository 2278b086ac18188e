"""tpu3dlm_torch.scripts — the port's probes, run as modules
(``python -m tpu3dlm_torch.scripts.<name>``)."""
