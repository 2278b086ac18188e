"""`python -m tpu3dlm_torch` — alias for the CLI entry (tpu3dlm_torch.cli)."""

from tpu3dlm_torch.cli import main

if __name__ == "__main__":
    main()
