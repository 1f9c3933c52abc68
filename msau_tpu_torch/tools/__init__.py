"""Command-line entry points of the port (``python -m
msau_tpu_torch.tools.<name>``)."""
