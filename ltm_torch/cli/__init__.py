"""Command-line entry points of the port (``python -m ltm_torch.cli.<name>``)."""
