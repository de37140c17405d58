"""Command-line entry points of the port (``python -m realsensetracker_tpu_torch.cli.<name>``)."""
