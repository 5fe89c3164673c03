"""Command-line entry points of the port (``python -m
montage_gan_tpu_torch.cli.<name>``)."""
