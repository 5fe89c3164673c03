"""Data parallelism of the port: one process per card, joined by a
``torch.distributed`` process group."""
