"""Training data of the port: the in-memory synthetic layer batches."""
