"""Utilities of the port: resolution algebra, layout helpers, the weight
bridge from the JAX package, checkpoints and serving."""
