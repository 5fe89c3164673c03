"""Training data of the port: the layer dataset, its sampler, and synthetic
layers."""
