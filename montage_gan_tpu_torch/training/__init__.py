"""Training of the port: the ADA augment pipe, the local-phase losses and the
trainer that runs the local-GAN step."""
