"""Networks of the port: mapping, synthesis, STN, discriminator and the
ensemble that composes them."""
