"""Networks of the port (generator side): mapping, synthesis, STN and the
ensemble that composes them."""
