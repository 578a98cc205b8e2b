"""Training of the port: configuration, optimizers, steps and epoch runners."""
