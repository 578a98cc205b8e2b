"""Weight carry-over from the JAX package's trees to the port's state_dicts."""
