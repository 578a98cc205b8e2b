"""Weights across packages: the JAX package's trees to the port's state_dicts
(``from_jax``), and the reference's ``model.pt`` in and out (``torch_io``)."""
