"""Plain PyTorch / NumPy reference of the benchmark's models and of the
windows they train on.

It imports neither the program (``sept_tpu_torch``) nor JAX: everything the
program derives from the shared inputs is worked out here again.
"""
