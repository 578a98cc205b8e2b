"""Tensor ops of the port: the audio frontend and the CUDA kernel wrappers."""
