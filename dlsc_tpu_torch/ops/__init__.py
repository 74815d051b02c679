"""Ops of the port: the plain mel front-end and the two CUDA kernels."""
