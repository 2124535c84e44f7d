"""Kernels and primitives of the PyTorch port."""
