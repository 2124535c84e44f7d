"""Serving entry points of the PyTorch port."""
