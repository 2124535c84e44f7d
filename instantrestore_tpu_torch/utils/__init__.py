"""Checkpoint conversion and weight-file I/O of the PyTorch port."""
