"""Host-side data transforms of the PyTorch port."""
