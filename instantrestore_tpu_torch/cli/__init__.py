"""Command-line entry points of the PyTorch port (``python -m
instantrestore_tpu_torch.cli.infer|serve``)."""
