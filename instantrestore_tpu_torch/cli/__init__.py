"""Command-line entry points of the PyTorch port (``python -m
instantrestore_tpu_torch.cli.infer|serve|train|evaluate|parity``; the
``instantrestore-torch-*`` console scripts run the same ``main``s)."""
