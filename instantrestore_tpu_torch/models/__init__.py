"""Models of the PyTorch port: UNet, VAE, attention, restorer."""
