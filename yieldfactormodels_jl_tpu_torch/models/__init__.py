"""Model specifications, parameters and filters of the PyTorch port."""
