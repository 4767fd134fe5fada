"""Utilities of the PyTorch port (parameter transforms)."""
