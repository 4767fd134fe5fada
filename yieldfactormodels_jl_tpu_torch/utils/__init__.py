"""Utilities of the PyTorch port: parameter transforms, CSV data loading
and stage timing."""
