"""Likelihood engines and hand-written CUDA kernels of the PyTorch port."""
