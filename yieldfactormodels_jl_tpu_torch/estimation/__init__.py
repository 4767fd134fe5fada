"""Estimation layer of the port: batched multi-start L-BFGS and ``estimate``."""
