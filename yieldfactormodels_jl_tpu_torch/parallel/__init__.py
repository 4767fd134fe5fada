"""Multi-host coordination of the PyTorch port (the stale-lock sweep)."""
