"""Model definitions of the PyTorch port (dense family in this slice)."""
