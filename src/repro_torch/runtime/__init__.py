"""Serving runtime of the PyTorch port."""
