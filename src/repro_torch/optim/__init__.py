"""Optimizer of the PyTorch port: AdamW with f32 master weights, its schedule."""
