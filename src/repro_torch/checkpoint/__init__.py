"""Checkpointing of the PyTorch port, in the JAX package's on-disk format."""
