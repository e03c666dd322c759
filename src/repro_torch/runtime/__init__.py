"""Runtime of the PyTorch port: serving, training and their task semantics."""
