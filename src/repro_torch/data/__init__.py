"""Input pipelines of the PyTorch port."""
