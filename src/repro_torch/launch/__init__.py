"""The train step of the PyTorch port (twin of ``repro.launch.steps``)."""
