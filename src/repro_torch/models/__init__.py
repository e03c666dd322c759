"""Model definitions of the PyTorch port: all six families, tensor- and
data-parallel on a mesh for all but moe."""
