"""Model definitions of the PyTorch port: all six families, tensor- and
data-parallel on a mesh for the dense, ssm and hybrid families."""
