"""Model definitions of the PyTorch port: all six families, tensor- and
data-parallel on a mesh (the moe family's experts split over "model")."""
