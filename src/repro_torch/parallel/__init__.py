"""Sharding of the PyTorch port, twin of ``repro.parallel``."""
from repro_torch.parallel.sharding import MeshPlan, constrain, logical_spec  # noqa: F401
