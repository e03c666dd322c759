from repro_torch.configs.base import ArchConfig, get, names, register  # noqa: F401
