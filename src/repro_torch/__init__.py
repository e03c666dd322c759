"""PyTorch/CUDA port of the compute substrate (``repro``), for one NVIDIA H100.

Mirrors the JAX package's layout (``configs/``, ``kernels/``, ``models/``,
``runtime/``) and never imports it. Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``; see ``repro_torch.device``.
"""
