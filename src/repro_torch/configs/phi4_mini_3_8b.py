"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    compliance_tags=("region:any",),
))
