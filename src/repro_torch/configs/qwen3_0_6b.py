"""qwen3-0.6b [dense] — qk_norm, GQA (attn dim decoupled from d_model). [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    compliance_tags=("region:any", "onprem:ok"),
))
