"""llama-3.2-vision-90b [vlm] — every 5th layer cross-attends to image patch embeddings;
the vision tower is a STUB (``input_specs()`` provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    cross_attn_every=5,
    num_patches=1601,
    rope_theta=500_000.0,
    compliance_tags=("region:any", "modality:vision", "tier:flagship"),
))
