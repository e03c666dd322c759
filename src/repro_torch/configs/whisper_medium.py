"""whisper-medium [audio] — enc-dec transformer backbone; conv frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (1500 frames). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    encoder_frames=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,              # 1024 / 16 (whisper uses d_model/heads)
    d_ff=4096,
    vocab_size=51_865,
    rope_theta=10_000.0,      # (whisper uses learned abs pos; we use RoPE — noted in DESIGN.md)
    compliance_tags=("region:any", "modality:audio"),
))
