"""gemma3-12b [dense] — 5:1 local:global sliding-window mix, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

``local_global_pattern=5`` => every 6th layer is global attention, the other five use a
1024-token sliding window (gemma3 convention). head_dim is decoupled from d_model.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262_144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_pattern=5,
    max_context=131_072,
    compliance_tags=("region:any",),
))
