"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # per-expert width
    vocab_size=151_936,
    qk_norm=True,
    num_experts=128,
    num_shared_experts=0,
    top_k=8,
    d_ff_expert=1536,
    router_normalize=True,
    rope_theta=1_000_000.0,
    compliance_tags=("region:any", "tier:flagship"),
))
