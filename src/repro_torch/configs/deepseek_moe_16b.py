"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert width (fine-grained)
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    router_normalize=True,
    rope_theta=10_000.0,
    compliance_tags=("region:any",),
))
