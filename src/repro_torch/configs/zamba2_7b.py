"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,             # 3584 / 32
    d_ff=14336,               # shared block MLP width
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    shared_block_every=6,
    max_context=1_048_576,
    compliance_tags=("region:any", "longctx:ok"),
))
