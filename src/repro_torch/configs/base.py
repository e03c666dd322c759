"""Architecture configuration registry of the PyTorch port.

A field-for-field copy of the JAX package's registry, kept here so that the port
never imports that package (its ``configs/__init__`` pulls in jax). Every assigned
architecture is a frozen ``ArchConfig``; the port builds its models
(``repro_torch.models.model``) and serve jobs from it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Family = str  # dense | moe | ssm | hybrid | encdec | vlm


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention features
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # window size for local layers
    local_global_pattern: int = 0             # N => every (N+1)-th layer is global, rest local
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router_normalize: bool = True
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2-style): shared attn+mlp block applied every k mamba layers
    shared_block_every: int = 0
    # enc-dec (whisper-style)
    encoder_layers: int = 0
    encoder_frames: int = 1500                # stub frontend: precomputed frame embeddings
    # vlm (llama-3.2-vision style): every k-th layer is cross-attn to patch embeddings
    cross_attn_every: int = 0
    num_patches: int = 1601                   # stub frontend: precomputed patch embeddings
    # training / numerics
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"                       # none | dots | full
    loss_chunk: int = 0                       # >0: chunked CE (never materialize
                                              # full [B,S,V] logits; §Perf lever)
    packed_decode: bool = False               # GQA decode attention without
                                              # repeat/f32 cache copy (§Perf)
    tie_embeddings: bool = False
    max_context: int = 131_072
    # management-plane metadata (Titchener routing rules)
    compliance_tags: Tuple[str, ...] = ()

    # ---- derived ----
    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §5)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # local:global mixes bound most KV to the window; we run them (gemma3).
        return self.sliding_window is not None and self.local_global_pattern > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper is enc-dec)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D in the roofline)."""
        c, L, D = self, self.num_layers, self.d_model
        emb = c.vocab_size * D * (1 if c.tie_embeddings else 2)
        total = emb
        for i in range(L):
            total += self._layer_params(i)
        if c.family == "encdec":
            total += D  # encoder final norm
            for _ in range(c.encoder_layers):
                total += self._attn_params() + self._mlp_params(c.d_ff) + 2 * D
        if c.shared_block_every:
            total += self._attn_params() + self._mlp_params(c.d_ff) + 2 * D
        total += D  # final norm
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        c, D = self, self.d_model
        total = c.vocab_size * D * (1 if c.tie_embeddings else 2) + D
        per_layer = self._attn_params() + 2 * D
        per_layer += (c.num_shared_experts + c.top_k) * 3 * D * c.d_ff_expert
        per_layer += D * c.num_experts  # router (all experts scored)
        return total + c.num_layers * per_layer

    def _attn_params(self) -> int:
        c, D = self, self.d_model
        qkv = D * c.num_heads * c.head_dim + 2 * D * c.num_kv_heads * c.head_dim
        out = c.num_heads * c.head_dim * D
        qknorm = 2 * c.head_dim if c.qk_norm else 0
        return qkv + out + qknorm

    def _mlp_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def _ssm_params(self) -> int:
        c, D = self, self.d_model
        G = 1  # single B/C group
        in_proj = D * (2 * c.d_inner + 2 * G * c.ssm_state + c.ssm_heads)
        conv = c.ssm_conv_width * (c.d_inner + 2 * G * c.ssm_state)
        out_proj = c.d_inner * D
        extra = 3 * c.ssm_heads  # A_log, dt_bias, D skip
        return in_proj + conv + out_proj + extra + c.d_inner  # + gate-norm scale

    def _layer_params(self, i: int) -> int:
        c, D = self, self.d_model
        norms = 2 * D
        if c.family == "ssm":
            return c._ssm_params() + D
        if c.family == "hybrid":
            return c._ssm_params() + D  # shared block counted once in param_count
        if c.family == "moe":
            moe = D * c.num_experts  # router
            moe += (c.num_experts + c.num_shared_experts) * 3 * D * c.d_ff_expert
            return self._attn_params() + moe + norms
        if c.family == "vlm" and c.cross_attn_every and (i + 1) % c.cross_attn_every == 0:
            # cross layers REPLACE self-attn: xattn + mlp + 2 norms + gate scalar
            return self._attn_params() + self._mlp_params(c.d_ff) + norms + 1
        if c.family == "encdec":
            # decoder layer: self-attn + cross-attn + mlp + ln1/ln2/ln3
            return (2 * self._attn_params() + self._mlp_params(c.d_ff)
                    + norms + D)
        return self._attn_params() + self._mlp_params(c.d_ff) + norms

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (full configs only ever dry-run)."""
        if self.local_global_pattern:
            n_layers = self.local_global_pattern + 1      # one full local:global group
        elif self.shared_block_every:
            n_layers = 6
        else:
            n_layers = min(self.num_layers, 4)
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 8),
            top_k=min(self.top_k, 2),
            d_ff_expert=64 if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=24 if self.encoder_layers else 1500,
            cross_attn_every=min(self.cross_attn_every, 2),
            num_patches=16 if self.cross_attn_every else 1601,
            sliding_window=64 if self.sliding_window else None,
            shared_block_every=3 if self.shared_block_every else 0,
            max_context=4096,
        )


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import the per-arch modules exactly once
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        qwen3_32b, phi4_mini_3_8b, gemma3_12b, qwen3_0_6b, deepseek_moe_16b,
        qwen3_moe_235b_a22b, mamba2_2_7b, whisper_medium, zamba2_7b,
        llama32_vision_90b,
    )
