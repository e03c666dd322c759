"""Parameter definition trees, twins of ``repro.models.params``.

Every parameter is declared once as a ``ParamDef(shape, logical, init, scale)``
leaf in a nested dict with the JAX package's names and shapes (``wq`` is
``[D, H, hd]``; repeated layers carry a leading "layers" dim), so a parameter
tree converts 1:1 between the two packages. ``init_params`` materializes the
tree on a device from an explicit ``torch.Generator``; its numbers differ from
``jax.random``'s, its rules (``_init_leaf``) do not. ``partition_specs`` maps
each leaf's logical axes to a ``PartitionSpec`` through a ``MeshPlan``'s rules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import device as devices
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TensorDef:
    """A tensor's shape and dtype without its memory: the port's stand-in for
    ``jax.ShapeDtypeStruct``, and, with its logical axes, for the JAX package's
    cache ``TensorDef``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        assert self.logical is None or len(self.shape) == len(self.logical), (
            self.shape, self.logical)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _stack(defs: dict, n: int) -> dict:
    """Prefix every ParamDef with a 'layers' dimension of size n."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.logical, d.init, d.scale),
        defs)


def attn_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("embed", "heads", "qk_depth")),
        "wk": ParamDef((D, K, hd), ("embed", "kv_heads", "qk_depth")),
        "wv": ParamDef((D, K, hd), ("embed", "kv_heads", "qk_depth")),
        "wo": ParamDef((H, hd, D), ("heads", "qk_depth", "embed")),
    }
    if cfg.qk_norm and not cross:
        d["q_norm"] = ParamDef((hd,), (None,), "ones")
        d["k_norm"] = ParamDef((hd,), (None,), "ones")
    return d


def mlp_defs(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((D, F), ("embed", "ffn")),
        "w_up": ParamDef((D, F), ("embed", "ffn")),
        "w_down": ParamDef((F, D), ("ffn", "embed")),
    }


def moe_defs(cfg: ArchConfig) -> dict:
    D, E, F = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    d = {
        "router": ParamDef((D, E), ("embed_nofsdp", "experts")),
        "we_gate": ParamDef((E, D, F), ("experts", "embed", "ffn_nofsdp")),
        "we_up": ParamDef((E, D, F), ("experts", "embed", "ffn_nofsdp")),
        "we_down": ParamDef((E, F, D), ("experts", "ffn_nofsdp", "embed")),
    }
    if cfg.num_shared_experts:
        d["shared"] = mlp_defs(cfg, cfg.num_shared_experts * cfg.d_ff_expert)
    return d


def ssm_defs(cfg: ArchConfig) -> dict:
    D, DI, N, Hs, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_conv_width)
    return {
        "w_z": ParamDef((D, DI), ("embed", "ffn")),
        "w_x": ParamDef((D, DI), ("embed", "ffn")),
        "w_b": ParamDef((D, N), ("embed", None)),
        "w_c": ParamDef((D, N), ("embed", None)),
        "w_dt": ParamDef((D, Hs), ("embed", "ssm_heads")),
        "conv_x": ParamDef((W, DI), ("conv", "ffn")),
        "conv_b": ParamDef((W, N), ("conv", None)),
        "conv_c": ParamDef((W, N), ("conv", None)),
        "a_log": ParamDef((Hs,), ("ssm_heads",), "ssm_a"),
        "dt_bias": ParamDef((Hs,), ("ssm_heads",), "ssm_dt"),
        "d_skip": ParamDef((Hs,), ("ssm_heads",), "ones"),
        "gate_norm": ParamDef((DI,), ("ffn",), "ones"),
        "out_proj": ParamDef((DI, D), ("ffn", "embed")),
    }


def norm_def(cfg: ArchConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), (None,), "ones")


def _decoder_layer_defs(cfg: ArchConfig) -> dict:
    """One repeated decoder layer (self-attn or ssm [+ moe])."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ssm": ssm_defs(cfg), "ln1": norm_def(cfg)}
    d = {"attn": attn_defs(cfg), "ln1": norm_def(cfg), "ln2": norm_def(cfg)}
    if cfg.family == "moe":
        d["moe"] = moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg)
    return d


def param_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    tree = {
        "embed": ParamDef((cfg.vocab_size, D), ("vocab", "embed"), "normal", 1.0),
        "final_norm": norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = ParamDef((D, cfg.vocab_size), ("embed", "vocab"))

    if cfg.family == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        n_self = cfg.num_layers - n_cross
        group = cfg.cross_attn_every - 1
        assert n_self == n_cross * group, "num_layers must tile into (self*,cross) groups"
        self_layer = {"attn": attn_defs(cfg), "mlp": mlp_defs(cfg),
                      "ln1": norm_def(cfg), "ln2": norm_def(cfg)}
        cross_layer = {"xattn": attn_defs(cfg, cross=True), "mlp": mlp_defs(cfg),
                       "ln1": norm_def(cfg), "ln2": norm_def(cfg),
                       "gate": ParamDef((), (), "zeros")}
        tree["self_layers"] = _stack(_stack(self_layer, group), n_cross)
        tree["cross_layers"] = _stack(cross_layer, n_cross)
        return tree

    tree["layers"] = _stack(_decoder_layer_defs(cfg), cfg.num_layers)

    if cfg.family == "hybrid":
        tree["shared_block"] = {"attn": attn_defs(cfg), "mlp": mlp_defs(cfg),
                                "ln1": norm_def(cfg), "ln2": norm_def(cfg)}
    if cfg.family == "encdec":
        enc_layer = {"attn": attn_defs(cfg), "mlp": mlp_defs(cfg),
                     "ln1": norm_def(cfg), "ln2": norm_def(cfg)}
        tree["enc_layers"] = _stack(enc_layer, cfg.encoder_layers)
        tree["enc_norm"] = norm_def(cfg)
        dec = tree["layers"]
        dec["xattn"] = _stack(attn_defs(cfg, cross=True), cfg.num_layers)
        dec["ln3"] = _stack({"n": norm_def(cfg)}, cfg.num_layers)["n"]
    return tree


# ------------------------------------------------------------------ materialization
def _init_leaf(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
               dev: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    if d.init in ("ssm_a", "ssm_dt"):
        lo, hi = (0.5, 1.0) if d.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=dev)
        u = u * (hi - lo) + lo
        if d.init == "ssm_a":          # A in [-1, -0.5]; a_log kept f32
            return torch.log(u)
        return u + torch.log(-torch.expm1(-u))   # softplus^-1 of dt, kept f32
    fan_in = d.shape[0] if len(d.shape) else 1
    if len(d.shape) >= 2:
        fan_in = 1
        for s, log in zip(d.shape[:-1], d.logical[:-1]):
            if log != "layers":  # stacked layer dims are not fan-in dims
                fan_in *= s
    std = d.scale / max(fan_in, 1) ** 0.5
    # scaled in place: deepseek-moe-16b's stacked expert leaves are 19.3 GiB in f32
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
    return x.mul_(std).to(dtype)


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Materialize ``param_defs(cfg)`` on ``device``, drawing from a
    ``torch.Generator`` seeded with ``seed``. Param dtype is ``cfg.dtype``."""
    dev = devices.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    return tree_map(lambda d: _init_leaf(d, gen, dtype, dev), param_defs(cfg))


def abstract_params(cfg: ArchConfig) -> dict:
    """``param_defs(cfg)`` as ``TensorDef`` leaves of ``init_params``'s dtypes:
    ``cfg.dtype``, f32 for mamba2's ``a_log`` and ``dt_bias``."""
    dtype = getattr(torch, cfg.dtype)
    return tree_map(lambda d: TensorDef(d.shape, torch.float32 if d.init in ("ssm_a", "ssm_dt")
                                        else dtype), param_defs(cfg))


def partition_specs(cfg: ArchConfig, plan) -> dict:
    """The ``PartitionSpec`` of every parameter under ``plan``'s rules."""
    return tree_map(lambda d: plan.spec(d.logical, d.shape), param_defs(cfg))
