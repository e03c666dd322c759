"""Mixture-of-Experts layer (DeepSeek-MoE / Qwen3-MoE style), twin of
``repro.models.moe``.

Train/prefill path (``moe_block``): capacity-based top-k dispatch, each batch row
a dispatch group. An assignment's position in its expert is an exclusive cumsum
over the one-hot of the group's flattened [S*K] assignments; an assignment at or
past the capacity C is dropped (it goes to the sentinel slot E*C, which is sliced
away, and its combine weight is zeroed). A [B, E*C] slot -> token table, filled
with S (the zero pad row), drives one row gather into the expert buffers, three
batched products per expert, and one row gather of each token's K slots back.

Decode path (``moe_block_decode``): every expert on every token, masked by the
router weights, combined in f32 (every expert's weights are read either way at
decode batch sizes).

The numbers follow the JAX package step for step: f32 router logits, top-k of the
softmax, renormalised by max(sum, 1e-9); silu in f32 cast to the activation dtype
before the up product; the combine weights cast to the activation dtype. The JAX
package's gathers take [B, E*C] / [B, S, K] index tables per batch row; here both
gathers index the rows of one flat table, the expert buffers laid out [E, B*C, D]
so that each expert's rows are one contiguous matrix of a batched product. On one
card the JAX package's sharding constraints and its ``moe_combine_reshard`` layout
hint are identities, so neither appears here.

In the backward, the dispatch gather scatters each token's K slot gradients back
into its row with atomic adds on the card: the MoE step is not bit-reproducible
there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import swiglu


def router_probs(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x [..., D] -> (weights [..., K] f32, idx [..., K], probs [..., E] f32):
    top-k of the softmax of f32 logits, largest first."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.router_normalize:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx, probs


def aux_load_balance_loss(cfg: ArchConfig, probs: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss over the group: E * sum_e f_e * p_e, with f_e
    the mean over tokens of the assignments to expert e (each token has K) and
    p_e the mean router probability. The counts are an index add (no host sync)."""
    E = cfg.num_experts
    n_tokens = probs.numel() // E
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32,
                                       device=probs.device))
    return E * torch.sum(counts / n_tokens * probs.reshape(-1, E).mean(0))


def capacity(cfg: ArchConfig, S: int) -> int:
    """The slots of each expert in a dispatch group of S tokens."""
    return max(int(S * cfg.top_k * cfg.capacity_factor / cfg.num_experts), cfg.top_k)


def moe_block(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x [B, S, D] -> ([B, S, D], aux loss). Capacity-based top-k dispatch."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)                                          # per-group capacity
    dev = x.device

    weights, idx, probs = router_probs(cfg, p, x)                 # [B, S, K]
    aux = aux_load_balance_loss(cfg, probs, idx)

    # ---- slot assignment (per group = batch row) ---------------------------------
    flat_idx = idx.reshape(B, S * K)                              # assignment -> expert
    # the one-hot laid out [B, E, S*K], so the cumsum runs along its innermost dim
    onehot = torch.zeros((B, E, S * K), dtype=torch.int32, device=dev).scatter_(
        1, flat_idx[:, None], 1)
    # the exclusive cumsum at the assignment's own expert: inclusive minus one
    my_pos = onehot.cumsum(2, dtype=torch.int32).gather(1, flat_idx[:, None])[:, 0] - 1
    keep = my_pos < C
    slot = torch.where(keep, flat_idx * C + my_pos, E * C)       # dropped -> sentinel

    # slot -> token table [B, E*C (+1 sentinel)]; an empty slot reads pad row S
    token_of_assign = (torch.arange(S * K, device=dev) // K).expand(B, S * K)
    slot_token = torch.full((B, E * C + 1), S, dtype=torch.long, device=dev)
    slot_token = slot_token.scatter_(1, slot, token_of_assign)[:, :E * C]

    # ---- dispatch: gather token rows into the expert buffers [E, B*C, D] ----------
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1).reshape(B * (S + 1), D)
    rows = slot_token.reshape(B, E, C) + (torch.arange(B, device=dev) * (S + 1))[:, None, None]
    buf = x_pad.index_select(0, rows.transpose(0, 1).reshape(-1)).reshape(E, B * C, D)

    # ---- expert compute (grouped SwiGLU) ------------------------------------------
    h = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    h = F.silu(h.float()).to(x.dtype) * u
    out = torch.bmm(h, p["we_down"]).reshape(E * B * C, D)       # row (e, b, c)

    # ---- combine: gather each token's K slots back, weight, and sum ---------------
    out_pad = torch.cat([out, out.new_zeros((1, D))])             # row E*B*C: zeros
    b_off = (torch.arange(B, device=dev) * C)[:, None]
    out_rows = torch.where(keep, flat_idx * (B * C) + b_off + my_pos, E * B * C)
    tok_out = out_pad.index_select(0, out_rows.reshape(-1)).reshape(B, S, K, D)
    w = (weights * keep.reshape(B, S, K)).to(x.dtype)
    y = (w.unsqueeze(-2) @ tok_out).squeeze(-2)                   # sum_k w_k * out_k

    if cfg.num_shared_experts:
        y = y + swiglu(p["shared"], x)
    return y, aux


def moe_block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] (S = 1 at decode). Dense all-experts evaluation masked by the
    router weights, combined in f32."""
    B, S, D = x.shape
    E = cfg.num_experts
    weights, idx, _ = router_probs(cfg, p, x)                     # [B, S, K]
    w_full = torch.zeros((B * S, E), dtype=torch.float32, device=x.device).scatter_add_(
        1, idx.reshape(B * S, -1), weights.reshape(B * S, -1))   # [B*S, E]

    xs = x.reshape(B * S, D)
    h = torch.matmul(xs, p["we_gate"])                            # [E, B*S, F]
    u = torch.matmul(xs, p["we_up"])
    h = F.silu(h.float()).to(x.dtype) * u
    y_e = torch.bmm(h, p["we_down"])                              # [E, B*S, D]
    y = torch.einsum("end,ne->nd", y_e.float(), w_full).to(x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + swiglu(p["shared"], x)
    return y
