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
so that each expert's rows are one contiguous matrix of a batched product.

The load-balance loss is E * sum_e f_e * p_e over every token of the batch, a
product of two means: ``routing_stats`` gives a layer's assignment counts and
probability sums, which the model sums over the batch axes of a mesh before
``aux_from_stats`` forms the product (``models/model.py``), so that each rank
reports the global loss and takes its rows' share of its gradient.

Expert parallelism (``tp``, ``parallel.sharding.TensorParallel``, with
``tp.experts``: the JAX package's "experts" rule splits the E experts over
"model", each rank holding a run of E/M of them and the router's columns of
them). Every rank routes every token of its rows alike: the router's columns are
gathered (``gather_along``), so each rank computes the logits from the same bits,
and the slot assignment over all E experts is the one-card one. Each rank
dispatches its rows to its own experts only (x enters that region once, through
``copy_to``, so its gradient is summed over the ranks of "model") and runs the
three products on them. The combine is one of the JAX package's two routes:
  * by default each rank weights its experts' outputs of each token and the
    partial sums are summed over "model" (``reduce_partial``, a [B, S, D]
    all-reduce); the combine weights enter through ``copy_to``, so their
    gradient, and with it the router's, is whole on every rank, and the
    gathered router's backward keeps the rank's columns;
  * under ``plan.moe_combine_reshard`` the slot buffer is gathered over "model"
    before the token gather (``gather_along``) and every rank combines all of
    it, the one-card code, with no [B, S, D] all-reduce.
Decode runs the rank's experts on every token, masked by its columns of the
routing weights, and sums the f32 partial outputs over "model". The shared
experts are the split SwiGLU of ``models/layers.py``. Where "model" does not
divide E, or has one rank, every rank computes every expert: the one-card code.

In the backward, the dispatch gather scatters each token's K slot gradients back
into its row with atomic adds on the card: the MoE step is not bit-reproducible
there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import swiglu
from repro_torch.parallel.sharding import (TensorParallel, copy_to, gather_along,
                                           reduce_from, reduce_partial)


def _split(tp: Optional[TensorParallel]) -> bool:
    return tp is not None and tp.experts


def router_probs(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 tp: Optional[TensorParallel] = None):
    """x [..., D] -> (weights [..., K] f32, idx [..., K], probs [..., E] f32):
    top-k of the softmax of f32 logits, largest first. Where ``tp`` splits the
    experts, the router's columns are gathered over "model" first."""
    router = gather_along(p["router"], 1, tp.plan) if _split(tp) else p["router"]
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.router_normalize:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx, probs


def routing_stats(cfg: ArchConfig, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[2, E] f32: the assignments to each expert (an index add, no host sync) and
    the sum of its router probability, over the tokens of ``probs``."""
    E = cfg.num_experts
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32,
                                       device=probs.device))
    return torch.stack([counts, probs.reshape(-1, E).sum(0)])


def aux_from_stats(cfg: ArchConfig, stats: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """The load-balance loss E * sum_e f_e * p_e of ``routing_stats`` [..., 2, E]
    over ``n_tokens`` tokens: f_e the mean over tokens of the assignments to
    expert e (each token has K), p_e the mean router probability; one loss a
    leading index of ``stats``."""
    return cfg.num_experts * torch.sum(stats[..., 0, :] / n_tokens
                                       * (stats[..., 1, :] / n_tokens), dim=-1)


def aux_load_balance_loss(cfg: ArchConfig, probs: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss over the group of ``probs``' tokens."""
    return aux_from_stats(cfg, routing_stats(cfg, probs, idx),
                          probs.numel() // cfg.num_experts)


def capacity(cfg: ArchConfig, S: int) -> int:
    """The slots of each expert in a dispatch group of S tokens."""
    return max(int(S * cfg.top_k * cfg.capacity_factor / cfg.num_experts), cfg.top_k)


def moe_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
              tp: Optional[TensorParallel] = None):
    """x [B, S, D] -> ([B, S, D], the load-balance loss of its B*S tokens)."""
    y, stats = moe_block_stats(cfg, p, x, tp)
    return y, aux_from_stats(cfg, stats, x.shape[0] * x.shape[1])


def moe_block_stats(cfg: ArchConfig, p: dict, x: torch.Tensor,
                    tp: Optional[TensorParallel] = None):
    """x [B, S, D] -> ([B, S, D], ``routing_stats`` [2, E] of its B*S tokens).
    Capacity-based top-k dispatch; under ``tp`` onto the rank's experts (see the
    module docstring)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)                                          # per-group capacity
    dev = x.device
    split = _split(tp)
    lo, El = tp.expert_range(E) if split else (0, E)              # this rank's experts

    weights, idx, probs = router_probs(cfg, p, x, tp)             # [B, S, K]
    stats = routing_stats(cfg, probs, idx)

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

    # ---- dispatch: gather token rows into the expert buffers [El, B*C, D] ---------
    xe = copy_to(x, tp.plan) if split else x
    x_pad = torch.cat([xe, xe.new_zeros((B, 1, D))], dim=1).reshape(B * (S + 1), D)
    rows = (slot_token.reshape(B, E, C)[:, lo:lo + El]
            + (torch.arange(B, device=dev) * (S + 1))[:, None, None])
    buf = x_pad.index_select(0, rows.transpose(0, 1).reshape(-1)).reshape(El, B * C, D)

    # ---- expert compute (grouped SwiGLU) ------------------------------------------
    h = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    h = F.silu(h.float()).to(x.dtype) * u
    out = torch.bmm(h, p["we_down"])                              # [El, B*C, D]

    # ---- combine: gather each token's K slots back, weight, and sum ---------------
    if split and tp.plan.moe_combine_reshard:    # every rank gathers the whole slot buffer
        out, lo, El = gather_along(out, 0, tp.plan), 0, E
    partial = El < E                   # this rank combines its own experts' share
    out = out.reshape(El * B * C, D)                              # row (e, b, c)
    out_pad = torch.cat([out, out.new_zeros((1, D))])             # row El*B*C: zeros
    b_off = (torch.arange(B, device=dev) * C)[:, None]
    mine = keep & (flat_idx >= lo) & (flat_idx < lo + El) if partial else keep
    expert = flat_idx - lo if lo else flat_idx                    # among this rank's
    out_rows = torch.where(mine, expert * (B * C) + b_off + my_pos, El * B * C)
    tok_out = out_pad.index_select(0, out_rows.reshape(-1)).reshape(B, S, K, D)
    w = (copy_to(weights, tp.plan) if partial else weights) * keep.reshape(B, S, K)
    y = (w.to(x.dtype).unsqueeze(-2) @ tok_out).squeeze(-2)       # sum_k w_k * out_k
    if partial:                        # the ranks' experts' shares of each token
        y = reduce_partial(y, tp.plan)

    if cfg.num_shared_experts:
        y = y + swiglu(p["shared"], x, tp)
    return y, stats


def moe_block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                     tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """x [B, S, D] (S = 1 at decode). Dense all-experts evaluation masked by the
    router weights, combined in f32; under ``tp`` the rank's experts, their f32
    outputs summed over "model"."""
    B, S, D = x.shape
    E = cfg.num_experts
    split = _split(tp)
    lo, El = tp.expert_range(E) if split else (0, E)
    weights, idx, _ = router_probs(cfg, p, x, tp)                 # [B, S, K]
    w_full = torch.zeros((B * S, E), dtype=torch.float32, device=x.device).scatter_add_(
        1, idx.reshape(B * S, -1), weights.reshape(B * S, -1))   # [B*S, E]

    xs = x.reshape(B * S, D)
    h = torch.matmul(xs, p["we_gate"])                            # [El, B*S, F]
    u = torch.matmul(xs, p["we_up"])
    h = F.silu(h.float()).to(x.dtype) * u
    y_e = torch.bmm(h, p["we_down"])                              # [El, B*S, D]
    y = torch.einsum("end,ne->nd", y_e.float(), w_full[:, lo:lo + El])
    if split:
        y = reduce_from(y, tp.plan)
    y = y.to(x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + swiglu(p["shared"], x, tp)
    return y
