"""AdamW with f32 master weights, twin of ``repro.optim.adamw``.

Params stay in the model dtype (bf16) and are regenerated from the f32 master
copy every step. On one card the optimizer state is not sharded. The update is
the JAX package's arithmetic, leaf by leaf in its flatten order (dict keys
sorted), under ``torch.no_grad()``; no fused or foreach optimizer of
``torch.optim``. Unlike the JAX package's functional update, the port updates the
params, m, v and master tensors in place (the state is ~12 GB at qwen3-0.6b's
full width: a second copy would double it) and returns the same trees. It forms
each leaf's update in place too, in the functional form's f32 ops and order, so
the bits are the same: mamba2-2.7b's largest leaves are 3.4 GB in f32, and every
temporary of the functional form is one more of them at the step's memory peak.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.params import TensorDef, param_defs
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import tree_flatten_sorted, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: dict) -> dict:
    """f32 m, v (zeros) and master (a copy of params); int32 step 0, on the
    params' device."""
    leaf = tree_flatten_sorted(params)[0][1]
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def abstract_opt_state(cfg) -> dict:
    """``init_opt_state``'s tree as ``TensorDef`` leaves: f32 m, v and master of
    every param, an int32 step."""
    f32 = tree_map(lambda d: TensorDef(d.shape, torch.float32), param_defs(cfg))
    return {"m": f32, "v": f32, "master": f32, "step": TensorDef((), torch.int32)}


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_sorted(tree)]


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """One AdamW step: global-norm clip, bias corrections, decoupled weight decay
    on the master, params = master cast to their dtype. Updates ``params`` and
    ``state``'s tensors in place; returns (params, new_state, metrics
    {grad_norm, lr})."""
    step = state["step"] + 1
    if lr is None:
        lr = warmup_cosine(step, peak_lr=cfg.peak_lr, warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v, master in zip(_leaves(params), _leaves(grads), _leaves(state["m"]),
                                  _leaves(state["v"]), _leaves(state["master"])):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        # master - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * master), op by op
        den = (v / bc2).sqrt_().add_(cfg.eps)
        step_ = (m / bc1).div_(den)
        del den
        master.sub_(step_.add_(cfg.weight_decay * master).mul_(lr))
        p.copy_(master)                       # cast to the param's dtype
    new_state = {"m": state["m"], "v": state["v"], "master": state["master"],
                 "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
