"""AdamW with f32 master weights, twin of ``repro.optim.adamw``.

Params stay in the model dtype (bf16) and are regenerated from the f32 master
copy every step. m, v and master carry the params' logical axes, laid out by
the ZeRO rules (``opt_state_specs``: the FSDP dim spread over the "pod" axis as
well); on one device every layout is the identity. The update is
the JAX package's arithmetic, leaf by leaf in its flatten order (dict keys
sorted), under ``torch.no_grad()``; no fused or foreach optimizer of
``torch.optim``. Unlike the JAX package's functional update, the port updates the
params, m, v and master tensors in place (the state is ~12 GB at qwen3-0.6b's
full width: a second copy would double it) and returns the same trees. It forms
each leaf's update in place too, in the functional form's f32 ops and order, so
the bits are the same: mamba2-2.7b's largest leaves are 3.4 GB in f32, and every
temporary of the functional form is one more of them at the step's memory peak.

DTensor state (every family on a ``DeviceMesh``; every leaf
alike, the moe family's [L, E, D, F] expert leaves split over "model" by their
experts; a leaf replicated over "model", as a norm or vlm's gate, has the same
gradient on every model rank): each rank updates its
``opt_state_specs`` shard of master, m and v from its shard of the gradient in
that layout (a view of the gradient's, which splits no more), and the new
params, cast to their dtype, are gathered from the masters' layout back into the
params' (ZeRO's all-gather over the axes the optimizer state adds). The
gradient norm sums each leaf's squares over its local shard and reduces them
over the mesh axes that split that leaf only, so a replicated shard counts
once. On a one-rank mesh every step of this is the one-device arithmetic, op for
op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.params import TensorDef, param_defs
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel.sharding import PartitionSpec, as_dtensor, relayout, splits_further
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


def opt_state_specs(cfg, plan) -> dict:
    """PartitionSpecs of the optimizer state (ZeRO rules, pod-spread)."""
    spec = tree_map(lambda d: plan.opt_spec(d.logical, d.shape), param_defs(cfg))
    return {"m": spec, "v": spec, "master": spec, "step": PartitionSpec()}


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_sorted(tree)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _split_axes(t: torch.Tensor) -> tuple:
    """The mesh axes of more than one rank that split a DTensor leaf."""
    if not isinstance(t, DTensor):
        return ()
    mesh = t.device_mesh
    return tuple(name for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, t.placements))
                 if pl.is_shard() and mesh.size(i) > 1)


def _as_laid(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the value of ``t`` in ``like``'s layout."""
    if not isinstance(t, DTensor):
        return t
    return relayout(t.to_local(), t.device_mesh, t.shape, tuple(t.placements),
                    tuple(like.placements))


def global_norm(tree) -> torch.Tensor:
    leaves = _leaves(tree)
    terms = [torch.sum(torch.square(_local(g).float())) for g in leaves]
    groups: dict = {}
    for i, g in enumerate(leaves):
        axes = _split_axes(g)
        if axes:
            groups.setdefault((id(g.device_mesh), axes), (g.device_mesh, []))[1].append(i)
    for (_, axes), (mesh, idx) in groups.items():
        sums = torch.stack([terms[i] for i in idx])
        for a in axes:
            dist.all_reduce(sums, group=mesh.get_group(a))
        for j, i in enumerate(idx):
            terms[i] = sums[j]
    return torch.sqrt(sum(terms))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """One AdamW step: global-norm clip, bias corrections, decoupled weight decay
    on the master, params = master cast to their dtype. Updates ``params`` and
    ``state``'s tensors in place; returns (params, new_state, metrics
    {grad_norm, lr})."""
    step = _local(state["step"]) + 1
    if lr is None:
        lr = warmup_cosine(step, peak_lr=cfg.peak_lr, warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for pt, gt, mt, vt, wt in zip(_leaves(params), _leaves(grads), _leaves(state["m"]),
                                  _leaves(state["v"]), _leaves(state["master"])):
        p, m, v, master = _local(pt), _local(mt), _local(vt), _local(wt)
        g = _as_laid(gt, mt).float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        # master - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * master), op by op
        den = (v / bc2).sqrt_().add_(cfg.eps)
        step_ = (m / bc1).div_(den)
        del den
        master.sub_(step_.add_(cfg.weight_decay * master).mul_(lr))
        if isinstance(pt, DTensor):
            mesh, src, dst = pt.device_mesh, tuple(wt.placements), tuple(pt.placements)
            # a view where the params' layout splits the masters' further; else
            # gathered (ZeRO), in the param's dtype
            new = master if splits_further(mesh, src, dst) else master.to(p.dtype)
            master = relayout(new, mesh, pt.shape, src, dst)
        p.copy_(master)                       # cast to the param's dtype
    if isinstance(state["step"], DTensor):
        st = state["step"]
        step = as_dtensor(step, st.device_mesh, tuple(st.placements), st.shape)
    new_state = {"m": state["m"], "v": state["v"], "master": state["master"],
                 "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
