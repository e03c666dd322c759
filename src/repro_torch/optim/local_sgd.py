"""Titchener local-sync trainer (DiLoCo-style local SGD over the pod boundary),
twin of ``repro.optim.local_sgd``.

Each pod runs H AdamW steps on its own copy of the parameters; once a round the
pods exchange int8, error-feedback-compressed parameter deltas
(``optim/compression.py``), and an outer Nesterov-SGD step applies the pod-mean
delta to the global master, which is then written back into every pod. The
state has the JAX package's layout and dtypes: every per-pod tree carries a
leading ``n_pods`` dim.

On one card the pods are a loop: pod p's inner step works on ``t[p]`` views of
the stacked tensors, and ``adamw_update`` writes through them in place, so a
loop over pods computes what the JAX package's ``vmap`` computes. Each pod's f32
gradients are freed before the next pod's backward, and the delta, its int8 form,
the new error feedback and the pod mean are formed one leaf at a time: at
qwen3-0.6b's full width the state alone is 30.8 GiB at two pods, and the whole
delta would be 5.6 GiB more.

``pod_free_plan`` is the JAX package's: sharding rules that leave the "pod"
mesh axis to the stacked pod dim. Not here: the branch of the JAX package's
round that all-gathers the int8 deltas across a "pod" mesh axis before the
mean, once the pods are devices of their own; on one card the pods are a loop
and the numbers are the same without it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.launch.steps import _loss_and_grads
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import compress_tree, dequantize_int8
from repro_torch.tree import (tree_flatten_sorted, tree_leaves, tree_map,
                               tree_unflatten_sorted)


def pod_free_plan(plan):
    """A MeshPlan whose rules never touch the "pod" axis: the stacked pod dim of
    the local-SGD state owns it."""
    from repro_torch.parallel.sharding import DEFAULT_RULES, MeshPlan
    base = dict(plan.rules or DEFAULT_RULES)
    rules = {k: tuple(a for a in v if a != "pod") for k, v in base.items()}
    return MeshPlan(mesh=plan.mesh, fsdp=plan.fsdp, sp=plan.sp, rules=rules)


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    inner_steps: int = 4          # H: pod-local steps per sync round
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    nesterov: bool = True
    compress: bool = True         # int8 + error feedback on the pod-axis exchange


def _stacked(p: torch.Tensor, n_pods: int, dtype: torch.dtype) -> torch.Tensor:
    """``n_pods`` copies of ``p`` along a new leading dim, cast to ``dtype``."""
    out = torch.empty((n_pods,) + tuple(p.shape), dtype=dtype, device=p.device)
    return out.copy_(p.detach())


def init_local_sgd_state(params: dict, n_pods: int) -> dict:
    """params: the unstacked (bf16) tree. Builds the pod-stacked working copies;
    both masters are cast from ``params``, as in the JAX package."""
    zeros = lambda p, lead=(): torch.zeros(lead + tuple(p.shape), dtype=torch.float32,  # noqa: E731
                                           device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "pod_params": tree_map(lambda p: _stacked(p, n_pods, p.dtype), params),
        "pod_opt": {
            "m": tree_map(lambda p: zeros(p, (n_pods,)), params),
            "v": tree_map(lambda p: zeros(p, (n_pods,)), params),
            "master": tree_map(lambda p: _stacked(p, n_pods, torch.float32), params),
            "step": torch.zeros((n_pods,), dtype=torch.int32, device=device),
        },
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "momentum": tree_map(zeros, params),
        "ef": tree_map(lambda p: zeros(p, (n_pods,)), params),
        "round": torch.zeros((), dtype=torch.int32, device=device),
    }


def inner_steps(model: Model, inner_cfg: AdamWConfig, cfg: LocalSGDConfig, state: dict,
                batches: Dict[str, torch.Tensor]) -> None:
    """The round's H pod-local AdamW steps, pod by pod, in place on ``state``'s
    pod_params and pod_opt; batch leaves [H, n_pods, B/n_pods, ...]."""
    pod_params, pod_opt = state["pod_params"], state["pod_opt"]
    for h in range(cfg.inner_steps):
        for p in range(pod_opt["step"].shape[0]):
            view = lambda t: t[p]  # noqa: E731
            params = tree_map(view, pod_params)
            _, grads = _loss_and_grads(model, params, {k: v[h, p] for k, v in batches.items()})
            opt = {"m": tree_map(view, pod_opt["m"]), "v": tree_map(view, pod_opt["v"]),
                   "master": tree_map(view, pod_opt["master"]), "step": pod_opt["step"][p]}
            _, new_opt, _ = adamw_update(params, tree_unflatten_sorted(params, grads), opt,
                                         inner_cfg)
            pod_opt["step"][p] = new_opt["step"]
            del grads


@torch.no_grad()
def outer_step(state: dict, cfg: LocalSGDConfig) -> torch.Tensor:
    """The pod-mean delta of the pods' masters from the global master, compressed
    with error feedback where ``cfg.compress``, then the outer (Nesterov) step,
    leaf by leaf in the sorted flatten order; the new master is written back into
    every pod's params (cast to their dtype) and master. In place on ``state``'s
    master, momentum, ef and pods; ``round`` is not touched. Returns the norm of
    the mean delta."""
    mu, lr = cfg.outer_momentum, cfg.outer_lr
    P = state["pod_opt"]["step"].shape[0]
    sq = 0
    trees = (state["master"], state["momentum"], state["ef"], state["pod_opt"]["master"],
             state["pod_params"])
    for master, momentum, ef, pod_master, pod_params in zip(*(
            [leaf for _, leaf in tree_flatten_sorted(t)] for t in trees)):
        # pod delta (pseudo-gradient): start-of-round master minus local result
        total = None
        for p in range(P):
            d = master - pod_master[p]
            if cfg.compress:
                (q, s), new_ef = compress_tree(d, ef[p])
                ef[p].copy_(new_ef)
                del d, new_ef
                d = dequantize_int8(q, s)
            total = d if total is None else total.add_(d)
        mean = total.div_(P)
        momentum.mul_(mu).add_(mean)
        update = momentum * mu + mean if cfg.nesterov else momentum
        master.sub_(update * lr)
        del update
        sq = sq + torch.sum(torch.square(mean))
        pod_params.copy_(master)            # every pod, cast to the param dtype
        pod_master.copy_(master)
    return torch.sqrt(sq)


def make_round_fn(model: Model, inner_cfg: AdamWConfig, cfg: LocalSGDConfig):
    """round_fn(state, batches) -> (state, {"delta_norm"}), with batch leaves
    [H, n_pods, B/n_pods, ...]: ``inner_steps``, then ``outer_step``. Updates
    ``state``'s tensors in place and returns a state dict holding them, with
    ``round`` one higher (a new tensor)."""

    def round_fn(state: dict, batches: Dict[str, torch.Tensor]):
        lead = tuple(next(iter(batches.values())).shape[:2])
        want = (cfg.inner_steps, state["pod_opt"]["step"].shape[0])
        if lead != want:
            raise ValueError(f"round batches lead with {lead}, want [H, n_pods] = {want}")
        inner_steps(model, inner_cfg, cfg, state, batches)
        delta_norm = outer_step(state, cfg)
        return dict(state, round=state["round"] + 1), {"delta_norm": delta_norm}

    return round_fn


def dcn_bytes_per_round(params: dict, cfg: LocalSGDConfig) -> Tuple[int, int]:
    """(local_sgd_bytes, sync_dp_bytes_over_H_steps) crossing the pod boundary.

    Sync-DP all-reduces bf16 gradients every step (ring: ~2x payload); local SGD
    exchanges one int8 delta (+f32 scale/leaf) per H steps."""
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    payload = n_params + 4 * len(leaves) if cfg.compress else 4 * n_params
    sync_dp = cfg.inner_steps * 2 * n_params * 2   # H steps x ring 2x x bf16
    return 2 * payload, sync_dp
