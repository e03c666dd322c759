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

On a mesh (a ``DeviceMesh`` of ("pod", "data", "model") or ("data", "model")):
the state is DTensors laid out by ``launch/steps.py``'s
``local_sgd_state_specs``, the per-pod trees' leading dim split over "pod", so a
rank holds its ``n_pods / mesh["pod"]`` local pods' slice of every stacked leaf
(every pod where the mesh has no "pod" axis, or one of size 1: the JAX package's
``spmd_axis=None``). The rank runs its local pods in turn, as on one card, each
on its in-pod shards: the model's plan is ``pod_free_plan``'s, so its
collectives and the gradient reduction run on the rank's "data" and "model"
groups only and never across pods. The round's one collective across "pod" is
the exchange: each rank quantizes its pods' deltas (the scale the whole leaf's
absmax, MAX-reduced over the in-pod groups that split the leaf), all-gathers the
int8 values and the f32 scales over the "pod" group, and dequantizes and takes
the mean of all P pods locally, in pod order, as the JAX package's cell does, so
int8 is what crosses the boundary. Uncompressed, it is one all-reduce of the f32
delta sum over "pod". The delta norm sums its squares over the in-pod shards.

``pod_free_plan`` is the JAX package's: sharding rules that leave the "pod"
mesh axis to the stacked pod dim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.steps import _laid_out, _loss_and_grads
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import compress_leaf, dequantize_int8
from repro_torch.parallel.sharding import (DEFAULT_RULES, MeshPlan, as_dtensor, distribute,
                                           gather_along, mesh_shape, placements, reduce_from,
                                           sum_over)
from repro_torch.tree import (tree_flatten_sorted, tree_leaves, tree_map,
                               tree_unflatten_sorted)


def pod_free_plan(plan):
    """A MeshPlan whose rules never touch the "pod" axis: the stacked pod dim of
    the local-SGD state owns it."""
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


def init_local_sgd_state(params: dict, n_pods: int, mesh=None, specs=None) -> dict:
    """params: the unstacked (bf16) tree. Builds the pod-stacked working copies;
    both masters are cast from ``params``, as in the JAX package. On a
    ``DeviceMesh`` ``mesh``, with ``specs`` the state's layout
    (``local_sgd_state_specs``): DTensors, each rank building only its shards of
    its local pods from the whole ``params``, which every rank holds alike."""
    if isinstance(mesh, DeviceMesh):
        _, n_local = local_pods(mesh, n_pods)
        shards = tree_map(lambda p, s: distribute(p, mesh, s).to_local(), params,
                          specs["master"])
        local = init_local_sgd_state(shards, n_local)
        return tree_map(lambda t, s: _laid(t, mesh, s), local, specs)
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


def _laid(local: torch.Tensor, mesh, spec) -> DTensor:
    """A DTensor of this rank's shard ``local`` laid out under ``spec`` (the whole
    shape: each dim's local size times its splitting axes' sizes)."""
    sizes = mesh_shape(mesh)
    shape = list(local.shape)
    for d, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            shape[d] *= sizes[a]
    return as_dtensor(local, mesh, placements(mesh, spec), shape)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def local_pods(mesh, n_pods: int) -> Tuple[int, int]:
    """(the first pod this rank runs, how many): its 1/K run of the ``n_pods``
    where the mesh has a "pod" axis of K ranks, else all of them. Raises
    ``ValueError`` where K does not divide ``n_pods``."""
    K = mesh_shape(mesh).get("pod", 1)
    if n_pods % K:
        raise ValueError(f"{n_pods} pods over a 'pod' mesh axis of {K}: the axis must "
                         "divide the pods")
    index = mesh.get_local_rank("pod") if isinstance(mesh, DeviceMesh) and K > 1 else 0
    return index * (n_pods // K), n_pods // K


def _inner(pls: tuple, lead: int) -> tuple:
    """The placements of one [lead dims]-index of a tensor laid out by ``pls``: a
    split of a lead dim (the pods', "pod") dropped, the others' dims moved down."""
    return tuple(Shard(p.dim - lead) if p.is_shard() and p.dim >= lead else Replicate()
                 for p in pls)


def _index(t: torch.Tensor, *index: int) -> torch.Tensor:
    """``t[index]``: of a DTensor, this rank's local ``index`` (a local pod) as a
    DTensor of the unstacked shape on the same mesh (a view)."""
    if not isinstance(t, DTensor):
        return t[index]
    n = len(index)
    return as_dtensor(t.to_local()[index], t.device_mesh, _inner(tuple(t.placements), n),
                      t.shape[n:])


def split_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that split a DTensor leaf (none for a
    plain one)."""
    if not isinstance(t, DTensor):
        return ()
    mesh = t.device_mesh
    return tuple(mesh.mesh_dim_names[i] for i, pl in enumerate(t.placements)
                 if pl.is_shard() and mesh.size(i) > 1)


def _pod_batch(v: torch.Tensor, h: int, p: int, first: int) -> torch.Tensor:
    """Inner step h's batch leaf of local pod p: of a DTensor laid out over the
    pods (the cell's P(None, "pod", "data")), its local pod; of a plain [H, n_pods,
    ...] leaf, which every rank holds whole, the global pod ``first + p``."""
    if isinstance(v, DTensor):
        split = any(pl.is_shard(1) for pl in v.placements)
        return _index(v, h, p if split else first + p)
    return v[h, first + p]


def inner_steps(model: Model, inner_cfg: AdamWConfig, cfg: LocalSGDConfig, state: dict,
                batches: Dict[str, torch.Tensor], first: int = 0) -> None:
    """The round's H pod-local AdamW steps of this rank's local pods (the
    stacked state's local leading dim; global pods ``first`` on), pod by pod, in
    place on ``state``'s pod_params and pod_opt; batch leaves [H, n_pods,
    B/n_pods, ...]. On DTensor state each pod's gradients are summed over the
    batch axes of the model's pod-free plan ("data" at most)."""
    pod_params, pod_opt = state["pod_params"], state["pod_opt"]
    steps = _local(pod_opt["step"])
    for h in range(cfg.inner_steps):
        for p in range(steps.shape[0]):
            view = lambda t: _index(t, p)  # noqa: E731
            params = tree_map(view, pod_params)
            batch = {k: _pod_batch(v, h, p, first) for k, v in batches.items()}
            _, grads = _loss_and_grads(model, params, batch)
            if model.ranked:
                rows = next(iter(batch.values())).shape[0]
                grads = _laid_out(model, grads, params, model.batch_axes(rows),
                                  model.param_specs())
            opt = {"m": tree_map(view, pod_opt["m"]), "v": tree_map(view, pod_opt["v"]),
                   "master": tree_map(view, pod_opt["master"]), "step": steps[p]}
            _, new_opt, _ = adamw_update(params, tree_unflatten_sorted(params, grads), opt,
                                         inner_cfg)
            steps[p] = new_opt["step"]
            del grads


@torch.no_grad()
def outer_step(state: dict, cfg: LocalSGDConfig) -> torch.Tensor:
    """The pod-mean delta of the pods' masters from the global master, compressed
    with error feedback where ``cfg.compress``, then the outer (Nesterov) step,
    leaf by leaf in the sorted flatten order; the new master is written back into
    every pod's params (cast to their dtype) and master. In place on ``state``'s
    master, momentum, ef and pods; ``round`` is not touched. Returns the norm of
    the mean delta. On DTensor state (see the module docstring) each rank works on
    its shards of its local pods; the mean takes every pod's delta, all-gathered
    as int8 and scales (or all-reduced in f32) over the state's mesh's "pod"
    axis."""
    mu, lr = cfg.outer_momentum, cfg.outer_lr
    step = state["pod_opt"]["step"]
    P = step.shape[0]
    plan = MeshPlan(step.device_mesh if isinstance(step, DTensor) else None)
    sq: dict = {}                     # the squares' sums by the axes that split a leaf
    trees = (state["master"], state["momentum"], state["ef"], state["pod_opt"]["master"],
             state["pod_params"])
    for leaves in zip(*([leaf for _, leaf in tree_flatten_sorted(t)] for t in trees)):
        axes = split_axes(leaves[0])
        master, momentum, ef, pod_master, pod_params = (_local(t) for t in leaves)
        # pod delta (pseudo-gradient): start-of-round master minus local result
        total = None
        if cfg.compress:
            qs, scales = [], []
            for p in range(pod_master.shape[0]):
                q, s, new_ef = compress_leaf(master - pod_master[p], ef[p], plan, axes)
                ef[p].copy_(new_ef)
                del new_ef
                qs.append(q)
                scales.append(s)
            q = gather_along(torch.stack(qs), 0, plan, "pod")
            s = gather_along(torch.stack(scales), 0, plan, "pod")
            del qs
            for p in range(P):
                d = dequantize_int8(q[p], s[p])
                total = d if total is None else total.add_(d)
            del q
        else:
            for p in range(pod_master.shape[0]):
                d = master - pod_master[p]
                total = d if total is None else total.add_(d)
            total = reduce_from(total, plan, "pod")
        mean = total.div_(P)
        momentum.mul_(mu).add_(mean)
        update = momentum * mu + mean if cfg.nesterov else momentum
        master.sub_(update * lr)
        del update
        sq[axes] = sq.get(axes, 0) + torch.sum(torch.square(mean))
        pod_params.copy_(master)            # every pod, cast to the param dtype
        pod_master.copy_(master)
    return torch.sqrt(sum(sum_over(value, plan, axes) for axes, value in sq.items()))


def make_round_fn(model: Model, inner_cfg: AdamWConfig, cfg: LocalSGDConfig):
    """round_fn(state, batches) -> (state, {"delta_norm"}), with batch leaves
    [H, n_pods, B/n_pods, ...] (plain and whole on every rank, or DTensors laid out
    over the pods): ``inner_steps`` of this rank's local pods, then
    ``outer_step``, whose exchange runs over the "pod" axis of the model's mesh.
    Updates ``state``'s tensors in place and returns a state dict holding them,
    with ``round`` one higher (a new tensor)."""
    mesh = model.plan.mesh
    if mesh_shape(mesh).get("pod", 1) > 1 and any(
            "pod" in axes for axes in (model.plan.rules or DEFAULT_RULES).values()):
        raise ValueError("a local-SGD round over a 'pod' axis needs a model on a pod-free "
                         "plan (pod_free_plan): its collectives must stay inside a pod")

    def round_fn(state: dict, batches: Dict[str, torch.Tensor]):
        lead = tuple(next(iter(batches.values())).shape[:2])
        want = (cfg.inner_steps, state["pod_opt"]["step"].shape[0])
        if lead != want:
            raise ValueError(f"round batches lead with {lead}, want [H, n_pods] = {want}")
        first, _ = local_pods(mesh, want[1])
        inner_steps(model, inner_cfg, cfg, state, batches, first)
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
