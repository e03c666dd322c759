"""Train / prefill / decode steps and the cells, per (arch x shape), twin of
``repro.launch.steps``.

``build_cell`` is the single entry the dry-run uses (``launch/dryrun.py``): it
binds (ArchConfig, ShapeSpec, mesh, CellOptions) to a step function, its
abstract arguments (``TensorDef`` trees that hold no memory) and the shardings
of its arguments and results on the mesh, built as the JAX package's are.

Step semantics per the assignment:
  * train_4k     -> train_step(state, batch)          fwd+bwd+AdamW, microbatched
  * prefill_32k  -> prefill_step(params, batch)       KV/state cache build
  * decode_32k   -> decode_step(params, tokens, cache) one token, cache written in place
  * long_500k    -> decode_step (sub-quadratic archs only)

A cell's ``mesh`` and ``plan`` (``parallel/sharding.py``) are the JAX cell's;
its ``in_shardings`` and ``out_shardings`` are trees of DTensor placements
(``named``) where the JAX cell's are ``NamedSharding``s. The mesh defaults to
``make_test_mesh``'s: one device without a process group, where every placement
is the identity (the Titchener cell's has a "pod" axis of one). Nothing is
compiled, so the JAX cell's ``jitted`` and ``lower`` are not here.

``make_train_step(model, opt_cfg, M)`` returns ``train_step(state, batch) ->
(state, metrics)``: the gradient of ``model.loss_fn`` by autograd (the kernels'
autograd Functions on the card), then ``adamw_update``. With M > 1 the batch is
reshaped to [M, B/M, ...], the microbatches' gradients are summed in
``accum_dtype`` and divided by M in f32, and the loss is their mean. The params
in ``state`` need not require grad: the step differentiates detached views of
them, and ``adamw_update`` writes the new values into the same tensors in place,
so the state is updated in place and returned.

On DTensor params (every family on a ``DeviceMesh``, twin of the JAX
package's step on a mesh; every leaf alike, the moe family's experts, router and
shared experts included): each rank differentiates its
compute shards (``Model.shard_params``) on its rows of the batch (a
microbatch's frames or patches cut with its tokens); the local
gradients are accumulated over the microbatches in ``accum_dtype`` as on one
card, summed over the batch axes (``Model._rows``' axes) and laid out as DTensors
on the params' placements (a view: the compute layout splits no more than
theirs), which ``adamw_update`` reads in the optimizer's layout. With
``zero2_accum`` each microbatch's gradients are summed over the batch axes and
accumulated in the optimizer's (ZeRO) layout instead, as the JAX step lays its
accumulator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_is_runnable, token_inputs
from repro_torch.launch.mesh import make_test_mesh, n_pods
from repro_torch.models.model import Model
from repro_torch.models.params import TensorDef, abstract_params, param_defs, partition_specs
from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state, adamw_update,
                                     init_opt_state, opt_state_specs)
from repro_torch.parallel.sharding import (DP_ONLY_RULES, MeshPlan, P, as_dtensor, mesh_shape,
                                           placements, relayout, sum_over)
from repro_torch.tree import tree_flatten_sorted, tree_map, tree_unflatten_sorted


@dataclasses.dataclass(frozen=True)
class CellOptions:
    """Hillclimb knobs. Defaults = the paper-faithful baseline configuration.

    The JAX package's fields, names and defaults, so that a ``--set`` line and an
    artifact's ``options`` read the same in both packages. ``fsdp``, ``sp``,
    ``bf16_reduce``, ``dp_only`` (``DP_ONLY_RULES``, and one microbatch) and
    ``moe_combine_reshard`` pick the cell's ``MeshPlan`` as in the JAX package,
    and so its specs and shardings; ``zero2_accum`` lays the gradient
    accumulator out by the optimizer's rules (the step's ``accum_specs``). On one
    device every layout they pick is the identity.
    """
    fsdp: bool = True
    sp: bool = False                   # sequence-parallel residual stream
    bf16_reduce: bool = False          # bf16 partial-sum dots / TP all-reduces
    dp_only: bool = False              # batch over ALL axes, no TP (small models)
    moe_combine_reshard: bool = False  # a2a slot buffers before MoE combine
    titchener: bool = False            # one local-SGD round (train cells)
    num_microbatches: int = 0          # 0 = auto (see _auto_microbatches)
    remat: Optional[str] = None        # override ArchConfig.remat
    accum_dtype: str = "float32"
    capacity_factor: float = 0.0       # >0 overrides the MoE capacity factor
    loss_chunk: int = 0                # >0: chunked CE (see Model._chunked_ce)
    packed_decode: bool = False        # GQA decode attn w/o repeat/f32 copy
    zero2_accum: bool = False          # opt-sharded (pod-spread) grad accum
    donate: bool = True
    extra: Tuple[Tuple[str, Any], ...] = ()   # free-form knob ledger


def _auto_microbatches(cfg: ArchConfig, spec: ShapeSpec) -> int:
    if spec.step != "train":
        return 1
    # keep live activations ~O(layers x mb x seq x d_model)
    return 8 if spec.global_batch >= 64 else 1


# ------------------------------------------------------------------------- shardings
def batch_pspecs(plan: MeshPlan, cfg: ArchConfig, inputs: Dict[str, TensorDef]) -> dict:
    logical = {
        "tokens": ("batch", "seq"),
        "targets": ("batch", "seq"),
        "loss_mask": ("batch", "seq"),
        "frames": ("batch", None, None),
        "patches": ("batch", None, None),
    }
    return {k: plan.spec(logical[k], v.shape) for k, v in inputs.items()}


def named(mesh, tree):
    """A spec tree as a tree of the DTensor placements each spec lays out on
    ``mesh`` (the JAX package's ``NamedSharding`` tree)."""
    return tree_map(lambda s: placements(mesh, s), tree)


# ----------------------------------------------------------------------- train step
def _loss_and_grads(model: Model, params: dict, batch: Dict[str, torch.Tensor]):
    """(metrics, f32 grads in the sorted flatten order) of one loss_fn; on DTensor
    params, of this rank's compute shards and rows, not yet summed over ranks."""
    local = model.shard_params(params)
    leaves = [p.detach().requires_grad_(True) for _, p in tree_flatten_sorted(local)]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tree_unflatten_sorted(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return metrics, [g.float() for g in grads]


def _laid_out(model: Model, grads: list, params: dict, axes: tuple, specs: dict) -> list:
    """This rank's compute-shard gradients summed over the batch ``axes``, as
    DTensors on ``specs``' placements (views of the sums)."""
    mesh = model.plan.mesh
    flat = [p for _, p in tree_flatten_sorted(params)]
    out = []
    for g, p, (_, c), (_, s) in zip(grads, flat, tree_flatten_sorted(model.compute_specs()),
                                    tree_flatten_sorted(specs)):
        g = sum_over(g, model.plan, axes)
        dst = placements(mesh, s)
        out.append(as_dtensor(relayout(g, mesh, p.shape, placements(mesh, c), dst), mesh, dst,
                              p.shape))
    return out


def _microbatches(v: torch.Tensor, M: int):
    """A batch leaf [B, ...] as M microbatches [B/M, ...]: of a plain leaf, its M
    runs of rows; of a DTensor laid out by rows, the M runs of each rank's own
    rows, as DTensors of the same placements (no communication)."""
    if not isinstance(v, DTensor):
        return v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
    local = v.to_local()
    if local.shape[0] % M:
        raise ValueError(f"{local.shape[0]} local rows are not a multiple of {M} microbatches")
    parts = local.reshape((M, local.shape[0] // M) + tuple(local.shape[1:]))
    shape = (v.shape[0] // M,) + tuple(v.shape[1:])
    return [as_dtensor(parts[i], v.device_mesh, tuple(v.placements), shape) for i in range(M)]


def make_train_step(model: Model, opt_cfg: AdamWConfig, num_microbatches: int,
                    accum_dtype: str = "float32", zero2_accum: bool = False):
    """(state, batch) -> (state, metrics); grads accumulated over microbatches.
    The returned function carries ``num_microbatches`` and ``accum_specs``, the
    layout of the gradient accumulator on the model's mesh: the optimizer state's
    (ZeRO-2, pod-spread) with ``zero2_accum``, else the params'."""
    M = num_microbatches
    acc_dt = getattr(torch, accum_dtype)
    accum_specs = (
        tree_map(lambda d: model.plan.opt_spec(d.logical, d.shape), param_defs(model.cfg))
        if zero2_accum else model.param_specs())

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        params, opt = state["params"], state["opt"]
        ranked = isinstance(params["embed"], DTensor)
        B = next(iter(batch.values())).shape[0]
        axes = model.batch_axes(B // max(M, 1)) if ranked else ()
        zero2 = ranked and zero2_accum and M > 1
        if M <= 1:
            metrics, grads = _loss_and_grads(model, params, batch)
        else:
            if B % M:
                raise ValueError(f"batch {B} is not a multiple of {M} microbatches")
            mb = {k: _microbatches(v, M) for k, v in batch.items()}
            grads, loss_sum, tok_sum = None, 0.0, 0.0
            for i in range(M):
                m, g = _loss_and_grads(model, params, {k: v[i] for k, v in mb.items()})
                if zero2:       # summed over the batch axes into the ZeRO layout now
                    g = [t.to_local() for t in _laid_out(model, g, params, axes, accum_specs)]
                if grads is None:
                    grads = [gi.to(acc_dt) for gi in g]
                else:
                    for a, gi in zip(grads, g):
                        a.add_(gi.to(acc_dt))
                del g
                loss_sum = loss_sum + m["loss"]
                tok_sum = tok_sum + m["tokens"]
            grads = [g.float().div_(M) for g in grads]
            metrics = {"loss": loss_sum / M, "tokens": tok_sum,
                       "aux_loss": torch.zeros((), dtype=torch.float32,
                                               device=grads[0].device)}
        if zero2:
            mesh = model.plan.mesh
            grads = [as_dtensor(g, mesh, placements(mesh, s), p.shape) for g, (_, s), (_, p)
                     in zip(grads, tree_flatten_sorted(accum_specs), tree_flatten_sorted(params))]
        elif ranked:
            grads = _laid_out(model, grads, params, axes, model.param_specs())
        new_params, new_opt, opt_metrics = adamw_update(
            params, tree_unflatten_sorted(params, grads), opt, opt_cfg)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    train_step.num_microbatches = M
    train_step.accum_specs = accum_specs
    return train_step


def train_state_specs(cfg: ArchConfig, plan: MeshPlan) -> dict:
    return {"params": partition_specs(cfg, plan), "opt": opt_state_specs(cfg, plan)}


def abstract_train_state(cfg: ArchConfig) -> dict:
    return {"params": abstract_params(cfg), "opt": abstract_opt_state(cfg)}


def init_train_state(model: Model, seed: int) -> dict:
    """The initial train state from ``seed``; on a ``DeviceMesh``
    (``Model.ranked``), laid out by
    ``train_state_specs`` (DTensors: each rank draws the whole state and keeps its
    shards)."""
    params = model.init_params(seed)
    state = {"params": params, "opt": init_opt_state(params)}
    if not model.ranked:
        return state
    from repro_torch.parallel.sharding import distribute
    return tree_map(lambda x, s: distribute(x, model.plan.mesh, s), state,
                    train_state_specs(model.cfg, model.plan))


# --------------------------------------------------------------------------- serving
def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params: dict, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            return model.prefill(params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params: dict, tokens: torch.Tensor, cache: dict):
        with torch.no_grad():
            return model.decode_step(params, tokens, cache)
    return decode_step


# ------------------------------------------------------- Titchener local-SGD cell
def local_sgd_state_specs(cfg: ArchConfig, plan: MeshPlan) -> dict:
    """The local-SGD state's layout, twin of the JAX Titchener cell's
    ``state_specs``: the per-pod trees P("pod", *specs) (their stacked pod dim
    over "pod") and the pods' steps P("pod"), the global master and momentum by
    the pod-free plan's param specs, ``round`` replicated. On a mesh without a
    "pod" axis the pod dim is whole (every rank holds every pod)."""
    from repro_torch.optim.local_sgd import pod_free_plan
    pspecs = partition_specs(cfg, pod_free_plan(plan))
    pod = "pod" if "pod" in mesh_shape(plan.mesh) else None

    def stack(t):
        return tree_map(lambda s: P(pod, *s), t)

    return {
        "pod_params": stack(pspecs),
        "pod_opt": {"m": stack(pspecs), "v": stack(pspecs), "master": stack(pspecs),
                    "step": P(pod)},
        "master": pspecs,
        "momentum": pspecs,
        "ef": stack(pspecs),
        "round": P(),
    }


def _build_titchener_cell(cfg: ArchConfig, spec: ShapeSpec, mesh, plan: MeshPlan,
                          opts: CellOptions, opt_cfg: AdamWConfig, device) -> "Cell":
    """One local-SGD ROUND (H pod-local AdamW steps + the compressed exchange of
    the pods' deltas) instead of one sync step. The round consumes the same
    tokens as one baseline step (H x Bp x P x seq = global_batch x seq). The pods
    are the mesh's "pod" axis (one on one device); the per-pod trees lead with a
    pod dim sharded on it (``local_sgd_state_specs``), the batches P(None, "pod",
    "data"), as the JAX package's; the round exchanges the int8 deltas over the
    mesh's "pod" group."""
    from repro_torch.optim.local_sgd import LocalSGDConfig, make_round_fn, pod_free_plan
    extra = dict(opts.extra)
    P_pods = n_pods(mesh)
    H = int(extra.get("inner_steps", 8))
    lcfg = LocalSGDConfig(inner_steps=H, compress=bool(extra.get("compress", True)))
    model = Model(cfg, device, pod_free_plan(plan))
    round_fn = make_round_fn(model, opt_cfg, lcfg)

    params_abs = abstract_params(cfg)
    f32 = torch.float32

    def stack_abs(t, dtype=None):
        return tree_map(lambda a: TensorDef((P_pods,) + a.shape, dtype or a.dtype), t)

    state_abs = {
        "pod_params": stack_abs(params_abs),
        "pod_opt": {"m": stack_abs(params_abs, f32), "v": stack_abs(params_abs, f32),
                    "master": stack_abs(params_abs, f32),
                    "step": TensorDef((P_pods,), torch.int32)},
        "master": tree_map(lambda a: TensorDef(a.shape, f32), params_abs),
        "momentum": tree_map(lambda a: TensorDef(a.shape, f32), params_abs),
        "ef": stack_abs(params_abs, f32),
        "round": TensorDef((), torch.int32),
    }
    state_specs = local_sgd_state_specs(cfg, plan)
    Bp = spec.global_batch // (P_pods * H)
    assert Bp >= 1, "global batch too small for H x pods"
    lead = (H, P_pods, Bp, spec.seq_len)
    batches_abs = {"tokens": TensorDef(lead, torch.int32),
                   "targets": TensorDef(lead, torch.int32),
                   "loss_mask": TensorDef(lead, torch.bfloat16)}
    batch_specs = {k: P(None, "pod", "data") for k in batches_abs}
    in_sh = (named(mesh, state_specs), named(mesh, batch_specs))
    out_sh = (named(mesh, state_specs), {"delta_norm": placements(mesh, P())})
    return Cell(cfg=cfg, spec=spec, mesh=mesh, plan=plan, model=model, opts=opts,
                fn=round_fn, abstract_args=(state_abs, batches_abs), in_shardings=in_sh,
                out_shardings=out_sh, donate_argnums=(0,) if opts.donate else ())


# ------------------------------------------------------------------------- the cell
@dataclasses.dataclass
class Cell:
    """Everything needed to run or dry-run one (arch x shape x mesh) combination."""
    cfg: ArchConfig
    spec: ShapeSpec
    mesh: Any
    plan: MeshPlan
    model: Model
    opts: CellOptions
    fn: Any                       # the step callable
    abstract_args: tuple          # TensorDef trees of fn's arguments
    in_shardings: tuple           # placement trees of fn's arguments
    out_shardings: Any            # placement trees of fn's results
    donate_argnums: tuple         # arguments the step writes in place

    @property
    def name(self) -> str:
        return f"{self.cfg.name}/{self.spec.name}"


def build_cell(arch, shape: str, opts: CellOptions = CellOptions(),
               opt_cfg: AdamWConfig = AdamWConfig(), device="cuda", mesh=None) -> Cell:
    """The cell of (arch, shape) on ``mesh`` (default: ``make_test_mesh``'s, with
    a "pod" axis for the Titchener round)."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    if opts.remat is not None:
        cfg = dataclasses.replace(cfg, remat=opts.remat)
    if opts.capacity_factor > 0:
        cfg = dataclasses.replace(cfg, capacity_factor=opts.capacity_factor)
    if opts.loss_chunk > 0:
        cfg = dataclasses.replace(cfg, loss_chunk=opts.loss_chunk)
    if opts.packed_decode:
        cfg = dataclasses.replace(cfg, packed_decode=True)
    spec = SHAPES[shape]
    skip = cell_is_runnable(cfg, shape)
    if skip:
        raise ValueError(f"cell {cfg.name}/{shape} not runnable: {skip}")
    titchener = opts.titchener and spec.step == "train"
    if mesh is None:
        mesh = (make_test_mesh((1, 1, 1), ("pod", "data", "model"), device=device)
                if titchener else make_test_mesh(device=device))
    plan = MeshPlan(mesh=mesh, fsdp=opts.fsdp, sp=opts.sp, bf16_reduce=opts.bf16_reduce,
                    moe_combine_reshard=opts.moe_combine_reshard,
                    rules=DP_ONLY_RULES if opts.dp_only else None)
    if titchener:
        return _build_titchener_cell(cfg, spec, mesh, plan, opts, opt_cfg, device)
    model = Model(cfg, device, plan)
    inputs = token_inputs(cfg, spec)
    in_pspecs = batch_pspecs(plan, cfg, inputs)
    B, S = spec.global_batch, spec.seq_len

    if spec.step == "train":
        # dp_only runs the whole batch in one shot, as the JAX package's does
        M = 1 if opts.dp_only else (opts.num_microbatches or _auto_microbatches(cfg, spec))
        fn = make_train_step(model, opt_cfg, M, accum_dtype=opts.accum_dtype,
                             zero2_accum=opts.zero2_accum)
        st_specs = train_state_specs(cfg, plan)
        abstract = (abstract_train_state(cfg), inputs)
        in_sh = (named(mesh, st_specs), named(mesh, in_pspecs))
        out_sh = (named(mesh, st_specs),
                  {k: placements(mesh, P())
                   for k in ("loss", "tokens", "aux_loss", "grad_norm", "lr")})
        donate = (0,) if opts.donate else ()
    else:
        logits_sh = placements(mesh, plan.spec(("batch", "vocab"), (B, cfg.vocab_size)))
        cache_sh = named(mesh, model.cache_specs(B, S))
        params_sh = named(mesh, partition_specs(cfg, plan))
        out_sh = (logits_sh, cache_sh)
        if spec.step == "prefill":
            fn = make_prefill_step(model, max_len=S)
            abstract = (abstract_params(cfg), inputs)
            in_sh = (params_sh, named(mesh, in_pspecs))
            donate = ()
        else:  # decode
            fn = make_decode_step(model)
            abstract = (abstract_params(cfg), inputs["tokens"], model.abstract_cache(B, S))
            in_sh = (params_sh, placements(mesh, in_pspecs["tokens"]), cache_sh)
            donate = (2,) if opts.donate else ()
    return Cell(cfg=cfg, spec=spec, mesh=mesh, plan=plan, model=model, opts=opts, fn=fn,
                abstract_args=abstract, in_shardings=in_sh, out_shardings=out_sh,
                donate_argnums=donate)
