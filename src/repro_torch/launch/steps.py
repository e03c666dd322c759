"""Train / prefill / decode steps and the cells, per (arch x shape), twin of
``repro.launch.steps``.

``build_cell`` is the single entry the dry-run uses (``launch/dryrun.py``): it
binds (ArchConfig, ShapeSpec, CellOptions) to a step function and its abstract
arguments, ``TensorDef`` trees that hold no memory.

Step semantics per the assignment:
  * train_4k     -> train_step(state, batch)          fwd+bwd+AdamW, microbatched
  * prefill_32k  -> prefill_step(params, batch)       KV/state cache build
  * decode_32k   -> decode_step(params, tokens, cache) one token, cache written in place
  * long_500k    -> decode_step (sub-quadratic archs only)

One card has no mesh: a cell has no shardings and nothing is compiled, so the
JAX cell's ``mesh``, ``plan``, ``in_shardings``, ``out_shardings``, ``jitted``
and ``lower`` are not here.

``make_train_step(model, opt_cfg, M)`` returns ``train_step(state, batch) ->
(state, metrics)``: the gradient of ``model.loss_fn`` by autograd (the kernels'
autograd Functions on the card), then ``adamw_update``. With M > 1 the batch is
reshaped to [M, B/M, ...], the microbatches' gradients are summed in
``accum_dtype`` and divided by M in f32, and the loss is their mean. The params
in ``state`` need not require grad: the step differentiates detached views of
them, and ``adamw_update`` writes the new values into the same tensors in place,
so the state is updated in place and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_is_runnable, token_inputs
from repro_torch.models.model import Model
from repro_torch.models.params import TensorDef, abstract_params
from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state, adamw_update,
                                     init_opt_state)
from repro_torch.tree import tree_flatten_sorted, tree_map, tree_unflatten_sorted


@dataclasses.dataclass(frozen=True)
class CellOptions:
    """Hillclimb knobs. Defaults = the paper-faithful baseline configuration.

    The JAX package's fields, names and defaults, so that a ``--set`` line and an
    artifact's ``options`` read the same in both packages. These act here:
    ``num_microbatches``, ``remat``, ``accum_dtype``, ``capacity_factor``,
    ``loss_chunk``, ``packed_decode``, ``titchener``, ``donate`` and ``extra``.
    ``fsdp``, ``sp``, ``bf16_reduce``, ``dp_only``, ``moe_combine_reshard`` and
    ``zero2_accum`` pick sharding rules, the identity on one card: they are
    recorded only, except that ``dp_only`` still forces one microbatch.
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


# ----------------------------------------------------------------------- train step
def _loss_and_grads(model: Model, params: dict, batch: Dict[str, torch.Tensor]):
    """(metrics, f32 grads in the sorted flatten order) of one loss_fn."""
    leaves = [p.detach().requires_grad_(True) for _, p in tree_flatten_sorted(params)]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tree_unflatten_sorted(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return metrics, [g.float() for g in grads]


def make_train_step(model: Model, opt_cfg: AdamWConfig, num_microbatches: int,
                    accum_dtype: str = "float32"):
    """(state, batch) -> (state, metrics); grads accumulated over microbatches.
    The returned function carries ``num_microbatches``."""
    M = num_microbatches
    acc_dt = getattr(torch, accum_dtype)

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        params, opt = state["params"], state["opt"]
        if M <= 1:
            metrics, grads = _loss_and_grads(model, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch {B} is not a multiple of {M} microbatches")
            mb = {k: v.reshape((M, B // M) + tuple(v.shape[1:])) for k, v in batch.items()}
            grads, loss_sum, tok_sum = None, 0.0, 0.0
            for i in range(M):
                m, g = _loss_and_grads(model, params, {k: v[i] for k, v in mb.items()})
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
        new_params, new_opt, opt_metrics = adamw_update(
            params, tree_unflatten_sorted(params, grads), opt, opt_cfg)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    train_step.num_microbatches = M
    return train_step


def abstract_train_state(cfg: ArchConfig) -> dict:
    return {"params": abstract_params(cfg), "opt": abstract_opt_state(cfg)}


def init_train_state(model: Model, seed: int) -> dict:
    params = model.init_params(seed)
    return {"params": params, "opt": init_opt_state(params)}


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
def _build_titchener_cell(cfg: ArchConfig, spec: ShapeSpec, opts: CellOptions,
                          opt_cfg: AdamWConfig, device) -> "Cell":
    """One local-SGD ROUND (H pod-local AdamW steps + the compressed exchange of
    the pods' deltas) instead of one sync step. The round consumes the same
    tokens as one baseline step (H x Bp x P x seq = global_batch x seq). One card
    has no "pod" axis: one pod, as on the JAX package's (data, model) mesh."""
    from repro_torch.optim.local_sgd import LocalSGDConfig, make_round_fn
    extra = dict(opts.extra)
    P_pods = 1
    H = int(extra.get("inner_steps", 8))
    lcfg = LocalSGDConfig(inner_steps=H, compress=bool(extra.get("compress", True)))
    model = Model(cfg, device)
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
    Bp = spec.global_batch // (P_pods * H)
    assert Bp >= 1, "global batch too small for H x pods"
    lead = (H, P_pods, Bp, spec.seq_len)
    batches_abs = {"tokens": TensorDef(lead, torch.int32),
                   "targets": TensorDef(lead, torch.int32),
                   "loss_mask": TensorDef(lead, torch.bfloat16)}
    return Cell(cfg=cfg, spec=spec, model=model, opts=opts, fn=round_fn,
                abstract_args=(state_abs, batches_abs),
                donate_argnums=(0,) if opts.donate else ())


# ------------------------------------------------------------------------- the cell
@dataclasses.dataclass
class Cell:
    """Everything needed to run or dry-run one (arch x shape) combination."""
    cfg: ArchConfig
    spec: ShapeSpec
    model: Model
    opts: CellOptions
    fn: Any                       # the step callable
    abstract_args: tuple          # TensorDef trees of fn's arguments
    donate_argnums: tuple         # arguments the step writes in place

    @property
    def name(self) -> str:
        return f"{self.cfg.name}/{self.spec.name}"


def build_cell(arch, shape: str, opts: CellOptions = CellOptions(),
               opt_cfg: AdamWConfig = AdamWConfig(), device="cuda") -> Cell:
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
    if opts.titchener and spec.step == "train":
        return _build_titchener_cell(cfg, spec, opts, opt_cfg, device)
    model = Model(cfg, device)
    inputs = token_inputs(cfg, spec)
    B, S = spec.global_batch, spec.seq_len

    if spec.step == "train":
        # dp_only runs the whole batch in one shot, as the JAX package's does
        M = 1 if opts.dp_only else (opts.num_microbatches or _auto_microbatches(cfg, spec))
        fn = make_train_step(model, opt_cfg, M, accum_dtype=opts.accum_dtype)
        abstract = (abstract_train_state(cfg), inputs)
        donate = (0,) if opts.donate else ()
    elif spec.step == "prefill":
        fn = make_prefill_step(model, max_len=S)
        abstract = (abstract_params(cfg), inputs)
        donate = ()
    else:  # decode
        fn = make_decode_step(model)
        abstract = (abstract_params(cfg), inputs["tokens"], model.abstract_cache(B, S))
        donate = (2,) if opts.donate else ()
    return Cell(cfg=cfg, spec=spec, model=model, opts=opts, fn=fn, abstract_args=abstract,
                donate_argnums=donate)
