"""The train step, twin of ``repro.launch.steps.make_train_step`` and
``init_train_state``.

``make_train_step(model, opt_cfg, M)`` returns ``train_step(state, batch) ->
(state, metrics)``: the gradient of ``model.loss_fn`` by autograd (the kernels'
autograd Functions on the card), cast to f32, then ``adamw_update``. With M > 1
the batch is reshaped to [M, B/M, ...], the f32 gradients of the microbatches are
summed and divided by M, and the loss is their mean. On one card the JAX
package's ``zero2_accum`` and sharding constraints are identities, so they are
not here; the JAX package's ``accum_dtype`` is its default, f32.

The params in ``state`` need not require grad: the step differentiates detached
views of them, and ``adamw_update`` writes the new values into the same tensors
in place, so the state is updated in place and returned.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.tree import tree_flatten_sorted, tree_unflatten_sorted


def _loss_and_grads(model: Model, params: dict, batch: Dict[str, torch.Tensor]):
    """(metrics, f32 grads in the sorted flatten order) of one loss_fn."""
    leaves = [p.detach().requires_grad_(True) for _, p in tree_flatten_sorted(params)]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tree_unflatten_sorted(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return metrics, [g.float() for g in grads]


def make_train_step(model: Model, opt_cfg: AdamWConfig, num_microbatches: int):
    """(state, batch) -> (state, metrics); grads accumulated over microbatches."""
    M = num_microbatches

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
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                loss_sum = loss_sum + m["loss"]
                tok_sum = tok_sum + m["tokens"]
            grads = [g / M for g in grads]
            metrics = {"loss": loss_sum / M, "tokens": tok_sum,
                       "aux_loss": torch.zeros((), dtype=torch.float32,
                                               device=grads[0].device)}
        new_params, new_opt, opt_metrics = adamw_update(
            params, tree_unflatten_sorted(params, grads), opt, opt_cfg)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    return train_step


def init_train_state(model: Model, seed: int) -> dict:
    params = model.init_params(seed)
    return {"params": params, "opt": init_opt_state(params)}
