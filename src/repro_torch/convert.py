"""Convert a JAX-package parameter tree, or train state, into the port's.

The caller hands over the tree as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); this module imports neither
jax nor the JAX package. Names and shapes map 1:1 (``models.params``). bf16
arrives as numpy's ml_dtypes ``bfloat16`` and goes through its uint16 bits, so
no value is rounded on the way. A train state ``{params, opt: {m, v, master,
step}}`` (``repro.launch.steps.init_train_state``'s layout, which the port's
``launch.steps`` shares) converts leaf by leaf, so both packages can start a
step from the same state; so does a local-SGD state
(``repro.optim.local_sgd.init_local_sgd_state``'s layout, which the port's
``optim.local_sgd`` shares).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.tree import tree_flatten_sorted, tree_leaves, tree_map


def _to_tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.array(x)          # an owned, writable copy for torch.from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def to_torch(tree, device="cuda"):
    """Nested dicts/tuples of numpy arrays -> the same tree of tensors on ``device``."""
    dev = devices.resolve(device)
    return tree_map(lambda x: _to_tensor(x, dev), tree)


def train_state_to_torch(state: dict, device="cuda") -> dict:
    """A JAX train state {params, opt: {m, v, master, step}} of numpy arrays ->
    the port's train state on ``device``; checks its layout and dtypes (f32 m,
    v and master of the params' shapes, int32 step)."""
    if set(state) != {"params", "opt"} or set(state["opt"]) != {"m", "v", "master", "step"}:
        raise ValueError(f"not a train state {{params, opt: {{m, v, master, step}}}}: "
                         f"keys {sorted(state)}, opt {sorted(state.get('opt', {}))}")
    out = to_torch(state, device)
    shapes = tree_map(lambda t: t.shape, out["params"])
    for name in ("m", "v", "master"):
        if tree_map(lambda t: t.shape, out["opt"][name]) != shapes or any(
                t.dtype != torch.float32 for t in tree_leaves(out["opt"][name])):
            raise ValueError(f"opt/{name} must be f32 of the params' shapes")
    if out["opt"]["step"].dtype != torch.int32 or out["opt"]["step"].dim():
        raise ValueError("opt/step must be an int32 scalar")
    return out


_LOCAL_SGD_KEYS = {"pod_params", "pod_opt", "master", "momentum", "ef", "round"}


def local_sgd_state_to_torch(state: dict, device="cuda") -> dict:
    """A JAX local-SGD state {pod_params, pod_opt: {m, v, master, step}, master,
    momentum, ef, round} of numpy arrays -> the port's on ``device``; checks its
    layout and dtypes: pod_params [P, ...], f32 pod m, v, master and ef of their
    shapes, an int32 step [P], f32 master and momentum of the unstacked shapes,
    an int32 round scalar."""
    if set(state) != _LOCAL_SGD_KEYS or set(state["pod_opt"]) != {"m", "v", "master", "step"}:
        raise ValueError(f"not a local-SGD state {sorted(_LOCAL_SGD_KEYS)} with pod_opt "
                         f"{{m, v, master, step}}: keys {sorted(state)}, pod_opt "
                         f"{sorted(state.get('pod_opt', {}))}")
    out = to_torch(state, device)
    shapes = lambda tree: {p: tuple(t.shape) for p, t in tree_flatten_sorted(tree)}  # noqa: E731
    pods = shapes(out["pod_params"])
    n_pods = {s[0] if s else None for s in pods.values()}
    if len(n_pods) != 1 or None in n_pods:
        raise ValueError(f"pod_params must all lead with one pod dim: {sorted(n_pods, key=str)}")
    unstacked = {p: s[1:] for p, s in pods.items()}
    for name, tree, want in (("pod_opt/m", out["pod_opt"]["m"], pods),
                             ("pod_opt/v", out["pod_opt"]["v"], pods),
                             ("pod_opt/master", out["pod_opt"]["master"], pods),
                             ("ef", out["ef"], pods), ("master", out["master"], unstacked),
                             ("momentum", out["momentum"], unstacked)):
        if shapes(tree) != want or any(t.dtype != torch.float32 for t in tree_leaves(tree)):
            raise ValueError(f"{name} must be f32 of the "
                             f"{'pod params' if want is pods else 'unstacked params'}' shapes")
    step = out["pod_opt"]["step"]
    if step.dtype != torch.int32 or tuple(step.shape) != (n_pods.pop(),):
        raise ValueError("pod_opt/step must be int32 [n_pods]")
    if out["round"].dtype != torch.int32 or out["round"].dim():
        raise ValueError("round must be an int32 scalar")
    return out
