"""Logical-axis sharding rules over the (pod, data, model) mesh, twin of
``repro.parallel.sharding``.

Every tensor dimension carries a *logical* axis name; ``MeshPlan`` maps logical
names to mesh axes by the JAX package's rules, drops the mesh axes a dimension
cannot divide and never uses a mesh axis on two dimensions, so ``MeshPlan.spec``
gives the JAX package's ``PartitionSpec`` entries for the same rules, logical axes
and shape. Only the "pod" axis crosses the slow boundary between pods: the rules
keep every per-layer collective on the in-pod axes.

A plan's mesh is one of three things:
  * a torch ``DeviceMesh`` with named dims (``launch/mesh.py``): a tensor on it is
    a DTensor, laid out by the placements ``MeshPlan.sharding`` gives;
  * a ``OneDeviceMesh``, the mesh of one device that needs no process group
    (``make_test_mesh`` where none is initialised): every placement on it is the
    identity and a tensor on it is a plain tensor, as an array on the JAX
    package's one-device mesh is one buffer;
  * any object whose ``shape`` maps axis names to sizes in mesh order (a test's
    ``FakeMesh``): the spec math at the production shapes, with no ranks.

Placements: for each mesh dim, in mesh order, ``Shard(d)`` where that mesh axis
shards tensor dim d, else ``Replicate()``. A dim over several mesh axes (``("pod",
"data")``) is ``Shard(d)`` on each of them, which DTensor lays out major to minor
in mesh order: JAX's layout when the spec lists them in mesh order, as every rule
set here does. A spec that lists a dim's axes in another order, or names an axis
the mesh lacks, raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# logical axis -> preferred mesh axes (in order; trailing axes dropped if not divisible)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": (),                 # activations: sequence stays unsharded unless SP
    "seq_sp": ("model",),      # residual-stream sequence parallelism
    "cache_seq": ("model",),   # decode KV/state cache: shard time dim on model axis
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "ffn_nofsdp": (),
    "ssm_heads": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": ("data",),        # FSDP: weight-embed dim over the in-pod data axis
    "embed_nofsdp": (),
    "layers": (),              # the stacked-layers dimension
    "state": (),
    "conv": (),
    "qk_depth": (),
    "capacity": (),
    None: (),
}

# optimizer-state override: ZeRO, the FSDP dim spread over the pod axis as well
OPT_RULES = dict(DEFAULT_RULES, embed=("pod", "data"))

# pure data parallelism + ZeRO for small models: batch over every axis, weights
# ZeRO-sharded over (data, model), no tensor parallelism
DP_ONLY_RULES = dict(
    DEFAULT_RULES,
    batch=("pod", "data", "model"),
    heads=(), kv_heads=(), ffn=(), ssm_heads=(),
    vocab=(),
    embed=("data", "model"),
    cache_seq=(),
)


def opt_rules_for(base: dict) -> dict:
    """ZeRO optimizer rules derived from any base rule set: spread the weight
    embed dim over the pod axis in addition to the base axes."""
    embed = tuple(dict.fromkeys(("pod",) + tuple(base.get("embed", ()))))
    return dict(base, embed=embed)


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: a tuple with one entry per
    leading tensor dim, each ``None``, a mesh-axis name or a tuple of names;
    trailing ``None`` entries are dropped by ``MeshPlan.spec``. A leaf of the
    port's trees (``repro_torch.tree``)."""
    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class OneDeviceMesh:
    """The mesh of one device, with no process group behind it: a tensor on it is
    a plain tensor on ``device`` and every placement is the identity."""
    device: torch.device
    mesh_dim_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {a: 1 for a in self.mesh_dim_names}


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh, in mesh order."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    if mesh.mesh_dim_names is None:
        raise ValueError(f"{mesh} has unnamed dims; a plan's mesh names every dim")
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A mesh plus the policy switches that pick sharding rules."""
    mesh: Any
    fsdp: bool = True          # shard weight embed dims over "data" (ZeRO-3 style)
    sp: bool = False           # sequence-parallel residual stream (hillclimb switch)
    bf16_reduce: bool = False  # bf16 partial-sum dots -> bf16 TP all-reduces
    moe_combine_reshard: bool = False  # a2a slot buffers before combine gather
    rules: Optional[dict] = None

    @property
    def reduce_dtype(self):
        """The dtype of the partial sums of dots whose sums cross tensor-parallel
        shards: bf16 with ``bf16_reduce``, else None (the dot's own)."""
        return torch.bfloat16 if self.bf16_reduce else None

    def axis_size(self, name: str) -> int:
        return mesh_shape(self.mesh).get(name, 1)

    def _mesh_axes_for(self, logical: Optional[str],
                       rules: Optional[dict] = None,
                       is_opt: bool = False) -> Tuple[str, ...]:
        rules = rules if rules is not None else (self.rules or DEFAULT_RULES)
        if logical == "embed" and not self.fsdp and not is_opt:
            logical = "embed_nofsdp"
        if logical == "seq" and self.sp:
            logical = "seq_sp"
        axes = rules.get(logical, ())
        shape = mesh_shape(self.mesh)
        return tuple(a for a in axes if a in shape)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             rules: Optional[dict] = None, is_opt: bool = False) -> PartitionSpec:
        """PartitionSpec for a tensor; drops mesh axes a dim can't divide and never
        reuses a mesh axis across dims."""
        entries = []
        used = set()
        for d, logical in enumerate(logical_axes):
            axes = tuple(a for a in self._mesh_axes_for(logical, rules, is_opt)
                         if a not in used)
            if shape is not None and axes:
                kept = []
                prod = 1
                for a in axes:
                    n = self.axis_size(a)
                    if shape[d] % (prod * n) == 0:
                        kept.append(a)
                        prod *= n
                    else:
                        break
                axes = tuple(kept)
            used.update(axes)
            entries.append(axes if len(axes) != 1 else axes[0])
        cleaned = [e if e != () else None for e in entries]
        while cleaned and cleaned[-1] is None:
            cleaned.pop()
        return PartitionSpec(*cleaned)

    def opt_spec(self, logical_axes, shape=None) -> PartitionSpec:
        """PartitionSpec for optimizer state (ZeRO over the pod axis)."""
        base = self.rules or DEFAULT_RULES
        return self.spec(logical_axes, shape, rules=opt_rules_for(base), is_opt=True)

    def sharding(self, logical_axes, shape=None) -> tuple:
        """The DTensor placements of ``spec(logical_axes, shape)`` on the mesh."""
        return placements(self.mesh, self.spec(logical_axes, shape))


def placements(mesh, spec: PartitionSpec) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where the spec puts that mesh axis on
    tensor dim d, else ``Replicate()``. Raises ``ValueError`` for an axis the mesh
    lacks, an axis used twice, or a dim whose axes are out of mesh order."""
    names = list(mesh_shape(mesh))
    dim_of = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec} is not in the mesh {tuple(names)}")
            if a in dim_of:
                raise ValueError(f"mesh axis {a!r} is used on two dims in {spec}")
            dim_of[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"{spec}: dim {d} lists its mesh axes {axes} out of the mesh's order "
                f"{tuple(names)}; DTensor lays a dim's shards out major to minor in mesh "
                "order only")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def distribute(x: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """``x`` laid out on ``mesh`` under ``spec``, the port's
    ``jax.device_put(x, NamedSharding(mesh, spec))``; values are kept bit for bit.

    Onto a ``OneDeviceMesh`` the result is a plain tensor on its device (a DTensor
    is gathered first). A DTensor already on ``mesh`` is redistributed; one on
    another mesh is gathered (``full_tensor``, a collective over the ranks of its
    mesh) and laid out anew. A plain tensor is taken to hold the whole value on
    every rank, as a gathered one does: each rank keeps its own shard, with no
    communication. A rank outside ``mesh`` gets a DTensor with no local data."""
    if isinstance(mesh, OneDeviceMesh):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.to(mesh.device)
    target = placements(mesh, spec)
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, target)
        x = x.full_tensor()
    return distribute_tensor(x.to(mesh.device_type), mesh, target, src_data_rank=None)


def logical_spec(plan: MeshPlan, logical_axes, shape=None) -> PartitionSpec:
    return plan.spec(logical_axes, shape)


def constrain(x: torch.Tensor, plan: MeshPlan, logical_axes) -> torch.Tensor:
    """A DTensor redistributed to the placements of its logical axes on the plan's
    mesh (shape-aware, as ``spec``); a plain tensor as it is, as JAX's
    ``with_sharding_constraint`` leaves an array on one device."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(plan.mesh, plan.sharding(logical_axes, x.shape))


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
