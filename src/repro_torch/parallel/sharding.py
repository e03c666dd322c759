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

Tensor parallelism over "model" (the forward, loss, backward, prefill and decode
of every family, ``models/layers.py``, ``models/ssm.py``, ``models/moe.py`` and
``models/model.py``; the moe family's experts split over "model" as the JAX
package's "experts" rule lays them): the layers
run on each rank's local shards, plain tensors, and call the collectives below
at the JAX package's ``constrain`` sites, on the process group of this rank's
line along one mesh axis (``axis_group``). Autograd goes through
``torch.autograd.Function`` pairs, Megatron-LM's f and g operators:
``copy_to`` (identity forward, all-reduce of the gradient backward) where a
replicated tensor enters a split region, ``reduce_from`` (all-reduce forward,
identity backward) where a split region's partial sums leave it, and
``gather_along`` (all-gather along a dim forward, the local slice backward).
``sum_over`` is ``reduce_from`` over several axes: the sum over the batch axes
of a statistic every rank forms from its rows (the loss's token count and CE,
the MoE routing counts and probability sums), whose gradient each rank takes as
it is, its rows' share.
Every collective returns its input, and launches nothing, where the plan's mesh
is not a ``DeviceMesh`` or the axis has size 1: on one card, or a one-rank mesh,
the layers run the one-card code op for op. A row-parallel product's partial
sums (``reduce_partial``) are reduced in f32 and cast back once, or in bf16 under
``plan.bf16_reduce``: the dtype the JAX package names by
``preferred_element_type=plan.reduce_dtype``. ``TensorParallel`` says which
dims of a model's weights a rank holds a 1/M shard of; ``local_range``
gives a spec's index range of a dim on this rank, and ``relayout`` moves a
local shard between two layouts of one value (a view where the new layout only
splits the old one further).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
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


# ------------------------------------------------ tensor parallelism: the collectives
def axis_group(plan: MeshPlan, axis: str):
    """The process group of this rank's line along ``axis`` of the plan's mesh;
    None where the mesh is not a ``DeviceMesh``, lacks the axis or has it of size
    1 (every collective over it is then the identity)."""
    mesh = plan.mesh
    if not isinstance(mesh, DeviceMesh) or axis not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def axis_index(plan: MeshPlan, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 off a ``DeviceMesh``)."""
    mesh = plan.mesh
    if not isinstance(mesh, DeviceMesh) or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


class _CopyTo(torch.autograd.Function):
    """Megatron-LM's f: identity forward, the gradient all-reduced backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron-LM's g: the partial sums all-reduced forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    """The shards of the axis' ranks concatenated along ``dim`` forward; this
    rank's slice of the gradient backward (the consumer is replicated)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.lo, ctx.n = dim, r * x.shape[dim], x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


def copy_to(x: torch.Tensor, plan: MeshPlan, axis: str = "model") -> torch.Tensor:
    """``x`` as it is forward; its gradient summed over ``axis`` backward."""
    group = axis_group(plan, axis)
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, plan: MeshPlan, axis: str = "model") -> torch.Tensor:
    """``x`` summed over ``axis`` forward; the gradient as it is backward."""
    group = axis_group(plan, axis)
    return x if group is None else _ReduceFrom.apply(x, group)


def reduce_partial(part: torch.Tensor, plan: MeshPlan, axis: str = "model") -> torch.Tensor:
    """A row-parallel product's partial sums summed over ``axis``: in f32 and cast
    back to ``part``'s dtype once, or in bf16 under ``plan.bf16_reduce``."""
    if axis_group(plan, axis) is None:
        return part
    return reduce_from(part.to(plan.reduce_dtype or torch.float32), plan, axis).to(part.dtype)


def gather_along(x: torch.Tensor, dim: int, plan: MeshPlan, axis: str = "model") -> torch.Tensor:
    """The axis' shards of ``x`` concatenated along ``dim`` in rank order."""
    group = axis_group(plan, axis)
    return x if group is None else _GatherAlong.apply(x, dim, group)


def max_over(x: torch.Tensor, plan: MeshPlan, axis: str = "model") -> torch.Tensor:
    """The elementwise max over ``axis`` (no gradient)."""
    group = axis_group(plan, axis)
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def sum_over(x: torch.Tensor, plan: MeshPlan, axes) -> torch.Tensor:
    """``reduce_from`` over each of ``axes`` in turn: the sum over their ranks."""
    for axis in axes:
        x = reduce_from(x, plan, axis)
    return x


def local_range(plan: MeshPlan, spec: PartitionSpec, dim: int, size: int) -> Tuple[int, int]:
    """[start, stop) of this rank's shard of dim ``dim`` (of ``size``) under
    ``spec``: the dim's mesh axes index its shards major to minor in mesh order."""
    entry = spec[dim] if dim < len(spec) else None
    axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
    index, n = 0, 1
    for a in axes:
        k = plan.axis_size(a)
        index, n = index * k + axis_index(plan, a), n * k
    chunk = size // n
    return index * chunk, (index + 1) * chunk


def _split_dims(mesh, pls) -> Dict[int, list]:
    """{tensor dim: the mesh dims of size > 1 that shard it, in mesh order}."""
    out: Dict[int, list] = {}
    for i, p in enumerate(pls):
        if p.is_shard() and mesh.size(i) > 1:
            out.setdefault(p.dim, []).append(i)
    return out


def splits_further(mesh, src: tuple, dst: tuple) -> bool:
    """Whether the placements ``dst`` only split further what ``src`` splits:
    each tensor dim's sharding mesh dims (of size > 1) under ``src`` lead its list
    under ``dst``, so each rank's ``dst`` shard lies inside its ``src`` shard."""
    a, b = _split_dims(mesh, src), _split_dims(mesh, dst)
    return all(b.get(d, [])[:len(dims)] == dims for d, dims in a.items())


def relayout(local: torch.Tensor, mesh, shape, src: tuple, dst: tuple) -> torch.Tensor:
    """This rank's shard of a value of global ``shape`` laid out by the placements
    ``src``, as laid out by ``dst``. Where ``dst`` only splits further what ``src``
    splits (each dim's sharding mesh dims of ``src`` lead its list in ``dst``;
    mesh dims of size 1 split nothing) the result is a view of ``local``; else
    the value moves through DTensor's collectives. Every rank takes the same
    branch."""
    if not splits_further(mesh, src, dst):
        return as_dtensor(local, mesh, src, shape).redistribute(mesh, dst).to_local()
    a, b = _split_dims(mesh, src), _split_dims(mesh, dst)
    coord = mesh.get_coordinate()
    out = local
    for d, dims in b.items():
        n, index = local.shape[d], 0
        for i in dims[len(a.get(d, [])):]:
            n //= mesh.size(i)
            index = index * mesh.size(i) + coord[i]
        if n != local.shape[d]:
            out = out.narrow(d, index * n, n)
    return out


def as_dtensor(local: torch.Tensor, mesh, pls: tuple, shape) -> DTensor:
    """A DTensor of global ``shape`` from this rank's shard under ``pls`` (no
    communication)."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(local, mesh, tuple(pls), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def full_value(x: torch.Tensor) -> torch.Tensor:
    """The whole value of ``x`` on this rank: a DTensor gathered (on a one-rank
    mesh its local tensor, with no collective), a plain tensor as it is. Even
    shards are gathered with c10d's ``all_gather``, a mesh dim at a time from the
    minor one (DTensor lays a dim's shards out major to minor in mesh order):
    DTensor's own gather (``full_tensor``, through the functional collectives)
    crashes on a gloo group holding CUDA tensors, as two ranks sharing one card
    are; other placements go through ``full_tensor``."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    if mesh.size() == 1:
        return x.to_local()
    out, pls = x.to_local(), x.placements
    n = {}
    for i, pl in enumerate(pls):
        if pl.is_shard():
            n[pl.dim] = n.get(pl.dim, 1) * mesh.size(i)
        elif not pl.is_replicate():
            return x.full_tensor()
    if any(out.shape[d] * k != x.shape[d] for d, k in n.items()):
        return x.full_tensor()
    for i in reversed(range(mesh.ndim)):
        if pls[i].is_shard() and mesh.size(i) > 1:
            parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
            dist.all_gather(parts, out.contiguous(), group=mesh.get_group(i))
            out = torch.cat(parts, dim=pls[i].dim)
    return out


# the weights' logical dims that tensor parallelism splits over "model"
TP_LOGICALS = ("heads", "kv_heads", "ffn", "vocab", "ssm_heads", "experts")


def compute_spec(plan: MeshPlan, logical, shape) -> PartitionSpec:
    """The layout the layers compute on: ``plan.spec``'s "model" split of a
    ``TP_LOGICALS`` dim kept, every other split gathered."""
    spec = plan.spec(logical, shape)
    entries = []
    for d, log in enumerate(logical):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        entries.append("model" if log in TP_LOGICALS and "model" in axes else None)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """How a model's layers split over the "model" axis of ``plan``'s mesh, which
    has ``size`` > 1 ranks: each flag says whether a rank holds 1/size of that dim
    of the weights (a dim the axis does not divide stays whole, as
    ``MeshPlan.spec`` drops the axis); ``rank`` is this rank's index along it.
    ``heads``, ``kv_heads`` and ``ffn`` are those of the attention and the MLP
    (every stack's: the dense layers, the hybrid's shared block, the encoder's
    and the decoder's layers and cross-attention, the vlm's self and cross
    layers; they split alike); ``ssm`` says that a mamba2
    block splits both its d_inner ("ffn") and its heads ("ssm_heads"), which a
    rank then holds 1/size of, in step: where the axis divides only one of them
    the block is not split, and every rank holds and computes the whole.
    ``experts`` says that a rank holds 1/size of each MoE layer's experts (their
    three weights and the router's columns), the run ``expert_range`` gives; where
    the axis does not divide the experts every rank holds and computes them all.
    The moe family's ``ffn`` is that of its shared experts' MLP."""
    plan: MeshPlan
    heads: bool
    kv_heads: bool
    ffn: bool
    vocab: bool
    ssm: bool = False
    experts: bool = False

    @property
    def size(self) -> int:
        return self.plan.axis_size("model")

    @property
    def rank(self) -> int:
        return axis_index(self.plan, "model")

    def expert_range(self, num_experts: int) -> Tuple[int, int]:
        """(first, count) of the experts this rank holds: its 1/size run where
        ``experts``, else all of them."""
        if not self.experts:
            return 0, num_experts
        n = num_experts // self.size
        return self.rank * n, n
