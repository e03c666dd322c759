"""Op accounting of one step on fake tensors (the dry-run's "profiler"), twin of
``repro.roofline.hlo_stats``.

PyTorch has no HLO. The counter is a ``TorchDispatchMode`` over one call of a
cell's step under ``FakeTensorMode``, on CPU fake tensors built from the cell's
``TensorDef`` arguments: nothing is computed and no device is used. A CPU tensor
takes the kernels' plain PyTorch versions through the port's unchanged dispatch,
so the step runs as on the CPU, shapes only.

Every number is PER DEVICE, for the whole step. On one card that is the step;
on a mesh (a ``DeviceMesh`` over a process group: real ranks, or the fake
process group of ``launch/mesh.py``'s ``fake_world``, on which the production
meshes of 256 and 512 ranks run shapes only) it is this rank's share. The
arguments are then DTensors, each leaf a fake local shard laid out by the
cell's ``in_shardings``, and every op is counted on local tensors: an op on
DTensors is left to DTensor's own dispatch, whose local ops and redistributing
collectives reach the counter in turn (the global-shape ops that DTensor's
sharding propagation runs to learn its output's metadata are recognised and
not counted). It counts:

  * flops        - dot products (aten.mm, addmm, bmm, baddbmm) by
                   ``torch.utils.flop_counter``'s formulas; the backward and the
                   remat recompute as they run. Elementwise work is ignored, as
                   hlo_stats ignores it. A plain version that states its
                   kernel's flops (``kernels/region.py``; K1's: its kept
                   (query, key) pairs, where the plain version forms every
                   masked block) counts that in place of its own dot products.
  * dot_flops    - every dot product as the plain path runs it, masked blocks
                   included: hlo_stats' count of the same step, for parity.
  * hbm_bytes    - per op: result bytes + unique operand bytes (hlo_stats'
                   convention; a broadcast dim counts once); views and bare
                   allocations move nothing. Split into ``framework_bytes`` and
                   ``kernel_bytes``: while a kernel's plain version runs (see
                   ``kernels/region.py``), its ops' bytes are kernel-internal (on
                   the card they stay in shared memory and registers, as VMEM
                   tiles do under the Pallas kernels), and the call's own inputs
                   and outputs count once as framework bytes.
  * peak_bytes   - the peak of live storage bytes over the call, inputs and
                   outputs included, followed by weak references to the fake
                   storages; a storage that a plain kernel forms and drops does
                   not count. The twin of ``memory_analysis``.
  * collectives  - every c10d call (``dist.all_reduce``, ``dist.all_gather``),
                   functional collective and DTensor redistribution the step
                   issues: its opcode in hlo_stats' names, the operand bytes this
                   device sends, and whether its group crosses a pod boundary
                   (its global ranks span more than one pod, pod = rank //
                   ``pod_size``: ``groups_cross_pod``'s rule). One card has none.

``measure`` counts a call on real tensors the same way (no fake tensors), so
that a run on real ranks can be held against the fake group's count.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import region
from repro_torch.models.params import TensorDef
from repro_torch.tree import _seq, tree_leaves, tree_map

aten = torch.ops.aten
_DOTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
# ops that allocate or reinterpret without moving bytes (besides every view op)
_FREE = (aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh)

# c10d's and the functional collectives' ops (by name, in either namespace) ->
# hlo_stats' opcode; the ops that send nothing (waits, barriers, receives) are
# not collectives here
_COLLECTIVES = {
    **dict.fromkeys(("allreduce_", "allreduce_coalesced_", "all_reduce", "all_reduce_",
                     "all_reduce_coalesced", "all_reduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("allgather_", "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_", "all_gather_into_tensor",
                     "all_gather_into_tensor_coalesced", "all_gather_into_tensor_out"),
                    "all-gather"),
    **dict.fromkeys(("reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_", "reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced", "reduce_scatter_tensor_out"),
                    "reduce-scatter"),
    **dict.fromkeys(("alltoall_", "alltoall_base_", "all_to_all_single"), "all-to-all"),
    **dict.fromkeys(("send", "isend"), "collective-permute"),
    **dict.fromkeys(("broadcast_", "broadcast"), "collective-broadcast"),
}
_SILENT = {"wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier_",
           "check_for_nan", "recv_", "recv_any_source_", "irecv"}
_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
# the schema argument that holds what a device sends, the first one present
_OPERAND_ARGS = ("input_tensors", "input_tensor", "input", "inputs", "input_list",
                 "tensors", "tensor")
_PORT = str(Path(__file__).resolve().parents[1])
# frames that issue collectives for others: the op's name is their caller's
_RELAYS = tuple(str(Path(_PORT, m)) for m in ("parallel/sharding.py", "roofline/op_stats.py"))


@dataclasses.dataclass
class CollectiveRecord:
    opcode: str
    bytes: int          # operand bytes this device sends, x executions
    cross_pod: bool
    op_name: str
    count: int


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    dot_flops: float = 0.0
    framework_bytes: float = 0.0
    kernel_bytes: float = 0.0
    peak_bytes: int = 0
    ops: int = 0
    collectives: List[CollectiveRecord] = dataclasses.field(default_factory=list)

    @property
    def hbm_bytes(self) -> float:
        return self.framework_bytes + self.kernel_bytes

    @property
    def collective_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives)

    @property
    def cross_pod_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives if c.cross_pod)

    @property
    def in_pod_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives if not c.cross_pod)

    def by_opcode(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.collectives:
            key = c.opcode + (":dcn" if c.cross_pod else ":ici")
            out[key] = out.get(key, 0) + c.bytes
        return out

    def top_collectives(self, n: int = 12) -> List[dict]:
        merged: Dict[Tuple[str, str, bool], Tuple[int, int]] = {}
        for c in self.collectives:
            k = (c.opcode, c.op_name, c.cross_pod)
            b, cnt = merged.get(k, (0, 0))
            merged[k] = (b + c.bytes, cnt + c.count)
        rows = [{"opcode": k[0], "op_name": k[1][:120],
                 "link": "dcn" if k[2] else "ici", "bytes": v[0], "count": v[1]}
                for k, v in merged.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:n]

    def collective_counts(self) -> Dict[Tuple[str, str, int], int]:
        """{(opcode, link, operand bytes): how many}: the collectives as a run
        issued them, for holding one count against another."""
        out: Dict[Tuple[str, str, int], int] = {}
        for c in self.collectives:
            key = (c.opcode, "dcn" if c.cross_pod else "ici", c.bytes // c.count)
            out[key] = out.get(key, 0) + c.count
        return out


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list:
    """The tensors of a tree, each DTensor as this rank's local tensor."""
    return [_local(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    """Bytes of t's elements, a broadcast (stride-0) dim counted once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _unique_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        seen.setdefault(id(t), t)
    return sum(nbytes(t) for t in seen.values())


def _group_ranks(func, args, kwargs) -> List[int]:
    """The global ranks of a collective's process group."""
    from torch.distributed.distributed_c10d import ProcessGroup, _resolve_process_group
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    if "group_name" in bound:
        return dist.get_process_group_ranks(_resolve_process_group(bound["group_name"]))
    pg = bound["process_group"]
    if not isinstance(pg, ProcessGroup):
        pg = ProcessGroup.unbox(pg)
    return dist.get_process_group_ranks(pg)


def groups_cross_pod(ranks, pod_size: Optional[int]) -> bool:
    """True if a group's global ranks span more than one pod (pod = rank //
    ``pod_size``; None or 0: one pod, nothing crosses)."""
    return bool(pod_size) and len({r // pod_size for r in ranks}) > 1


def _caller() -> str:
    """file:line function of the port's frame that asked for the collective."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PORT):
            here = f"{name[len(_PORT) + 1:]}:{f.f_lineno} {f.f_code.co_name}"
            first = first or here
            if not name.startswith(_RELAYS):
                return here
        f = f.f_back
    return first or "?"


class _Counter(TorchDispatchMode):
    """Counts flops, bytes, live storage and collectives of every op on this
    rank's tensors; also the listener of the plain kernels' regions."""

    def __init__(self, pod_size: Optional[int] = None):
        super().__init__()
        self.stats = OpStats()
        self.pod_size = pod_size
        self.live = 0
        self.depth = 0
        self.stated = False          # the open region stated its kernel's flops
        self.storages = {}           # id(storage) -> [nbytes, counted in live]
        self.shadow = []             # global metas of a DTensor op's propagation args

    # ------------------------------------------------------------- live storage
    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.storages:
            return
        counted = self.depth == 0
        self.storages[key] = [st.nbytes(), counted]
        weakref.finalize(st, self._freed, key)
        if counted:
            self._grow(st.nbytes())

    def _freed(self, key) -> None:
        n, counted = self.storages.pop(key)
        if counted:
            self.live -= n

    def _grow(self, n: int) -> None:
        self.live += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.live)

    # --------------------------------------------------------- kernel regions
    def enter(self, args, kwargs, flops) -> None:
        if self.depth == 0:
            self.stats.framework_bytes += _unique_bytes(_tensors((args, kwargs)))
            self.stated = flops is not None
            if self.stated:
                self.stats.flops += flops
        self.depth += 1

    def exit(self, out) -> None:
        self.depth -= 1
        if self.depth or out is None:
            return
        outs = _tensors(out)
        self.stats.framework_bytes += _unique_bytes(outs)
        for t in outs:               # the call's outputs are live from here on
            entry = self.storages.get(id(t.untyped_storage()))
            if entry is None:
                self.track(t)
            elif not entry[1]:
                entry[1] = True
                self._grow(entry[0])

    # ------------------------------------------------------------- collectives
    def collective(self, func, args, kwargs) -> None:
        name = func._schema.name.split("::")[-1]
        opcode = _COLLECTIVES.get(name)
        if opcode is None:
            if name in _SILENT:
                return
            raise NotImplementedError(f"the dry-run does not know the collective {func}")
        names = [a.name for a in func._schema.arguments]
        bound = dict(zip(names, args), **kwargs)
        operand = bound[next(a for a in _OPERAND_ARGS if a in bound)]
        sent = sum(t.numel() * t.element_size() for t in tree_leaves(operand)
                   if isinstance(t, torch.Tensor))
        cross = groups_cross_pod(_group_ranks(func, args, kwargs), self.pod_size)
        self.stats.collectives.append(CollectiveRecord(
            opcode, sent, cross, f"{func.overloadpacket.__name__} {_caller()}", 1))

    # ------------------------------------------------ DTensor's metadata shadows
    def _is_shadow(self, func, ins, outs) -> bool:
        """Whether an op only serves DTensor's sharding propagation, which runs an
        op on DTensors once at their global shapes (``empty_strided`` arguments of
        the DTensors' global metadata) to learn its output's; those tensors are
        marked and every op on them is a shadow too."""
        if any(getattr(t, "_dryrun_shadow", False) for t in ins):
            for t in outs:
                t._dryrun_shadow = True
            return True
        if func is aten.empty_strided.default and not ins and self.shadow:
            t = outs[0]
            meta = (tuple(t.shape), tuple(t.stride()), t.dtype)
            if meta in self.shadow:
                self.shadow.remove(meta)
                t._dryrun_shadow = True
                return True
        self.shadow = []
        return False

    # -------------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            # DTensor's dispatch runs the op on the local tensors, redistributing
            # first where it must; the counter hears each of those ops in turn
            self.shadow = [(tuple(t.shape), tuple(t.stride()), t.dtype) for t in leaves
                           if isinstance(t, torch.Tensor)]
            return NotImplemented
        if func.namespace in _NAMESPACES:
            self.collective(func, args, kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs or all(t.device.type == "meta" for t in outs):
            return out               # a query of metadata, or a tensor of it only
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        if self._is_shadow(func, ins, outs):
            return out
        st = self.stats
        st.ops += 1
        packet = func.overloadpacket
        if packet in _DOTS:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            st.dot_flops += n
            if not (self.depth and self.stated):
                st.flops += n
        if not (func.is_view or packet in _FREE):
            moved = _unique_bytes(outs) + _unique_bytes(ins)
            if self.depth:
                st.kernel_bytes += moved
            else:
                st.framework_bytes += moved
        for t in outs:
            self.track(t)
        return out


def _zip_defs(fn, abstract, shardings):
    """``fn(TensorDef, its placements)`` over an abstract tree and the placement
    tree of the same structure (a placement tuple is a leaf of the latter)."""
    if isinstance(abstract, TensorDef):
        return fn(abstract, shardings)
    if isinstance(abstract, dict):
        return {k: _zip_defs(fn, abstract[k], shardings[k]) for k in abstract}
    if _seq(abstract):
        return type(abstract)(_zip_defs(fn, a, s) for a, s in zip(abstract, shardings))
    return abstract


def _fake_like(abstract, mesh=None, shardings=None) -> Any:
    """Tensors of the ``TensorDef`` leaves' shapes and dtypes, on the CPU (fake
    tensors inside ``FakeTensorMode``); with a mesh and a placement tree, each a
    DTensor of this rank's shard."""
    if mesh is None:
        return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype)
                        if isinstance(d, TensorDef) else d, abstract)
    return _zip_defs(lambda d, pls: distribute_tensor(
        torch.empty(d.shape, dtype=d.dtype), mesh, pls, src_data_rank=None),
        abstract, shardings)


def measure(fn, args: tuple, pod_size: Optional[int] = None):
    """(``fn(*args)``, its ``OpStats``) on the tensors given, real or fake; the
    arguments count as live storage from the start. A collective crosses a pod
    where its ranks span more than one block of ``pod_size`` (None: none
    crosses)."""
    counter = _Counter(pod_size)
    for t in _tensors(args):
        counter.track(t)
    with region.listening(counter), counter:
        out = fn(*args)
    return out, counter.stats


def call_stats(fn, abstract_args: tuple, mesh=None, shardings=None,
               pod_size: Optional[int] = None) -> OpStats:
    """``OpStats`` of ``fn(*args)`` on fake tensors of ``abstract_args``'s
    ``TensorDef`` leaves (DTensors of this rank's shards where a mesh and the
    arguments' placements are given). The arguments count as live storage from
    the start."""
    with FakeTensorMode(allow_non_fake_inputs=False):
        args = _fake_like(abstract_args, mesh, shardings)
        out, stats = measure(fn, args, pod_size)
        del out, args
    return stats


def pod_size(mesh) -> Optional[int]:
    """Ranks a pod of a ``DeviceMesh`` over the default group (its "pod" axis
    leads, so pod p holds the p-th run of ranks); None off a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        return None
    names = mesh.mesh_dim_names or ()
    pods = mesh.size(names.index("pod")) if "pod" in names else 1
    return mesh.size() // pods


def cell_stats(cell) -> OpStats:
    """``OpStats`` of one call of ``cell.fn`` on its abstract arguments, per device
    (on a ``DeviceMesh``, this rank's shards by the cell's ``in_shardings``). The
    cell must be built on the CPU (``build_cell(..., device="cpu")``)."""
    if cell.model.device.type != "cpu":
        raise ValueError(f"{cell.name}: the dry-run runs on CPU fake tensors; build the "
                         f"cell with device='cpu'")
    size = pod_size(cell.mesh)
    if size is None:
        return call_stats(cell.fn, cell.abstract_args)
    return call_stats(cell.fn, cell.abstract_args, cell.mesh, cell.in_shardings, size)


def stats_to_json(st: OpStats) -> dict:
    """The JSON record; the JAX package's field names wherever a field exists in
    both."""
    return {
        "flops": st.flops,
        "dot_flops": st.dot_flops,
        "hbm_bytes": st.hbm_bytes,
        "framework_bytes": st.framework_bytes,
        "kernel_bytes": st.kernel_bytes,
        "peak_bytes": st.peak_bytes,
        "collective_bytes": st.collective_bytes,
        "cross_pod_bytes": st.cross_pod_bytes,
        "in_pod_bytes": st.in_pod_bytes,
        "by_opcode": st.by_opcode(),
        "top_collectives": st.top_collectives(),
        "ops": st.ops,
    }
