"""Op accounting of one step on fake tensors (the dry-run's "profiler"), twin of
``repro.roofline.hlo_stats``.

PyTorch has no HLO. The counter is a ``TorchDispatchMode`` over one call of a
cell's step under ``FakeTensorMode``, on CPU fake tensors built from the cell's
``TensorDef`` arguments: nothing is computed and no device is used. A CPU tensor
takes the kernels' plain PyTorch versions through the port's unchanged dispatch,
so the step runs as on the CPU, shapes only. It counts, for the whole step on
one card:

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
  * collectives  - none on one card: ``collective_bytes``, ``cross_pod_bytes``
                   and ``in_pod_bytes`` are 0.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import region
from repro_torch.models.params import TensorDef
from repro_torch.tree import tree_leaves, tree_map

aten = torch.ops.aten
_DOTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
# ops that allocate or reinterpret without moving bytes (besides every view op)
_FREE = (aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh)


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    dot_flops: float = 0.0
    framework_bytes: float = 0.0
    kernel_bytes: float = 0.0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def hbm_bytes(self) -> float:
        return self.framework_bytes + self.kernel_bytes

    collective_bytes = cross_pod_bytes = in_pod_bytes = 0


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


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


class _Counter(TorchDispatchMode):
    """Counts flops, bytes and live storage of every op; also the listener of the
    plain kernels' regions."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self.live = 0
        self.depth = 0
        self.stated = False          # the open region stated its kernel's flops
        self.storages = {}           # id(storage) -> [nbytes, counted in live]

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

    # -------------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:                 # a query of metadata (a device, a size)
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
            moved = _unique_bytes(outs) + _unique_bytes(_tensors((args, kwargs)))
            if self.depth:
                st.kernel_bytes += moved
            else:
                st.framework_bytes += moved
        for t in outs:
            self.track(t)
        return out


def _fake_like(abstract) -> Any:
    """Tensors of the ``TensorDef`` leaves' shapes and dtypes, on the CPU (fake
    tensors inside ``FakeTensorMode``)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype)
                    if isinstance(d, TensorDef) else d, abstract)


def call_stats(fn, abstract_args: tuple) -> OpStats:
    """``OpStats`` of ``fn(*args)`` on fake tensors of ``abstract_args``'s
    ``TensorDef`` leaves. The arguments count as live storage from the start."""
    counter = _Counter()
    with FakeTensorMode(allow_non_fake_inputs=False):
        args = _fake_like(abstract_args)
        for t in _tensors(args):
            counter.track(t)
        with region.listening(counter), counter:
            out = fn(*args)
        del out, args
    return counter.stats


def cell_stats(cell) -> OpStats:
    """``OpStats`` of one call of ``cell.fn`` on its abstract arguments. The cell
    must be built on the CPU (``build_cell(..., device="cpu")``)."""
    if cell.model.device.type != "cpu":
        raise ValueError(f"{cell.name}: the dry-run runs on CPU fake tensors; build the "
                         f"cell with device='cpu'")
    return call_stats(cell.fn, cell.abstract_args)


def stats_to_json(st: OpStats) -> dict:
    """The JSON record; the JAX package's field names wherever a field exists in
    both (``by_opcode`` and ``top_collectives`` are empty on one card)."""
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
        "by_opcode": {},
        "top_collectives": [],
        "ops": st.ops,
    }
