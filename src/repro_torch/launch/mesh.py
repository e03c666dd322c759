"""Meshes of the port and the constants of its roofline analysis, twin of
``repro.launch.mesh``.

Everything is a function (no module-level mesh state), so importing this module
touches no process group.

Topology, as the JAX package's:
  * single pod: (data=16, model=16) = 256 devices;
  * multi pod:  (pod=2, data=16, model=16) = 512 devices; only the "pod" axis
    crosses the boundary between pods (``parallel/sharding.py``'s rules keep
    every per-layer collective off it). A pod is ``CHIPS_PER_POD`` devices.

A mesh over ranks is a torch ``DeviceMesh`` over the default process group,
which the caller initialises (``torch.distributed.init_process_group`` with its
address, world size and rank). Without a process group ``make_test_mesh`` gives
the one-device mesh (``OneDeviceMesh``), on which every placement is the
identity; ``make_production_mesh`` raises. ``fake_world`` starts PyTorch's fake
process group of 256 or 512 ranks on the CPU for the length of a block: its
collectives return at once and move nothing, so the production meshes can be
built and a step traced on them, shapes only, by the dry-run
(``launch/dryrun.py``), as this rank of the whole deployment.

The port runs on NVIDIA H100 80GB HBM3 cards (SXM, 700 W): their published
dense peaks, the memory that ``torch.cuda.get_device_properties(0).total_memory``
reports on one, and the two link rates a device's collectives get in an H100
deployment of the production meshes (a stated assumption, as the JAX package's
``ICI_BW`` and ``DCN_BW`` are for its TPUs; not measured).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch import device as devices
from repro_torch.parallel.sharding import OneDeviceMesh, mesh_shape

PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core flop/s
HBM_BW = 3.35e12               # HBM3 bytes/s
# total_memory of an NVIDIA H100 80GB HBM3 (torch.cuda.get_device_properties on
# the card; chip_smoke.py prints it and checks this value)
HBM_BYTES = 85_017_493_504
CHIPS = 1
CHIPS_PER_POD = 256
# In the pod: one 400 Gb/s NDR InfiniBand port (ConnectX-7) a GPU, as in a DGX
# H100 (NVIDIA DGX H100 user guide, networking: eight single-port ConnectX-7 for
# the compute fabric). NVLink's 900 GB/s is not used: a 16-rank "data" or
# "model" line of the production mesh spans more than one 8-GPU NVLink node, so
# a ring over it runs at the network's rate. Bytes/s a device.
IN_POD_BW = 50e9
# Across the pod: the hybrid-cloud link, 100 Gb/s a node of 8 GPUs, shared by its
# 8 devices (a deployment assumption, as the JAX package's DCN_BW). Bytes/s a
# device.
CROSS_POD_BW = 100e9 / 8 / 8


def _world() -> int:
    """Ranks of the default process group; 0 when none is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """PyTorch's fake process group of ``n_ranks`` on the CPU, as ``rank``, for the
    length of the block; destroyed on exit, whatever happens inside. Refuses to
    start where a default process group is initialised already."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is initialised already; the fake "
                           "world starts only where there is none")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(device, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(devices.resolve(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over the default process group;
    raises unless it has exactly 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), _world()
    if have != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a default process group "
            f"of {need} ranks; " + (f"it has {have}" if have else "none is initialised"))
    return _device_mesh(device, shape, axes)


def make_test_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Optional[Tuple[str, ...]] = None, device="cuda"):
    """A ``DeviceMesh`` over the default process group's ranks, (data=1,
    model=world) by default; with no process group, the one-device mesh of
    ``device`` (``shape`` then must hold one device)."""
    if (shape is None) != (axes is None):
        raise ValueError("give a mesh shape and its axis names together")
    world = _world()
    if world:
        if shape is None:
            shape, axes = (1, world), ("data", "model")
        return _device_mesh(device, tuple(shape), tuple(axes))
    if shape is None:
        shape, axes = (1, 1), ("data", "model")
    if math.prod(shape) != 1:
        raise RuntimeError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks, "
                           "and no default process group is initialised")
    return OneDeviceMesh(devices.resolve(device), tuple(axes))


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def n_pods(mesh) -> int:
    return mesh_shape(mesh).get("pod", 1)


def chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())
