"""Meshes of the port and the card's constants for the roofline analysis, twin of
``repro.launch.mesh``.

Everything is a function (no module-level mesh state), so importing this module
touches no process group.

Topology, as the JAX package's:
  * single pod: (data=16, model=16) = 256 devices;
  * multi pod:  (pod=2, data=16, model=16) = 512 devices; only the "pod" axis
    crosses the boundary between pods (``parallel/sharding.py``'s rules keep
    every per-layer collective off it).

A mesh over ranks is a torch ``DeviceMesh`` over the default process group,
which the caller initialises (``torch.distributed.init_process_group`` with its
address, world size and rank): nothing here starts one. Without a process group
``make_test_mesh`` gives the one-device mesh (``OneDeviceMesh``), on which every
placement is the identity; ``make_production_mesh`` raises.

The port runs on one NVIDIA H100 80GB HBM3 (SXM, 700 W). Its published dense
peaks, and the memory that ``torch.cuda.get_device_properties(0).total_memory``
reports on it.
"""
from __future__ import annotations

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


def _world() -> int:
    """Ranks of the default process group; 0 when none is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


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
