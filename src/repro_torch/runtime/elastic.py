"""Elastic scaling: re-mesh live training state when pods join or leave, twin of
``repro.runtime.elastic``.

The management plane treats cluster membership as dynamic (lease-backed
registration, failure detection). For the data plane that means the mesh
itself must be rebuildable mid-run: on a membership change

  1. build the mesh over the surviving or new devices (``launch/mesh.py``),
  2. derive every ``PartitionSpec`` again from the SAME logical axes (a
     ``MeshPlan`` is pure),
  3. lay the state out on the new mesh (``remesh_state``), value for value,
  4. rescale the data pipeline's shard map: the pipeline is a pure function of
     (seed, step, shard), so no data is lost or duplicated.

Kept across a re-mesh: parameter values, optimizer moments, master weights, the
data step. Changed: the per-pod batch slicing (the global batch is invariant).
Training goes on where the state lands, on one device or on a multi-rank mesh:
``Trainer.remesh`` (``runtime/train_loop.py``) moves the state with
``remesh_state`` and binds its model and step to the new mesh, whose
tensor-parallel step (every family) reads each leaf's new
shards.
``ElasticController`` watches the overwatch's ``/clusters/`` prefix (the port's
own plane, ``repro_torch.core``) and calls back on every change of membership.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.parallel.sharding import MeshPlan, distribute
from repro_torch.tree import tree_map


def remesh_state(state, old_plan: MeshPlan, new_plan: MeshPlan, specs_fn):
    """Move a state tree onto ``new_plan``'s mesh under ``specs_fn(new_plan)``, a
    spec tree of the state's structure; every value is kept bit for bit
    (``parallel.sharding.distribute``: a DTensor on the same mesh is
    redistributed, one on another mesh gathered and laid out anew; onto a mesh of
    one device the leaf is a plain tensor on that device). ``old_plan`` is where
    the state lies; each leaf carries its own mesh, as a JAX array does. A
    collective over the ranks of the old mesh and the new; a rank outside the new
    mesh gets leaves with no local data."""
    return tree_map(lambda x, s: distribute(x, new_plan.mesh, s), state,
                    specs_fn(new_plan))


def divisors_mesh(n_devices: int) -> tuple:
    """Largest (data, model) grid for n devices (prefer square-ish, model<=data)."""
    best = (n_devices, 1)
    for m in range(1, int(n_devices ** 0.5) + 1):
        if n_devices % m == 0:
            best = (n_devices // m, m)
    return best


class ElasticController:
    """Watches cluster membership; triggers re-mesh callbacks on change.

    In the simulated fabric, "devices" are the registered clusters' capacities;
    on real hardware this maps to the ranks of a process group rebuilt after a
    slice reconfiguration.
    """

    def __init__(self, overwatch, on_change: Callable[[List[str]], None]):
        self.ow = overwatch
        self.on_change = on_change
        self.members: Optional[List[str]] = None
        overwatch.watch("/clusters/", self._event)

    def _event(self, event: str, key: str, value, rev: int) -> None:
        members = sorted(self.ow.handle(
            {"op": "range", "prefix": "/clusters/"})["items"])
        members = [m.split("/")[-1] for m in members]
        if members != self.members:
            self.members = members
            self.on_change(members)
