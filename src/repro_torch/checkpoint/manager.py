"""Async, atomically-committed checkpointing in the JAX package's on-disk format
(twin of ``repro.checkpoint.manager``), so a checkpoint written by either package
restores in the other.

Layout: <dir>/step_<N>/leaf_<i>.bin + manifest.json. Leaves are numbered in
``jax.tree_util``'s flatten order (dict keys sorted) and named by their path
joined with "/"; each file holds the leaf's raw C-order bytes, and the manifest
gives its shape and its dtype as numpy prints it ("bfloat16", "float32",
"int32"). The manifest is written LAST (fsync'd, then atomically renamed); a
checkpoint without one is invisible to ``latest_step``, so a crash mid-save never
corrupts restartability. bf16 goes to and from bytes through int16 views, so
neither numpy's nor ml_dtypes' bfloat16 is needed. Commit callbacks receive
(step, manifest path) once a checkpoint is durable.

DTensor leaves (a state on a ``DeviceMesh``): a save gathers every leaf whole on
every rank of its mesh (a collective) and the mesh's first rank writes the same
files a one-device save writes, as the JAX package's ``device_get`` save does;
over more than one rank the write is synchronous and every rank waits for it at
a barrier. A restore reads the files on every rank and lays each leaf out on its
like-leaf's mesh and placements, so a save from one mesh restores on any other,
or on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.parallel.sharding import full_value
from repro_torch.tree import tree_flatten_sorted, tree_unflatten_sorted

_SEP = "/"
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
           "float64": torch.float64, "int8": torch.int8, "uint8": torch.uint8,
           "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
           "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten_with_names(tree):
    flat = tree_flatten_sorted(tree)
    return [_SEP.join(str(p) for p in path) for path, _ in flat], [leaf for _, leaf in flat]


def _host_array(t: torch.Tensor):
    """A host copy of ``t`` as a numpy array of its raw bytes, and its dtype
    name. The copy is taken now: the train step updates the state in place."""
    t = full_value(t.detach()).to("cpu", copy=True).contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"checkpoint leaf of unsupported dtype {t.dtype}")
    name = _NAMES[t.dtype]
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy(), name


def _from_bytes(data: bytes, dtype_name: str, shape) -> torch.Tensor:
    dtype = _DTYPES[dtype_name]
    if not data:
        return torch.empty(shape, dtype=dtype)
    raw = torch.frombuffer(bytearray(data),
                           dtype=torch.int16 if dtype == torch.bfloat16 else dtype)
    return (raw.view(torch.bfloat16) if dtype == torch.bfloat16 else raw).reshape(shape)


def _itemsize(dtype_name: str) -> int:
    if dtype_name not in _DTYPES:
        raise ValueError(f"checkpoint leaf of unknown dtype {dtype_name!r}")
    return _DTYPES[dtype_name].itemsize


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.directory = directory
        self.keep = keep
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._commit_hooks: List[Callable[[int, str], None]] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------------- hooks
    def on_commit(self, fn: Callable[[int, str], None]) -> None:
        """fn(step, manifest_path) runs after a checkpoint becomes durable."""
        self._commit_hooks.append(fn)

    # -------------------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = False) -> str:
        """Snapshot ``tree`` (+ JSON-serializable ``extra``) at ``step``. The host
        copies are taken before this returns; the disk write runs on a thread
        unless ``blocking`` or the manager is synchronous."""
        self.wait()
        names, leaves = _flatten_with_names(tree)
        host = [_host_array(leaf) for leaf in leaves]
        target = os.path.join(self.directory, f"step_{step:08d}")
        meshes = {id(leaf.device_mesh): leaf.device_mesh for leaf in leaves
                  if isinstance(leaf, DTensor) and leaf.device_mesh.size() > 1}
        mesh = next(iter(meshes.values()), None)

        def write():
            tmp = target + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            entries = {}
            for i, (name, (arr, dtype_name)) in enumerate(zip(names, host)):
                fname = f"leaf_{i:05d}.bin"
                with open(os.path.join(tmp, fname), "wb") as f:
                    f.write(arr.tobytes())
                entries[name] = {"file": fname, "shape": list(arr.shape),
                                 "dtype": dtype_name}
            manifest = {"step": step, "leaves": entries, "extra": extra or {}}
            mpath = os.path.join(tmp, "manifest.json")
            with open(mpath + ".tmp", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(mpath + ".tmp", mpath)           # manifest last = commit point
            # swap the finished tree in with no window in which this step has no
            # committed checkpoint: the old tree aside, the atomic tmp -> target
            # rename, then drop the old one (a .old survivor is ignored by
            # all_steps and reaped by the next save of this step)
            if os.path.exists(target):
                old = target + ".old"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.rename(target, old)
                os.rename(tmp, target)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, target)
            self._gc()
            for hook in self._commit_hooks:
                hook(step, os.path.join(target, "manifest.json"))

        if mesh is not None:     # the mesh's first rank writes; all wait for it
            if len(meshes) > 1:
                raise ValueError("a checkpoint's DTensor leaves lie on more than one mesh")
            if mesh.get_rank() == int(mesh.mesh.flatten()[0]):
                write()
            for group in mesh.get_all_groups():
                dist.barrier(group=group)
        elif self.use_async and not blocking:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return target

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------------ restore
    def all_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.directory)):
            if not d.startswith("step_"):
                continue
            try:
                step = int(d[5:])       # skips .tmp / .old crash leftovers
            except ValueError:
                continue
            if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None) -> tuple:
        """Restore into the structure of ``like`` (a tree of tensors; each leaf is
        placed on its like-leaf's device, in the checkpoint's dtype). Returns
        (tree, step, extra). A stale manifest, a missing leaf or a leaf file of
        the wrong size raises before any bytes are read."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        target = os.path.join(self.directory, f"step_{step:08d}")
        mpath = os.path.join(target, "manifest.json")
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"checkpoint step {step} has no committed manifest "
                f"(crash left an uncommitted tree?): {mpath}")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("step") != step:
            raise ValueError(
                f"stale checkpoint: directory says step {step} but manifest "
                f"says step {manifest.get('step')}")
        names, leaves = _flatten_with_names(like)
        for name in names:
            ent = manifest["leaves"].get(name)
            if ent is None:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            path = os.path.join(target, ent["file"])
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"checkpoint step {step}: leaf file missing: {path}")
            n = 1
            for d in ent["shape"]:
                n *= int(d)
            want = n * _itemsize(ent["dtype"])
            got = os.path.getsize(path)
            if got != want:
                raise ValueError(
                    f"checkpoint step {step}: leaf {name!r} is {got} bytes, "
                    f"expected {want} ({ent['shape']} {ent['dtype']})")
        out = []
        for name, leaf in zip(names, leaves):
            ent = manifest["leaves"][name]
            with open(os.path.join(target, ent["file"]), "rb") as f:
                t = _from_bytes(f.read(), ent["dtype"], ent["shape"])
            if isinstance(leaf, DTensor):
                t = distribute_tensor(t.to(leaf.to_local().device), leaf.device_mesh,
                                      leaf.placements, src_data_rank=None)
            elif isinstance(leaf, torch.Tensor):
                t = t.to(leaf.device)
            out.append(t)
        return tree_unflatten_sorted(like, out), manifest["step"], manifest["extra"]
