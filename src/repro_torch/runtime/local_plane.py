"""TorchLocalPlane: a local control plane that runs the port's jobs, twin of
``repro.runtime.local_plane.JaxLocalPlane``.

It answers the five calls the management plane's control agent makes on its
local plane (capabilities / submit / cancel / poll / load), so the plane drives it
as it drives ``JaxLocalPlane`` or ``SimLocalPlane``. ``poll`` advances a bounded
slice of real work per heartbeat, so a cluster lost mid-job leaves a half-trained
model whose restored continuation must match the uninterrupted run.

Checkpoint manifests go out through the ``publish`` callback (the plane wires it
to the overwatch at ``/checkpoints/{job_id}``), from the checkpoint writer's
thread once a save is durable; a re-dispatched job carries its ``restore_from``
manifest back. The plane's ``device`` is its jobs' device: "cuda" (the default)
raises in ``submit`` without a card, so the agent fails the job instead of
running it on the CPU. Its ``mesh`` (default: none, the one device) is the mesh
its jobs' Trainers and Servers run on, as ``JaxLocalPlane``'s: a ``DeviceMesh``
over a process group that every rank's plane drives alike.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

from repro_torch.runtime.serve_loop import Server, ServeJobConfig
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig


@dataclasses.dataclass
class _TrainJob:
    trainer: Trainer
    total_steps: int
    status: str = "running"

    def advance(self, budget: int) -> None:
        n = min(budget, self.total_steps - self.trainer.step)
        if n > 0:
            self.trainer.run(n)
        if self.trainer.step >= self.total_steps:
            self.trainer.save_checkpoint()
            self.status = "done"

    def progress(self) -> float:
        return float(self.trainer.step)

    def rate(self) -> float:
        return self.trainer.timer.steps_per_s

    def extra(self) -> dict:
        return {"loss": self.trainer.loss()}


@dataclasses.dataclass
class _ServeJob:
    server: Server
    status: str = "running"
    served: int = 0

    def advance(self, budget: int) -> None:
        for _ in range(budget):
            if self.server.step() == 0 and not self.server.queue:
                break
        self.served = sum(r.done for r in self.server.requests.values())
        if self.server.pending() == 0:
            self.status = "done"

    def progress(self) -> float:
        return float(self.served)

    def rate(self) -> float:
        return 1.0

    def extra(self) -> dict:
        return {"served": self.served}


class TorchLocalPlane:
    """Runs 'serve' jobs and, for any other kind, train jobs; the dispatcher's
    capability matching keeps other work away."""

    def __init__(self, caps=("cpu", "train", "serve"),
                 steps_per_poll: int = 2,
                 publish: Optional[Callable[[str, dict], None]] = None,
                 device: str = "cuda", checkpoint_root: Optional[str] = None, mesh=None):
        self._caps = tuple(caps)
        self.steps_per_poll = steps_per_poll
        self.publish = publish
        self.device = device
        self.mesh = mesh
        self.checkpoint_root = checkpoint_root
        self.jobs: Dict[str, object] = {}

    def capabilities(self):
        return self._caps

    # --------------------------------------------------------------------- lifecycle
    def submit(self, job: dict) -> None:
        jid = job["job_id"]
        kind = job.get("kind", "train")
        if kind == "serve":
            cfg = dataclasses.replace(ServeJobConfig.from_job(job), device=self.device)
            server = Server(cfg, mesh=self.mesh)
            for p in job.get("payload", {}).get("requests", ()):
                server.submit(p.get("prompt", [1, 2, 3]), p.get("max_new", 8))
            self.jobs[jid] = _ServeJob(server)
            return
        cfg = dataclasses.replace(TrainJobConfig.from_job(job), device=self.device)
        if cfg.checkpoint_dir is None and self.checkpoint_root:
            cfg = dataclasses.replace(cfg, checkpoint_dir=f"{self.checkpoint_root}/{jid}")
        on_ckpt = None
        if self.publish:
            def on_ckpt(step: int, path: str, _jid=jid) -> None:
                # path is .../step_XXXXXXXX/manifest.json; the manifest records
                # the checkpoint DIRECTORY (what a restoring Trainer needs)
                ck_dir = os.path.dirname(os.path.dirname(path))
                self.publish(_jid, {"step": step, "path": ck_dir})
        trainer = Trainer(cfg, on_checkpoint=on_ckpt, mesh=self.mesh)
        restore = job.get("restore_from")
        if restore:
            trainer.restore(restore)
        self.jobs[jid] = _TrainJob(trainer, total_steps=cfg.steps)

    def cancel(self, job_id: str) -> None:
        rec = self.jobs.get(job_id)
        if rec is not None:
            rec.status = "failed"

    def poll(self, job_id: str) -> dict:
        rec = self.jobs[job_id]
        if rec.status == "running":
            rec.advance(self.steps_per_poll)
        out = {"progress": rec.progress(), "status": rec.status,
               "rate": rec.rate() if rec.status == "running" else 0.0}
        out.update(rec.extra())
        return out

    def load(self) -> float:
        return sum(1.0 for r in self.jobs.values() if r.status == "running")
