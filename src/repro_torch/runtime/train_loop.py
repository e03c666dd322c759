"""Trainer: the training loop of the PyTorch port on one card, twin of
``repro.runtime.train_loop``. Two synchronization modes, selected per job:
  * "sync"      - one synchronous AdamW step per global batch;
  * "local_sgd" - the Titchener mode: H pod-local AdamW steps a round on pod
                  copies of the parameters, then one int8 error-feedback
                  compressed delta exchange and an outer Nesterov step
                  (``optim/local_sgd.py``). ``step`` counts inner steps, so a
                  round advances it by H; the pods are a leading dim of the
                  state, run in turn on the one card, or split over a mesh's
                  "pod" axis.

The Trainer's ``plan`` is the JAX package's: ``MeshPlan(mesh, fsdp=False)`` on
``make_test_mesh``'s mesh unless one is given. Which families take which mesh:
  * every family (dense, moe, ssm, hybrid, encdec and vlm) in sync mode runs on
    any ("data", "model") mesh of a process group (a ``DeviceMesh``, one rank or
    many): the state is DTensors laid out by ``train_state_specs``, the step
    tensor- and data-parallel (``models/model.py``, ``launch/steps.py``); each
    rank builds the global batch from the seed (whisper's frames and the vlm's
    patches the run's one fixed draw of the global batch, alike on every rank)
    and the model takes its rows by the "batch" rule; the metrics are the same
    on every rank;
  * every family runs on a mesh of one device (one card, or a one-rank mesh with
    a plain state);
  * local_sgd runs on any ("pod", "data", "model") or ("data", "model") mesh: the
    state is DTensors laid out by ``local_sgd_state_specs`` (a rank holds its
    ``n_pods / mesh["pod"]`` local pods' slice of the pod-stacked trees; every
    pod where the mesh has no "pod" axis), the pods' inner steps are the
    tensor- and data-parallel step confined to the rank's pod (the model's plan
    is ``pod_free_plan``'s), and the round's one collective across "pod" is the
    int8 exchange of the deltas (``optim/local_sgd.py``). Each rank draws the
    whole [H, n_pods, B/n_pods, ...] round alike and keeps its pods' and its
    "data" slice's rows.
``remesh`` moves the state onto another mesh (``runtime/elastic.py``
``remesh_state``) and training goes on where it lands.

Deterministic restart: checkpoint = (train state, data step, seed); the data
pipeline is a pure function of step, so kill/restore resumes exactly. The
checkpoint is the JAX package's on-disk format.

The train step and the local-SGD round update the state in place
(``optim/adamw.py``), so ``rebind`` cannot hand back the initial tree as the JAX
package does: it draws the initial params again from the seed (``init_params``
is a pure function of the config, the seed and the device) and rebuilds the
state from them (the initial optimizer or local-SGD state is a function of the
params). No second copy of the params is kept on the
card: at gemma3-12b's width one would take 6.25 GiB.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch import configs
from repro_torch import device as devices
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import (init_train_state, local_sgd_state_specs, make_train_step,
                                      train_state_specs)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.local_sgd import (LocalSGDConfig, init_local_sgd_state, local_pods,
                                         make_round_fn, pod_free_plan)
from repro_torch.parallel.sharding import MeshPlan, P, distribute, mesh_shape
from repro_torch.runtime.elastic import remesh_state
from repro_torch.runtime.telemetry import MetricsLog, StepTimer
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainJobConfig:
    arch: str = "qwen3-0.6b"
    steps: int = 50
    seq_len: int = 64
    global_batch: int = 8
    reduced: bool = True             # reduced() config for CPU execution
    mode: str = "sync"               # sync | local_sgd
    n_pods: int = 2                  # local_sgd: pods, a leading dim of the state
    microbatches: int = 1
    seed: int = 0
    data_task: str = "ramp"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    opt: AdamWConfig = dataclasses.field(default_factory=lambda: AdamWConfig(
        peak_lr=1e-2, warmup_steps=20, total_steps=2000, weight_decay=0.0))
    local_sgd: LocalSGDConfig = dataclasses.field(default_factory=LocalSGDConfig)
    device: str = "cuda"             # "cpu" runs the kernels' plain PyTorch versions

    @classmethod
    def from_job(cls, job: dict) -> "TrainJobConfig":
        payload = dict(job.get("payload", {}))
        payload.setdefault("arch", job.get("arch") or "qwen3-0.6b")
        payload.setdefault("steps", job.get("steps", 50))
        known = {f.name for f in dataclasses.fields(cls)}
        for key in ("opt", "local_sgd"):
            if key in payload and isinstance(payload[key], dict):
                klass = AdamWConfig if key == "opt" else LocalSGDConfig
                payload[key] = klass(**payload[key])
        return cls(**{k: v for k, v in payload.items() if k in known})


class Trainer:
    def __init__(self, cfg: TrainJobConfig,
                 on_checkpoint: Optional[Callable[[int, str], None]] = None, *, mesh=None):
        if cfg.mode not in ("sync", "local_sgd"):
            raise ValueError(f"unknown trainer mode {cfg.mode!r}")
        self.cfg = cfg
        self.device = devices.resolve(cfg.device)
        arch_cfg = configs.get(cfg.arch)
        if cfg.reduced:
            arch_cfg = arch_cfg.reduced()
        arch_cfg = dataclasses.replace(arch_cfg, remat="none")
        self.arch_cfg = arch_cfg
        self._bind(mesh if mesh is not None else make_test_mesh(device=self.device))
        self.step = 0
        self.state = self._init_state(cfg)
        self._arm(cfg, on_checkpoint)

    def _bind(self, mesh) -> None:
        """The plan, model and step function of ``mesh``."""
        cfg = self.cfg
        if cfg.mode == "local_sgd":
            local_pods(mesh, cfg.n_pods)          # raises where "pod" does not divide them
        self.plan = MeshPlan(mesh=mesh, fsdp=False)
        # local_sgd: the pods are the state's leading dim; the model must not shard on "pod"
        self.model = Model(self.arch_cfg, self.device,
                           pod_free_plan(self.plan) if cfg.mode == "local_sgd" else self.plan)
        if cfg.mode == "local_sgd":
            self.round_fn = make_round_fn(self.model, cfg.opt, cfg.local_sgd)
        else:
            self.step_fn = make_train_step(self.model, cfg.opt, cfg.microbatches)

    def remesh(self, mesh) -> None:
        """Move the state onto ``mesh`` (``runtime/elastic.py`` ``remesh_state``,
        every value kept) and train there from now on: a collective over the
        ranks of the old mesh and of ``mesh``. A rank outside ``mesh`` keeps
        shards with no data and must not step."""
        old = self.plan
        self._bind(mesh)
        if self.model.ranked:     # else one device, where the state stays plain
            self.state = remesh_state(self.state, old, self.plan, self._specs)

    def _specs(self, plan: MeshPlan) -> dict:
        """The layout of this mode's state under ``plan``."""
        if self.cfg.mode == "local_sgd":
            return local_sgd_state_specs(self.arch_cfg, plan)
        return train_state_specs(self.arch_cfg, plan)

    def _init_state(self, cfg: TrainJobConfig) -> dict:
        """The initial state of ``cfg.mode`` from ``cfg.seed``."""
        if cfg.mode == "local_sgd":
            return init_local_sgd_state(self.model.init_params(cfg.seed), cfg.n_pods,
                                        self.plan.mesh, self._specs(self.plan))
        return init_train_state(self.model, cfg.seed)

    def _arm(self, cfg: TrainJobConfig,
             on_checkpoint: Optional[Callable[[int, str], None]]) -> None:
        """Per-run state: data, the frames or patches, metrics, timer and the
        checkpoint directory."""
        self.data = SyntheticTokens(
            vocab_size=self.arch_cfg.vocab_size, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed, task=cfg.data_task)
        self.aux_inputs = {}             # batch size -> the run's frames or patches
        self.metrics = MetricsLog()
        self.timer = StepTimer(tokens_per_step=cfg.global_batch * cfg.seq_len)
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        if self.ckpt and on_checkpoint:
            self.ckpt.on_commit(on_checkpoint)

    def rebind(self, cfg: TrainJobConfig,
               on_checkpoint: Optional[Callable[[int, str], None]] = None) -> None:
        """Re-arm a warm trainer for a new task of the SAME family (the step-cache
        hit path): reset step, state, data and metrics and point the checkpoint
        manager at the task's directory; the model and step function stay. The
        caller guarantees the cache key matches; only per-run knobs differ."""
        if self.ckpt:
            self.ckpt.wait()             # bound the previous task's async save
        # the previous task's state goes before the new one is built: at
        # mamba2-2.7b's width (39.6 GB of params, m, v and master), or qwen3-0.6b's
        # local-SGD state over 2 pods (30.8 GiB), two do not fit on one card together
        self.state = None
        self.state = self._init_state(cfg)
        self.cfg = cfg
        self.step = 0
        self._arm(cfg, on_checkpoint)

    # ------------------------------------------------------------------ step logic
    def _sync_batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self._with_aux_inputs(self.data.global_batch_at(step), self.cfg.global_batch)
        return {k: v.to(self.device) for k, v in batch.items()}

    def _with_aux_inputs(self, batch: dict, B: int) -> dict:
        """The batch with the encoder's frames (encdec) or the patches (vlm): one
        fixed bf16 draw of [B, M, d_model], the same at every step and for every
        pod, as the JAX package's ``_with_aux_inputs`` (its conv frontend and
        vision tower are stubs). Drawn once on the host from a ``torch.Generator``
        seeded ``seed + 1`` (frames) or ``seed + 2`` (patches), so the card and the
        CPU see the same values (they cannot be ``jax.random``'s bit for bit), and
        kept on the device. On a mesh every rank draws the whole [B, ...] alike and
        the model cuts its rows, as the tokens', so a mesh run sees the one-device
        run's frames."""
        c = self.arch_cfg
        if c.family not in ("encdec", "vlm"):
            return batch
        name, offset, M = (("frames", 1, c.encoder_frames) if c.family == "encdec"
                           else ("patches", 2, c.num_patches))
        if B not in self.aux_inputs:
            gen = torch.Generator().manual_seed(self.cfg.seed + offset)
            self.aux_inputs[B] = torch.randn((B, M, c.d_model), generator=gen).to(
                torch.bfloat16).to(self.device)
        return dict(batch, **{name: self.aux_inputs[B]})

    def _round_batches(self, step: int) -> Dict[str, torch.Tensor]:
        """local_sgd: the [H, n_pods, B/n_pods, ...] batch stack of one round; pod p
        of inner step h reads shard p of data step ``step + h``. On a mesh every
        rank draws the whole stack alike and keeps its DTensor shard: its pods'
        (over "pod") and its "data" slice's rows (where "data" divides them)."""
        H, n = self.cfg.local_sgd.inner_steps, self.cfg.n_pods
        Bp = self.cfg.global_batch // n
        rows = [[self._with_aux_inputs(self.data.batch_at(step + h, shard_id=p, batch=Bp), Bp)
                 for p in range(n)] for h in range(H)]
        out = {k: torch.stack([torch.stack([pod[k] for pod in row]) for row in rows])
               for k in rows[0][0]}
        if not self.model.ranked:
            return {k: v.to(self.device) for k, v in out.items()}
        pod = "pod" if "pod" in mesh_shape(self.plan.mesh) else None
        spec = P(None, pod, *self.model.plan.spec(("batch",), (Bp,)))
        return {k: distribute(v, self.plan.mesh, spec) for k, v in out.items()}

    def step_once(self) -> Dict[str, float]:
        if self.cfg.mode == "local_sgd":
            batches = self._round_batches(self.step)
            self.state, m = self.round_fn(self.state, batches)
            self.step += self.cfg.local_sgd.inner_steps
        else:
            batch = self._sync_batch(self.step)
            self.state, m = self.step_fn(self.state, batch)
            self.step += 1
        m = {k: float(v) for k, v in m.items()}
        self.timer.tick()
        self.metrics.log(self.step, m)
        if self.ckpt and self.step % self.cfg.checkpoint_every == 0:
            # non-blocking: the host copies are taken now, the disk write runs
            # beside the next steps (the next save joins it)
            self.save_checkpoint(blocking=False)
        return m

    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        target = self.step + (steps if steps is not None else self.cfg.steps)
        last = {}
        while self.step < target:
            last = self.step_once()
        return last

    # ---------------------------------------------------------------- checkpointing
    def save_checkpoint(self, blocking: bool = True) -> Optional[dict]:
        """Snapshot the train state. ``blocking=False`` returns once the host
        copies are taken; the next save, ``restore`` or ``rebind`` joins it."""
        if not self.ckpt:
            return None
        self.ckpt.save(self.step, self.state,
                       extra={"data": self.data.state_dict(),
                              "arch": self.cfg.arch, "mode": self.cfg.mode})
        if blocking:
            self.ckpt.wait()
        return {"step": self.step, "path": str(self.ckpt.directory)}

    def restore(self, manifest: Optional[dict] = None, strict: bool = False) -> int:
        """Restore from a manifest {step, path} (or the latest in our own dir).

        Returns the restored step; 0 means "no checkpoint, fresh start", the
        resume semantics a train task wants. ``strict=True`` raises instead
        (``FileNotFoundError``): an eval task told to restore must see a
        committed checkpoint. Integrity checks (stale manifest, missing or
        torn leaves) are ``CheckpointManager.restore``'s and always raise."""
        if self.ckpt:
            self.ckpt.wait()             # our own async save is a valid source
        directory = (manifest or {}).get("path") or (
            self.cfg.checkpoint_dir if self.ckpt else None)
        if directory is None:
            if strict:
                raise FileNotFoundError(
                    f"restore requested but no checkpoint directory in "
                    f"manifest or config: {manifest!r}")
            return 0
        mgr = CheckpointManager(directory)
        step = (manifest or {}).get("step") or mgr.latest_step()
        if step is None:
            if strict:
                raise FileNotFoundError(f"no committed checkpoint in {directory}")
            return 0
        self.state, step, extra = mgr.restore(self.state, step=step)
        self.data.load_state_dict(extra["data"])
        self.step = int(step)
        return self.step

    # -------------------------------------------------------------------- inspection
    def loss(self) -> Optional[float]:
        row = self.metrics.latest()
        return row.get("loss") if row else None

    def params_for_eval(self) -> dict:
        if self.cfg.mode == "local_sgd":
            dtype = getattr(torch, self.arch_cfg.dtype)
            return tree_map(lambda m: m.to(dtype), self.state["master"])
        return self.state["params"]
