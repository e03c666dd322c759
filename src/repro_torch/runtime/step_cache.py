"""Keyed LRU caches of warm trainers and servers, and the train, eval and serve
tasks' semantics, twin of ``repro.runtime.step_cache``.

A :class:`TrainerCache` keys warm trainers by their family, everything the step
depends on (arch, reduced, mode, seq_len, global_batch, n_pods, microbatches,
data_task, opt, local_sgd) and the device; a hit calls ``Trainer.rebind``. A
:class:`ServerCache` keys warm servers by (arch, reduced, slots, max_len,
device); a hit calls ``Server.rebind``. ``capacity=0`` disables caching (a fresh
build per task); eviction is LRU. A ``TrainerCache``'s ``mesh`` (default: none,
the one device) is the mesh its Trainers run on, so ``run_train_task`` and
``run_eval_task`` train and evaluate on it.

  * train - resume from the task's own ``checkpoint_dir`` (latest committed
    step) and run only the steps left to the payload's target, so a task
    redelivered after a worker crash continues instead of restarting; the final
    checkpoint save blocks (the manifest it returns must be durable).
  * eval - STRICT restore: a missing or half-written checkpoint fails the task
    instead of scoring fresh params.
  * serve - synthetic prompts through the continuous-batching server.

Each payload's ``device`` (default "cuda") picks the card or, with "cpu", the
plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import torch


def _freeze(v):
    if dataclasses.is_dataclass(v):
        return tuple(sorted(dataclasses.asdict(v).items()))
    return v


class _LRU:
    """Shared LRU mechanics; subclasses define key_of/build/rebind."""

    def __init__(self, capacity: int = 4):
        self.capacity = max(int(capacity), 0)
        self._lru: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lru)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._lru)}

    def get(self, cfg):
        key = self.key_of(cfg)
        hit = self._lru.get(key)
        if hit is not None:
            self.hits += 1
            self._lru.move_to_end(key)
            self.rebind(hit, cfg)
            return hit
        self.misses += 1
        obj = self.build(cfg)
        if self.capacity:
            self._lru[key] = obj
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
                self.evictions += 1
        return obj


class TrainerCache(_LRU):
    def __init__(self, capacity: int = 4, mesh=None):
        super().__init__(capacity)
        self.mesh = mesh

    @staticmethod
    def key_of(cfg) -> Tuple:
        return ("train", cfg.arch, cfg.reduced, cfg.mode, cfg.seq_len,
                cfg.global_batch, cfg.n_pods, cfg.microbatches,
                cfg.data_task, _freeze(cfg.opt), _freeze(cfg.local_sgd), cfg.device)

    def build(self, cfg):
        from repro_torch.runtime.train_loop import Trainer
        return Trainer(cfg, mesh=self.mesh)

    @staticmethod
    def rebind(trainer, cfg) -> None:
        trainer.rebind(cfg)


class ServerCache(_LRU):
    @staticmethod
    def key_of(cfg) -> Tuple:
        return ("serve", cfg.arch, cfg.reduced, cfg.slots, cfg.max_len, cfg.device)

    @staticmethod
    def build(cfg):
        from repro_torch.runtime.serve_loop import Server
        return Server(cfg)

    @staticmethod
    def rebind(server, cfg) -> None:
        server.rebind(cfg)


def run_train_task(cache: Optional[TrainerCache], payload: dict) -> dict:
    from repro_torch.runtime.train_loop import TrainJobConfig
    cfg = TrainJobConfig.from_job({"payload": dict(payload)})
    # `is None`, not truthiness: an EMPTY cache is falsy (len 0) but must
    # still be used, or the first task of every family would build cold
    tr = (TrainerCache(0) if cache is None else cache).get(cfg)
    resumed = 0
    if cfg.checkpoint_dir and payload.get("resume", True):
        # latest committed step in our own directory (0 = fresh start);
        # integrity failures (torn write, stale manifest) raise -> retry
        resumed = tr.restore()
    ran = max(cfg.steps - tr.step, 0)
    m = tr.run(ran) if ran else {}
    out = {"steps": tr.step, "loss": m.get("loss", tr.loss()),
           "ran_steps": ran, "resumed_from": resumed,
           "step_ema_s": tr.timer.ema_s}
    if cfg.checkpoint_dir:
        out["checkpoint"] = tr.save_checkpoint()
    return out


def run_eval_task(cache: Optional[TrainerCache], payload: dict) -> dict:
    from repro_torch.runtime.train_loop import TrainJobConfig
    cfg = TrainJobConfig.from_job({"payload": dict(payload)})
    tr = (TrainerCache(0) if cache is None else cache).get(cfg)
    out = {}
    if payload.get("restore_from"):
        # strict: a missing/uncommitted/half-written checkpoint FAILS the
        # task, never a silently-fresh-params eval_loss
        out["restored_step"] = tr.restore(payload["restore_from"], strict=True)
    batch = tr._sync_batch(10_000)
    with torch.no_grad():
        loss, _ = tr.model.loss_fn(tr.params_for_eval(), batch)
    out["eval_loss"] = float(loss)
    return out


def run_serve_task(cache: Optional[ServerCache], payload: dict) -> dict:
    """Serve ``n_requests`` synthetic prompts of ``prompt_len`` tokens, ``max_new``
    new tokens each. The payload's ``device`` (default "cuda") picks the card or,
    with "cpu", the plain PyTorch path."""
    from repro_torch.runtime.serve_loop import ServeJobConfig
    cfg = ServeJobConfig.from_job({"payload": dict(payload)})
    # `is None`, not truthiness: an EMPTY cache is falsy (len 0) but must
    # still be used, or the first task of every family would build cold
    srv = (ServerCache(0) if cache is None else cache).get(cfg)
    n = int(payload.get("n_requests", cfg.slots))
    max_new = int(payload.get("max_new", 8))
    prompt_len = max(int(payload.get("prompt_len", 4)), 1)
    vocab = srv.arch_cfg.vocab_size
    for i in range(n):
        srv.submit([(i + j) % vocab for j in range(prompt_len)], max_new=max_new)
    done = srv.run()
    return {"requests": len(done),
            "generated_tokens": sum(len(r.generated) for r in done),
            "decode_steps": srv.steps}
