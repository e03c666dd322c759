"""Pipeline task handlers on the port, twins of the task kinds of
``repro.pipelines.worker``:

  etl    - deterministic shard statistics over the synthetic pipeline
  train  - a Trainer run (payload: arch/steps/...); resumes from its own
           checkpoint_dir and runs only the remaining steps
  eval   - forward loss on a held-out batch; a ``restore_from`` manifest is
           restored STRICTLY (a missing or torn checkpoint fails the task)
  serve  - synthetic prompts through the continuous-batching Server
  export - parameter manifest (count and number of leaves), from the
           parameter definitions alone
  python - echo

Each handler takes a payload dict and returns a result dict, the signature a
pipeline worker's ``register(kind, fn)`` takes. train, eval and serve run on the
payload's ``device`` (default "cuda"; "cpu" runs the kernels' plain versions).

``WarmHandlers`` is a worker's warm set: train and eval share one
``TrainerCache`` and serve one ``ServerCache``, so a task of the same family
rebinds a built Trainer or Server instead of building it. ``step_cache=0`` keeps
the cold build-per-task handlers.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.params import param_defs
from repro_torch.runtime.step_cache import (ServerCache, TrainerCache, run_eval_task,
                                            run_serve_task, run_train_task)
from repro_torch.tree import tree_leaves


def _etl(payload: dict) -> dict:
    data = SyntheticTokens(vocab_size=payload.get("vocab", 512),
                           seq_len=payload.get("seq_len", 32),
                           global_batch=payload.get("batch", 4),
                           seed=payload.get("seed", 0))
    n = payload.get("batches", 2)
    toks = sum(int(data.batch_at(i)["tokens"].numel()) for i in range(n))
    return {"batches": n, "tokens": toks}


def _train(payload: dict) -> dict:
    return run_train_task(None, payload)


def _eval(payload: dict) -> dict:
    return run_eval_task(None, payload)


def _serve(payload: dict) -> dict:
    return run_serve_task(None, payload)


def _export(payload: dict) -> dict:
    cfg = configs.get(payload.get("arch", "qwen3-0.6b"))
    if payload.get("reduced", True):
        cfg = cfg.reduced()
    defs = tree_leaves(param_defs(cfg))
    return {"exported_params": sum(math.prod(d.shape) for d in defs), "leaves": len(defs)}


DEFAULT_HANDLERS: Dict[str, Callable[[dict], dict]] = {
    "etl": _etl, "train": _train, "eval": _eval, "serve": _serve, "export": _export,
    "python": lambda p: {"echo": p},
}


class WarmHandlers:
    """One worker's task handlers: the defaults, with train, eval and serve bound
    to this holder's caches (of ``step_cache`` entries each, built at first use)
    when ``step_cache`` is above 0."""

    def __init__(self, step_cache: int = 4):
        self.step_cache = max(int(step_cache), 0)
        self._trainer_cache = None
        self._server_cache = None
        self.handlers = dict(DEFAULT_HANDLERS)
        if self.step_cache:
            self.handlers.update(train=self._cached_train, eval=self._cached_eval,
                                 serve=self._cached_serve)

    def trainer_cache(self) -> TrainerCache:
        if self._trainer_cache is None:
            self._trainer_cache = TrainerCache(self.step_cache)
        return self._trainer_cache

    def server_cache(self) -> ServerCache:
        if self._server_cache is None:
            self._server_cache = ServerCache(self.step_cache)
        return self._server_cache

    def _cached_train(self, payload: dict) -> dict:
        return run_train_task(self.trainer_cache(), payload)

    def _cached_eval(self, payload: dict) -> dict:
        return run_eval_task(self.trainer_cache(), payload)

    def _cached_serve(self, payload: dict) -> dict:
        return run_serve_task(self.server_cache(), payload)
