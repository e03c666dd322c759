"""Deterministic, shard-aware, checkpointable synthetic token pipeline, twin of
``repro.data.pipeline``.

Every batch is a pure function of (seed, step, shard): restart and elastic
resume are exact, and the only pipeline state is the integer step, which rides
in the training checkpoint. ``jax.random``'s bits cannot be reproduced here, so
the port draws from numpy's ``default_rng`` seeded with ``[seed, step, shard]``:
the same fields and tasks as the JAX package's, other numbers. Parity tests feed
both packages the same numpy batch.

Tasks:
  * "ramp"   - tok[i+1] = tok[i] + 1 (mod V'): learnable next-token structure.
  * "random" - iid uniform tokens (throughput benchmarking).

Batches are CPU tensors (tokens and targets int32, loss_mask bf16); the trainer
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    task: str = "ramp"
    num_shards: int = 1
    shard_id: int = 0
    step: int = 0                      # the ONLY mutable state (checkpointable)

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a multiple of "
                             f"num_shards {self.num_shards}")
        if self.task not in ("ramp", "random"):
            raise ValueError(f"unknown task {self.task!r}")
        self.shard_batch = self.global_batch // self.num_shards

    # ------------------------------------------------------------------ stateless core
    def batch_at(self, step: int, shard_id: Optional[int] = None,
                 batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        shard = self.shard_id if shard_id is None else shard_id
        B = self.shard_batch if batch is None else batch
        S = self.seq_len
        rng = np.random.default_rng([self.seed, step, shard])
        if self.task == "ramp":
            v_eff = min(self.vocab_size, 1024)
            offset = rng.integers(0, v_eff, (B, 1))
            toks = (offset + np.arange(S + 1)[None, :]) % v_eff
        else:
            toks = rng.integers(0, self.vocab_size, (B, S + 1))
        toks = torch.from_numpy(toks.astype(np.int32))
        return {
            "tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous(),
            "loss_mask": torch.ones((B, S), dtype=torch.bfloat16),
        }

    # --------------------------------------------------------------------- iteration
    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def global_batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The full global batch (all shards concatenated): single-process runs."""
        return self.batch_at(step, shard_id=0, batch=self.global_batch)

    # ------------------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        return {"step": int(self.step), "seed": int(self.seed), "task": self.task}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.seed or state["task"] != self.task:
            raise ValueError(f"data pipeline config mismatch on restore: checkpoint "
                             f"{state}, pipeline seed {self.seed} task {self.task!r}")
        self.step = int(state["step"])
