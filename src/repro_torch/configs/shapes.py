"""Copy of ``repro.configs.shapes`` under ``repro_torch``: the assigned input-shape
sets and ``token_inputs()`` (``TensorDef`` stand-ins).

Each LM shape pairs (seq_len, global_batch) with the step it lowers:
  * ``train_4k``     -> train_step   (forward+backward+optimizer update)
  * ``prefill_32k``  -> prefill_step (forward, KV-cache build, last-token logits)
  * ``decode_32k``   -> serve_step   (one new token against a seq_len KV cache)
  * ``long_500k``    -> serve_step   (sub-quadratic archs only; see ArchConfig.sub_quadratic)

No device memory is allocated here: everything is a ``TensorDef`` of the port's
model (``repro_torch.models.model``), imported inside ``token_inputs`` so that
``SHAPES`` (which ``roofline.cost`` reads on the control path) loads no torch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if (arch, shape) is a valid dry-run cell, else a skip-reason string."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 524k decode KV out of scope (DESIGN.md §5)"
    return None


def token_inputs(cfg: ArchConfig, spec: ShapeSpec) -> dict:
    """Model inputs (token ids + stub-frontend embeddings where applicable), as
    ``{name: TensorDef}``."""
    import torch
    from repro_torch.models.model import TensorDef
    B, S = spec.global_batch, spec.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if spec.step == "decode":
        out = {"tokens": TensorDef((B, 1), i32)}
    else:
        out = {"tokens": TensorDef((B, S), i32)}
    if spec.step == "train":
        out["targets"] = TensorDef((B, S), i32)
        out["loss_mask"] = TensorDef((B, S), bf16)
    if cfg.family == "encdec":
        out["frames"] = TensorDef((B, cfg.encoder_frames, cfg.d_model), bf16)
    if cfg.family == "vlm":
        out["patches"] = TensorDef((B, cfg.num_patches, cfg.d_model), bf16)
    return out
