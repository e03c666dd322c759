"""Local SGD's configuration, a field-for-field copy of ``repro.optim.local_sgd``'s
``LocalSGDConfig``, so that ``TrainJobConfig`` and the trainer cache key carry the
same fields as the JAX package's. The round itself (H pod-local AdamW steps, an
int8 error-feedback delta exchange, outer Nesterov) is not ported yet: ROADMAP,
"Modules to port", item 7. ``Trainer(mode="local_sgd")`` raises until then."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    inner_steps: int = 4          # H: pod-local steps per sync round
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    nesterov: bool = True
    compress: bool = True         # int8 + error feedback on the pod-axis exchange
