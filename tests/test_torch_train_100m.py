"""PyTorch port, ``examples/torch_train_100m.py``: its ``build_100m()`` is the JAX
example's config field for field (the same parameter count), two of its train
steps at 2 x 16 tokens on ``device="cpu"`` give finite, moving losses, and its
entry point asks for the card by default."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_100m_is_the_jax_examples_config():
    pytest.importorskip("jax")
    want = _example("train_100m").build_100m()
    got = _example("torch_train_100m").build_100m()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.param_count() == 70_531_072 and got.remat == "none"


def test_two_cpu_steps_give_finite_moving_losses():
    """The example's model, optimizer, step and data at 2 x 16 tokens."""
    cfg = _example("torch_train_100m").build_100m()
    model = Model(cfg, "cpu")
    state = init_train_state(model, 0)
    step = make_train_step(model, AdamWConfig(peak_lr=3e-3, warmup_steps=30, total_steps=2,
                                              weight_decay=0.01), 1)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, task="ramp")
    losses = []
    for i in range(2):
        state, m = step(state, data.global_batch_at(i))
        losses.append(float(m["loss"]))
    assert all(map(math.isfinite, losses)) and losses[0] != losses[1]
    assert abs(losses[0] - math.log(cfg.vocab_size)) < 1.0     # ~uniform at init
    assert int(state["opt"]["step"]) == 2


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _example("torch_train_100m").main(["--steps", "1"])
