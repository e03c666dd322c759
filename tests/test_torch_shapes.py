"""PyTorch port, ``repro_torch.configs.shapes`` and ``repro_torch.roofline.cost``
against the JAX package's twins: the shape registry, the runnable cells (the 7
full-attention archs skip ``long_500k``), ``token_inputs``' shapes and dtypes,
and every built-in task kind's cost vector, roofline class and steering tag, for
all ten archs, reduced and full."""
import dataclasses

import pytest

pytest.importorskip("jax")

from repro.configs import base as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.roofline import cost as jcost  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.pipelines import dag as tdag  # noqa: E402
from repro_torch.roofline import cost as tcost  # noqa: E402
from repro.pipelines import dag as jdag  # noqa: E402

ARCHS = tconfigs.names()
SHAPE_NAMES = list(tshapes.SHAPES)
FULL_ATTENTION = ["deepseek-moe-16b", "llama-3.2-vision-90b", "phi4-mini-3.8b",
                  "qwen3-0.6b", "qwen3-32b", "qwen3-moe-235b-a22b", "whisper-medium"]


def test_same_archs_and_shapes():
    assert sorted(ARCHS) == sorted(jconfigs.names()) and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


def test_skip_set_is_the_full_attention_archs_at_long_500k():
    skips = sorted((a, s) for a in ARCHS for s in SHAPE_NAMES
                   if tshapes.cell_is_runnable(tconfigs.get(a), s) is not None)
    assert skips == [(a, "long_500k") for a in FULL_ATTENTION]


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_and_token_inputs_match_jax(arch, shape):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    assert tshapes.cell_is_runnable(tcfg, shape) == jshapes.cell_is_runnable(jcfg, shape)
    got = tshapes.token_inputs(tcfg, tshapes.SHAPES[shape])
    want = jshapes.token_inputs(jcfg, jshapes.SHAPES[shape])
    assert {k: (tuple(d.shape), str(d.dtype).removeprefix("torch.")) for k, d in got.items()} \
        == {k: (tuple(d.shape), str(d.dtype)) for k, d in want.items()}


def _payloads(arch: str, reduced: bool):
    base = {"arch": arch, "reduced": reduced}
    return {
        "train": [dict(base, steps=6, seq_len=32, global_batch=4),
                  dict(base, shape="train_4k", steps=2, mode="local_sgd")],
        "eval": [dict(base, seq_len=32, global_batch=4), dict(base, shape="prefill_32k")],
        "serve": [dict(base, slots=4, max_new=8, n_requests=6)],
        "etl": [{"batches": 3, "seq_len": 32}, {"shape": "decode_32k"}],
        "export": [base],
        "python": [{"x": 1}],
    }


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_task_cost_class_and_steering_tag_match_jax(arch, reduced):
    for kind, payloads in _payloads(arch, reduced).items():
        for payload in payloads:
            tt = tdag.Task("t", kind=kind, payload=dict(payload))
            jt = jdag.Task("t", kind=kind, payload=dict(payload))
            tv, jv = tcost.task_cost(tt), jcost.task_cost(jt)
            assert (tv is None) == (jv is None), (kind, payload)
            if tv is not None:
                assert tv.as_dict() == jv.as_dict(), (kind, payload)
                assert tcost.classify(tv) == jcost.classify(jv)
            assert tcost.steering_tag(tt) == jcost.steering_tag(jt), (kind, payload)
    n = dict(arch=arch, reduced=reduced)
    assert tcost._param_count(n) == jcost._param_count(n)


def test_cost_module_loads_no_torch():
    """The control path prices tasks without loading the port's models."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "sys.modules['torch'] = sys.modules['jax'] = sys.modules['repro'] = None\n"
            "from repro_torch.pipelines.dag import Task\n"
            "from repro_torch.roofline.cost import steering_tag\n"
            "from repro_torch.configs.shapes import SHAPES, cell_is_runnable\n"
            "print(steering_tag(Task('t', kind='train', payload={'shape': 'train_4k'})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=60, env={"PYTHONPATH": str(root / "src"),
                                                      "PATH": ""})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "accel"
