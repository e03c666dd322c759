"""Guards of the PyTorch port: it never imports jax or the JAX package, its entry
points never quietly run on the CPU when the card was asked for, and on CPU
tensors the kernel dispatch takes the plain path without touching triton or a
compiled library, and no port file imports triton. No kernel wrapper silently
drops a gradient: each refuses an input that requires grad while autograd
records, and the training path's gradients flow through the autograd Functions."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.pipelines import DEFAULT_HANDLERS, WarmHandlers  # noqa: E402
from repro_torch.runtime.local_plane import TorchLocalPlane  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import (run_eval_task, run_serve_task,  # noqa: E402
                                            run_train_task)
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from repro_torch.tree import tree_flatten_sorted  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))
FORBIDDEN = ("jax", "repro", "triton")


# modules the training slice added: the import guard must see each of them
TRAINING_MODULES = ("kernels/autograd.py", "models/model.py", "optim/adamw.py",
                    "optim/schedules.py", "optim/local_sgd.py", "optim/compression.py",
                    "data/pipeline.py",
                    "checkpoint/manager.py", "runtime/telemetry.py", "launch/steps.py",
                    "runtime/train_loop.py", "runtime/step_cache.py", "convert.py")
# modules of the plane integration: the local plane and the pipeline task handlers
PLANE_MODULES = ("runtime/local_plane.py", "pipelines/__init__.py", "pipelines/handlers.py")
# the port's own copy of the management and pipeline planes, the shape registry
# and the launchers
COPIED_PLANE_MODULES = (
    "observability/__init__.py", "observability/metrics.py", "observability/trace.py",
    *(f"core/{m}.py" for m in ("__init__", "transport", "service_graph", "gateways",
                               "access_control", "overwatch", "replica", "shardmap",
                               "durability", "faults", "agent", "dispatcher", "plane")),
    "roofline/__init__.py", "roofline/cost.py", "configs/shapes.py",
    "autoscale/__init__.py", "autoscale/policy.py", "autoscale/reconciler.py",
    *(f"pipelines/{m}.py" for m in ("dag", "services", "taskdb", "broker", "scheduler",
                                    "composer", "worker")),
    "launch/train.py", "launch/serve.py")
PORT_EXAMPLES = ("torch_quickstart.py", "torch_serve_batched.py", "torch_hybrid_pipeline.py",
                 "torch_train_100m.py", "torch_elastic_training.py")
# the cells, remat's home, the one-card dry-run and its analysis
CELL_MODULES = ("launch/steps.py", "models/model.py", "launch/mesh.py", "launch/dryrun.py",
                "kernels/region.py", "roofline/op_stats.py", "roofline/report.py")
# sharding and elastic re-meshing, the last modules of the JAX package to port
SHARDING_MODULES = ("parallel/__init__.py", "parallel/sharding.py", "runtime/elastic.py",
                    "launch/mesh.py")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    """Nor triton: every kernel of the port is CUDA C++."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_guard_covers_the_training_modules():
    port = ROOT / "src" / "repro_torch"
    assert all(port / m in PORT_FILES for m in TRAINING_MODULES)


def test_import_guard_covers_the_plane_modules():
    port = ROOT / "src" / "repro_torch"
    assert all(port / m in PORT_FILES for m in PLANE_MODULES)


def test_import_guard_covers_the_cells_the_dryrun_and_the_100m_example():
    port = ROOT / "src" / "repro_torch"
    assert all(port / m in PORT_FILES for m in CELL_MODULES)
    assert ROOT / "examples" / "torch_train_100m.py" in PORT_FILES


def test_import_guard_covers_the_sharding_and_elastic_modules():
    port = ROOT / "src" / "repro_torch"
    assert all(port / m in PORT_FILES for m in SHARDING_MODULES)
    assert ROOT / "examples" / "torch_elastic_training.py" in PORT_FILES


@pytest.mark.parametrize("module", SHARDING_MODULES)
def test_sharding_module_names_its_twin(module):
    """Each module names its twin in the JAX package in its docstring, and the
    twin exists."""
    name = "repro." + module[:-3].replace("/", ".").removesuffix(".__init__")
    assert f"twin of ``{name}``" in " ".join(
        (ROOT / "src" / "repro_torch" / module).read_text().split())
    assert (ROOT / "src" / "repro" / module).exists()


def test_import_guard_covers_the_copied_plane_launchers_and_examples():
    port = ROOT / "src" / "repro_torch"
    assert all(port / m in PORT_FILES for m in COPIED_PLANE_MODULES)
    assert all(ROOT / "examples" / e in PORT_FILES for e in PORT_EXAMPLES)


@pytest.mark.parametrize("module", COPIED_PLANE_MODULES[:-2])
def test_copied_module_names_its_twin(module):
    """Each copied module opens with "Copy of ``repro.<module>``", and its twin in
    the JAX package exists."""
    name = "repro." + module[:-3].replace("/", ".").removesuffix(".__init__")
    text = (ROOT / "src" / "repro_torch" / module).read_text()
    assert text.startswith(f'"""Copy of ``{name}``'), text[:120]
    assert (ROOT / "src" / "repro" / module).exists()


def _example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(code: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_port_imports_with_jax_and_repro_blocked():
    out = _run(
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import repro_torch.core.plane, repro_torch.pipelines\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    assert int(out.strip().splitlines()[-1]) >= 20


def test_cpu_dispatch_takes_plain_path_without_triton_or_library():
    _run(
        "import sys\n"
        "sys.modules['triton'] = None\n"          # any import of triton raises
        "import torch\n"
        "from repro_torch.kernels import _build, ops, flash_attention as FA, rmsnorm as RN\n"
        "from repro_torch.kernels import ssd_scan as SS\n"
        "q = torch.randn(1, 8, 4, 32); k = torch.randn(1, 8, 2, 32)\n"
        "o = ops.flash_attention(q, k, k)\n"
        "y = ops.rmsnorm(q, torch.ones(32))\n"
        "bm = torch.randn(1, 8, 16)\n"
        "s, h = ops.ssd_scan(q, torch.rand(1, 8, 4), -torch.ones(4), bm, bm, chunk=4,\n"
        "                    return_state=True)\n"
        "r, z = ops.add_rmsnorm(q, q, torch.ones(32))\n"
        "g = ops.gated_rmsnorm(q, q, torch.ones(32))\n"
        "pos = torch.arange(8, dtype=torch.int32)[None]\n"
        "rq, rk = ops.qk_norm_rope(q, k, torch.ones(32), torch.ones(32), pos, 1e4)\n"
        "assert o.shape == q.shape and y.shape == q.shape and s.shape == q.shape\n"
        "assert r.shape == z.shape == g.shape == rq.shape == q.shape and rk.shape == k.shape\n"
        "assert h.shape == (1, 4, 16, 32)\n"
        "assert _build.loaded() == {}, _build.loaded()\n"
        "assert FA.flash_attention_cuda.launches == 0 and RN.rmsnorm_cuda.launches == 0\n"
        "assert RN.add_rmsnorm_cuda.launches == RN.gated_rmsnorm_cuda.launches == 0\n"
        "assert RN.qk_norm_rope_cuda.launches == 0\n"
        "assert SS.ssd_scan_cuda.launches == 0\n"
        "assert sys.modules['triton'] is None\n")


def test_cpu_grads_flow_through_the_functions_without_a_library():
    """On CPU tensors that require grad, every op of the dense training path
    enters its autograd Function, runs the plain forward and explicit backward,
    gives every input a gradient, and loads no compiled library."""
    _run(
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "from repro_torch.kernels import _build, ops\n"
        "from repro_torch.kernels import flash_attention as FA, rmsnorm as RN\n"
        "q = torch.randn(1, 8, 4, 32, requires_grad=True)\n"
        "k = torch.randn(1, 8, 2, 32, requires_grad=True)\n"
        "v = torch.randn(1, 8, 2, 32, requires_grad=True)\n"
        "w = torch.ones(32, requires_grad=True)\n"
        "pos = torch.arange(8, dtype=torch.int32)[None]\n"
        "qr, kr = ops.qk_norm_rope(q, k, w, w, pos, 1e4)\n"
        "o = ops.flash_attention(qr, kr, v)\n"
        "s, y = ops.add_rmsnorm(o, q, w)\n"
        "out = ops.rmsnorm(y, w)\n"
        "names = {type(t.grad_fn).__name__ for t in (qr, o, y, out)}\n"
        "assert names == {'QkNormRopeBackward', 'FlashAttentionBackward',\n"
        "                 'AddRMSNormBackward', 'RMSNormBackward'}, names\n"
        "(out.square().sum() + s.sum()).backward()\n"
        "for t in (q, k, v, w):\n"
        "    assert t.grad is not None and bool(t.grad.abs().sum() > 0)\n"
        "assert _build.loaded() == {}, _build.loaded()\n"
        "for fn in (FA.flash_attention_cuda, FA.flash_attention_bwd_cuda, RN.rmsnorm_cuda,\n"
        "           RN.rmsnorm_bwd_cuda, RN.add_rmsnorm_cuda, RN.add_rmsnorm_bwd_cuda,\n"
        "           RN.qk_norm_rope_cuda, RN.qk_norm_rope_bwd_cuda):\n"
        "    assert fn.launches == 0\n"
        "assert sys.modules['triton'] is None\n")


def _wrapper_calls(grad: bool) -> dict:
    """{wrapper name: call} of every kernel wrapper on small CPU tensors; with
    ``grad`` the first input requires grad."""
    q = torch.randn(1, 8, 4, 32, requires_grad=grad)
    k, sc, bm = torch.randn(1, 8, 2, 32), torch.ones(32), torch.randn(1, 8, 16)
    lse = torch.zeros(1, 4, 8)
    pos = torch.arange(8, dtype=torch.int32)[None]
    return {
        "flash_attention_cuda": lambda: FA.flash_attention_cuda(q, q, q),
        "flash_attention_bwd_cuda": lambda: FA.flash_attention_bwd_cuda(q, q, q, q, lse, q),
        "rmsnorm_cuda": lambda: RN.rmsnorm_cuda(q, sc),
        "rmsnorm_bwd_cuda": lambda: RN.rmsnorm_bwd_cuda(q, sc, q),
        "add_rmsnorm_cuda": lambda: RN.add_rmsnorm_cuda(q, q, sc),
        "add_rmsnorm_bwd_cuda": lambda: RN.add_rmsnorm_bwd_cuda(q, sc, q, q),
        "gated_rmsnorm_cuda": lambda: RN.gated_rmsnorm_cuda(q, q, sc),
        "gated_rmsnorm_bwd_cuda": lambda: RN.gated_rmsnorm_bwd_cuda(q, q, sc, q),
        "qk_norm_rope_cuda": lambda: RN.qk_norm_rope_cuda(q, k, sc, sc, pos, 1e4),
        "qk_norm_rope_bwd_cuda":
            lambda: RN.qk_norm_rope_bwd_cuda(q, k, sc, sc, pos, 1e4, q, k),
        "ssd_scan_cuda": lambda: SS.ssd_scan_cuda(q, torch.rand(1, 8, 4), -torch.ones(4),
                                                  bm, bm, chunk=4),
        "ssd_scan_bwd_cuda": lambda: SS.ssd_scan_bwd_cuda(
            q, torch.rand(1, 8, 4), -torch.ones(4), bm, bm, None, q, None, chunk=4),
    }


ALL_WRAPPERS = [FA.flash_attention_cuda, FA.flash_attention_bwd_cuda, RN.rmsnorm_cuda,
                RN.rmsnorm_bwd_cuda, RN.add_rmsnorm_cuda, RN.add_rmsnorm_bwd_cuda,
                RN.gated_rmsnorm_cuda, RN.gated_rmsnorm_bwd_cuda, RN.qk_norm_rope_cuda,
                RN.qk_norm_rope_bwd_cuda, SS.ssd_scan_cuda, SS.ssd_scan_bwd_cuda]


@pytest.mark.parametrize("name", [fn.__name__ for fn in ALL_WRAPPERS])
def test_every_wrapper_refuses_an_input_that_requires_grad(name):
    """Called directly while autograd records, a wrapper would hand back an output
    with no grad_fn: it raises instead, before any other check."""
    call = _wrapper_calls(grad=True)[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():                 # not recording: the usual device check
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(fn.launches == 0 for fn in ALL_WRAPPERS)


def test_trainer_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown trainer mode 'diloco'"):
        Trainer(TrainJobConfig(mode="diloco", device="cpu"))


def test_local_sgd_mode_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TrainJobConfig(mode="local_sgd"))
    with pytest.raises(RuntimeError, match="cuda"):
        run_train_task(None, {"mode": "local_sgd", "steps": 4})
    tr = Trainer(TrainJobConfig(mode="local_sgd", device="cpu", seq_len=8, global_batch=2))
    assert {t.device.type for _, t in tree_flatten_sorted(tr.state)} == {"cpu"}


def test_cuda_wrappers_refuse_cpu_tensors():
    """Every kernel wrapper, the backward ones included, refuses CPU tensors and
    counts no launch."""
    calls = _wrapper_calls(grad=False)
    assert sorted(calls) == sorted(fn.__name__ for fn in ALL_WRAPPERS)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(fn.launches == 0 for fn in ALL_WRAPPERS)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("qwen3-0.6b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        Server(ServeJobConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        run_serve_task(None, {"n_requests": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        to_torch({})
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TrainJobConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        run_train_task(None, {"steps": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        run_eval_task(None, {})
    plane = TorchLocalPlane()
    assert plane.device == "cuda"
    for kind in ("train", "serve"):
        with pytest.raises(RuntimeError, match="cuda"):
            plane.submit({"job_id": kind, "kind": kind, "payload": {"steps": 1}})
    for handlers in (DEFAULT_HANDLERS, WarmHandlers().handlers):
        for kind in ("train", "eval", "serve"):
            with pytest.raises(RuntimeError, match="cuda"):
                handlers[kind]({"steps": 1, "n_requests": 1})
    elastic = _example("torch_elastic_training")
    with pytest.raises(RuntimeError, match="cuda"):
        elastic.main()
    assert Server(ServeJobConfig(device="cpu")).device.type == "cpu"
    assert Trainer(TrainJobConfig(device="cpu", seq_len=8, global_batch=2)).device.type \
        == "cpu"
