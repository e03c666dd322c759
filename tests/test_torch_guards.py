"""Guards of the PyTorch port: it never imports jax or the JAX package, its entry
points never quietly run on the CPU when the card was asked for, and on CPU
tensors the kernel dispatch takes the plain path without touching triton or a
compiled library, and no port file imports triton."""
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
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.step_cache import run_serve_task  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "triton")


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


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 8, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        RN.rmsnorm_cuda(q, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        RN.add_rmsnorm_cuda(q, q, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        RN.gated_rmsnorm_cuda(q, q, torch.ones(32))
    k = torch.randn(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        RN.qk_norm_rope_cuda(q, k, torch.ones(32), torch.ones(32),
                             torch.arange(8, dtype=torch.int32)[None], 1e4)
    bm = torch.randn(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssd_scan_cuda(q, torch.rand(1, 8, 4), -torch.ones(4), bm, bm, chunk=4)
    assert FA.flash_attention_cuda.launches == 0 and RN.rmsnorm_cuda.launches == 0
    assert RN.add_rmsnorm_cuda.launches == RN.gated_rmsnorm_cuda.launches == 0
    assert RN.qk_norm_rope_cuda.launches == 0
    assert SS.ssd_scan_cuda.launches == 0


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
    assert Server(ServeJobConfig(device="cpu")).device.type == "cpu"
