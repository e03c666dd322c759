"""PyTorch port, its entry points: ``python -m repro_torch.launch.train`` and
``launch.serve`` in both modes with ``--device cpu`` (the reduced config), the
driver mode's losses and tokens equal to the direct mode's; the port's plane
drives the train job as ``repro``'s ``ManagementPlane`` does (the same job
status and boundary bytes); the port's examples run; and without a card the
launchers raise instead of running on the CPU."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.runtime.local_plane import TorchLocalPlane  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARGS = ["--device", "cpu", "--steps", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread runs them as fast, and keeps them fast
    beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer_of(plane, jid):
    cluster = plane.job_status(jid)["cluster"]
    return plane.agents[cluster].local_plane.jobs[jid].trainer


def test_train_driver_losses_equal_direct(tmp_path, capsys):
    driver = train_launcher.main(TRAIN_ARGS + ["--checkpoint-dir", str(tmp_path)])
    plane, jid = driver["plane"], driver["job"]
    st = plane.job_status(jid)
    assert st["status"] == "done" and st["progress"] == 4.0
    tr = _trainer_of(plane, jid)
    assert tr.cfg.reduced and tr.device.type == "cpu"
    direct = train_launcher.main(TRAIN_ARGS + ["--direct"])["trainer"]
    losses = tr.metrics.series("loss")
    assert len(losses) == 4 and losses == direct.metrics.series("loss")
    out = capsys.readouterr().out
    assert f"dispatched {jid}" in out and "boundary:" in out and "step     4 loss" in out


def test_serve_driver_tokens_equal_direct():
    direct = serve_launcher.main(["--device", "cpu"])
    driver = serve_launcher.main(["--device", "cpu", "--driver"])
    assert driver["ok"] and len(direct["done"]) == 6
    plane, jid = driver["plane"], driver["job"]
    cluster = plane.job_status(jid)["cluster"]
    server = plane.agents[cluster].local_plane.jobs[jid].server
    assert server.device.type == "cpu"
    got = [r.generated for r in server.requests.values()]
    assert got == [r.generated for r in direct["done"]]
    assert all(len(g) == 8 for g in got)


def test_port_plane_drives_the_train_job_as_repros_does():
    """The launcher's driver-mode fleet, once on the port's plane and once on
    ``repro``'s ``ManagementPlane`` with the same ``TorchLocalPlane``s."""
    pytest.importorskip("jax")
    from repro.core.plane import ManagementPlane as JaxPlane
    from repro_torch.core.plane import ManagementPlane as PortPlane
    payload = {"arch": "qwen3-0.6b", "steps": 4, "seq_len": 64, "global_batch": 8,
               "mode": "sync", "checkpoint_dir": None, "reduced": True, "device": "cpu"}

    def run(plane_cls):
        plane = plane_cls()
        plane.add_cluster("master", is_master=True, local_plane=TorchLocalPlane(device="cpu"))
        for i in range(2):
            plane.add_cluster(f"private-{i}", local_plane=TorchLocalPlane(device="cpu"))
        jid = plane.submit_job("train", arch="qwen3-0.6b", steps=4, payload=payload)
        assert plane.run_until_done([jid], max_ticks=140)
        return (plane.job_status(jid), plane.boundary_report()["cross_cluster_bytes"],
                _trainer_of(plane, jid).metrics.series("loss"))

    assert run(PortPlane) == run(JaxPlane)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_batched_example_on_cpu():
    done = _example("torch_serve_batched").main(device="cpu")
    assert [len(r.generated) for r in done] == [12, 4, 8, 6, 10, 5]


def test_hybrid_pipeline_example_on_cpu(tmp_path):
    state = _example("torch_hybrid_pipeline").main(device="cpu",
                                                  checkpoint_dir=str(tmp_path / "ck"))
    assert all(row["status"] == "success" for row in state.values())
    assert state["export"]["result"]["exported_params"] > 0


def test_quickstart_example_on_cpu(tmp_path):
    out = _example("torch_quickstart").main(device="cpu", checkpoint_root=str(tmp_path))
    plane = out["plane"]
    assert {plane.job_status(j)["status"] for j in (out["train"], out["serve"])} == {"done"}
    assert plane.agents["master"].local_plane.jobs == {}        # the master runs no job


@pytest.mark.parametrize("argv", [[], ["--direct"]], ids=["driver", "direct"])
def test_train_launcher_raises_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_launcher.main(["--steps", "1"] + argv)


@pytest.mark.parametrize("argv", [[], ["--driver"]], ids=["direct", "driver"])
def test_serve_launcher_raises_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_launcher.main(["--requests", "1"] + argv)
