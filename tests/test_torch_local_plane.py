"""PyTorch port, plane integration: ``TorchLocalPlane`` and ``Server.pending()``
against ``repro``'s ``JaxLocalPlane`` and JAX ``Server`` on the same payloads, and
the management plane (``repro.core.plane.ManagementPlane``, which drives a local
plane through the five calls its control agent makes) running a port train job
through the loss of its cluster. Reduced qwen3-0.6b (bf16) on ``device="cpu"``.

Tolerances: the port's own resumed run against its uninterrupted run at rel 1e-5
(tests/test_fault_tolerance.py's); a port run resumed from a JAX checkpoint against
the JAX run at tests/test_torch_train.py's ``BF16_LOSS_TOL``, the model being bf16.
The JAX reference is built on an Auto-axis mesh, as in tests/test_torch_model.py,
and computed once for the module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime.local_plane import TorchLocalPlane  # noqa: E402
from repro_torch.runtime.serve_loop import Server, ServeJobConfig  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, TrainJobConfig  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

ARCH = "qwen3-0.6b"
TRAIN = {"arch": ARCH, "steps": 8, "seq_len": 16, "global_batch": 2, "checkpoint_every": 4}
# a mixed-length stream: more requests than slots, two prompt lengths, 2-6 new tokens
SERVE = {"arch": ARCH, "slots": 2, "max_len": 32,
         "requests": [{"prompt": [1 + i, 2, 3] + [4] * (2 * (i % 2)), "max_new": 2 + i % 5}
                      for i in range(6)]}
BF16_LOSS_TOL = 0.02     # tests/test_torch_train.py's: bf16 CE in two frameworks


def _jax():
    return pytest.importorskip("jax")


def _auto_mesh():
    jax = _jax()
    from jax.sharding import AxisType, Mesh
    return Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def _poll_to_end(plane, jid, after=None):
    """Every poll dict of ``jid`` until it is done, and ``after(plane)`` after each."""
    polls, seen = [], []
    while not polls or polls[-1]["status"] == "running":
        polls.append(plane.poll(jid))
        if after is not None:
            seen.append(after(plane))
        assert len(polls) < 100
    return polls, seen


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JaxLocalPlane's train job (8 steps, a manifest at 4 and 8) and serve job
    (one step a poll, ``Server.pending()`` read after each)."""
    _jax()
    from repro.runtime.local_plane import JaxLocalPlane
    mesh = _auto_mesh()
    published = []
    plane = JaxLocalPlane(steps_per_poll=2, mesh=mesh,
                          publish=lambda jid, man: published.append(man),
                          checkpoint_root=str(tmp_path_factory.mktemp("jax")))
    plane.submit({"job_id": "t", "kind": "train", "payload": TRAIN})
    train_polls, _ = _poll_to_end(plane, "t")
    serve_plane = JaxLocalPlane(steps_per_poll=1, mesh=mesh)
    serve_plane.submit({"job_id": "s", "kind": "serve", "payload": SERVE})
    serve_polls, pending = _poll_to_end(serve_plane, "s",
                                        lambda p: p.jobs["s"].server.pending())
    return {"train_polls": train_polls, "published": published,
            "losses": plane.jobs["t"].trainer.metrics.series("loss"),
            "serve_polls": serve_polls, "pending": pending}


def test_server_pending_matches_jax_after_every_step(jax_runs):
    srv = Server(ServeJobConfig(**{k: v for k, v in SERVE.items() if k != "requests"},
                                device="cpu"))
    for r in SERVE["requests"]:
        srv.submit(r["prompt"], r["max_new"])
    assert srv.pending() == len(SERVE["requests"])
    pending = []
    while not pending or pending[-1]:
        srv.step()
        pending.append(srv.pending())
    assert pending == jax_runs["pending"]
    assert all(r.done for r in srv.requests.values())


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_poll_dicts_match_jax_local_plane(kind, jax_runs, tmp_path):
    payload, steps_per_poll = (TRAIN, 2) if kind == "train" else (SERVE, 1)
    plane = TorchLocalPlane(steps_per_poll=steps_per_poll, device="cpu",
                            checkpoint_root=str(tmp_path))
    plane.submit({"job_id": "j", "kind": kind, "payload": payload})
    got, _ = _poll_to_end(plane, "j")
    want = jax_runs[f"{kind}_polls"]
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    assert [(p["status"], p["progress"]) for p in got] == \
        [(p["status"], p["progress"]) for p in want]
    assert got[-1]["rate"] == 0.0 and plane.load() == 0.0
    if kind == "serve":
        assert got[-1]["served"] == len(SERVE["requests"])


def test_job_survives_cluster_loss(tmp_path):
    """Twin of tests/test_fault_tolerance.py::test_jax_job_survives_cluster_loss:
    the management plane re-dispatches the job from its published manifest, and the
    resumed run's losses are the uninterrupted run's."""
    from repro.core.plane import ManagementPlane, SimLocalPlane
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True, local_plane=SimLocalPlane(caps=("control",)))
    locals_ = {}
    for name in ("gpu-a", "gpu-b"):
        locals_[name] = TorchLocalPlane(
            steps_per_poll=3, device="cpu", checkpoint_root=str(tmp_path / name),
            publish=lambda jid, man, _n=name: plane.agents[_n].ow.put(
                f"/checkpoints/{jid}", man))
        plane.add_cluster(name, local_plane=locals_[name])
    payload = {"arch": ARCH, "steps": 12, "seq_len": 16, "global_batch": 2,
               "checkpoint_every": 4}
    jid = plane.submit_job("train", arch=ARCH, steps=12, tags={"requires": ("train",)},
                           payload=payload)
    for _ in range(6):
        plane.tick()
        ck = plane.overwatch.handle({"op": "get", "key": f"/checkpoints/{jid}"})["value"]
        if ck:
            break
    assert ck, "no checkpoint committed before failure injection"
    placed = plane.overwatch.handle(
        {"op": "get", "key": f"/jobs/{jid}/placement"})["value"]["cluster"]
    plane.fabric.partition_cluster(placed)
    assert plane.run_until_done([jid], max_ticks=120)
    placement = plane.overwatch.handle(
        {"op": "get", "key": f"/jobs/{jid}/placement"})["value"]
    assert placement["cluster"] != placed
    st = plane.job_status(jid)
    assert st["status"] == "done" and st["progress"] == 12.0

    resumed = locals_[placement["cluster"]].jobs[jid].trainer
    start = placement["job"]["restore_from"]["step"]
    assert start >= 4 and resumed.metrics.rows[0]["step"] == start + 1
    ref = Trainer(TrainJobConfig(**payload, device="cpu"))
    ref.run()
    assert resumed.metrics.series("loss") == pytest.approx(
        ref.metrics.series("loss")[start:], rel=1e-5)


def test_port_job_resumes_from_a_jax_manifest(jax_runs, tmp_path):
    """A JaxLocalPlane job's step-4 manifest restores in a TorchLocalPlane job, which
    runs to step 8 on the JAX pipeline's batches (the packages draw different
    numbers from one seed, ROADMAP §3): its losses are the JAX run's."""
    from repro.data.pipeline import SyntheticTokens as JTokens
    manifest = jax_runs["published"][0]
    assert manifest["step"] == 4
    jdata = JTokens(vocab_size=512, seq_len=TRAIN["seq_len"],
                    global_batch=TRAIN["global_batch"], seed=0)
    plane = TorchLocalPlane(device="cpu", checkpoint_root=str(tmp_path))
    plane.submit({"job_id": "j", "kind": "train", "payload": TRAIN,
                  "restore_from": manifest})
    trainer = plane.jobs["j"].trainer
    assert trainer.step == 4
    trainer.data.global_batch_at = lambda step: {
        k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16) if k == "loss_mask"
        else torch.from_numpy(np.array(v)) for k, v in jdata.global_batch_at(step).items()}
    polls, _ = _poll_to_end(plane, "j")
    assert [p["progress"] for p in polls] == [6.0, 8.0] and polls[-1]["status"] == "done"
    np.testing.assert_allclose(trainer.metrics.series("loss"), jax_runs["losses"][4:],
                               rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)


def test_no_card_fails_the_job_instead_of_running_on_the_cpu(monkeypatch, tmp_path):
    from repro.core.plane import ManagementPlane, SimLocalPlane
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    local = TorchLocalPlane(checkpoint_root=str(tmp_path))
    assert local.device == "cuda"
    for kind, payload in (("train", TRAIN), ("serve", SERVE)):
        with pytest.raises(RuntimeError, match="cuda"):
            local.submit({"job_id": kind, "kind": kind, "payload": payload})
    assert local.jobs == {}
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True, local_plane=SimLocalPlane(caps=("control",)))
    plane.add_cluster("gpu", local_plane=local)
    with pytest.raises(RuntimeError, match="dispatch failed.*cuda"):
        plane.submit_job("train", arch=ARCH, steps=8, tags={"requires": ("train",)},
                         payload=TRAIN)
    [rec] = plane.agents["gpu"].jobs.values()
    assert rec.status == "failed" and local.jobs == {}
