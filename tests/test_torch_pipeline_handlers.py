"""PyTorch port, pipeline task handlers (``repro_torch.pipelines``) against the JAX
package's (``repro.pipelines.worker``): ``export`` and ``etl`` give exactly the
JAX numbers, and ``repro``'s ``HybridComposer``, whose workers take the port's
handlers through ``register``, runs the train task and the ETL -> train -> eval
-> export DAG of examples/hybrid_pipeline.py on ``device="cpu"`` with the
example's placements and results. Reduced qwen3-0.6b."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.pipelines import DEFAULT_HANDLERS, WarmHandlers  # noqa: E402
from test_torch_model import _one_torch_thread  # noqa: E402,F401

CPU = {"device": "cpu"}


def _worker_module():
    pytest.importorskip("jax")
    from repro.pipelines import worker
    return worker


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", tconfigs.names())
def test_export_matches_jax(arch, reduced):
    payload = {"arch": arch, "reduced": reduced}
    assert DEFAULT_HANDLERS["export"](payload) == _worker_module()._export(payload)


@pytest.mark.parametrize("payload", [{}, {"batches": 3, "seq_len": 32},
                                     {"batches": 1, "batch": 6, "vocab": 100, "seed": 2}])
def test_etl_matches_jax(payload):
    assert DEFAULT_HANDLERS["etl"](payload) == _worker_module()._etl(payload)


def test_warm_handlers_bind_train_eval_serve_to_their_caches():
    warm, cold = WarmHandlers(), WarmHandlers(0)
    assert set(warm.handlers) == set(cold.handlers) == set(DEFAULT_HANDLERS)
    assert cold.handlers == DEFAULT_HANDLERS
    for kind in ("train", "eval", "serve"):
        assert warm.handlers[kind] != DEFAULT_HANDLERS[kind]
    assert warm._trainer_cache is None and warm._server_cache is None   # built lazily
    res = warm.handlers["serve"]({"n_requests": 2, "max_new": 3, **CPU})
    assert res["requests"] == 2 and res["generated_tokens"] == 6
    assert warm.server_cache().stats()["misses"] == 1 and warm._trainer_cache is None


def _register_port_handlers(holders):
    """A composer ``worker_setup`` that gives each worker its own WarmHandlers."""
    def setup(worker):
        holders[worker.pod] = WarmHandlers(worker.step_cache)
        for kind, fn in holders[worker.pod].handlers.items():
            worker.register(kind, fn)
    return setup


def test_train_task_through_pipeline():
    """Twin of tests/test_pipelines.py::test_train_task_through_pipeline."""
    from repro.core.plane import ManagementPlane
    from repro.pipelines import DAG, HybridComposer, Task
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True)
    plane.add_cluster("onprem-a")
    holders = {}
    comp = HybridComposer(
        plane, workers={"master": ["w-pub"], "onprem-a": ["w-priv"]},
        worker_queues={"w-pub": ("default",), "w-priv": ("onprem", "default")},
        worker_setup=_register_port_handlers(holders))
    dag = DAG("t", [Task("train_tiny", kind="train",
                         payload={"arch": "qwen3-0.6b", "steps": 2, "seq_len": 8,
                                  "global_batch": 2, **CPU})])
    comp.add_dag(dag)
    assert comp.run_dag("t", max_ticks=60)
    row = comp.taskdb.handle({"op": "latest", "dag": "t", "task": "train_tiny"})["row"]
    assert row["result"]["steps"] == 2
    assert row["result"]["loss"] is not None
    assert holders[row["worker"]].trainer_cache().stats()["misses"] == 1
    assert all(w._trainer_cache is None for w in comp.workers)     # no JAX trainer


def test_hybrid_pipeline_dag_on_the_port(tmp_path):
    """Twin of examples/hybrid_pipeline.py's DAG: cost-aware placement puts train
    and eval on the on-prem worker, where eval rebinds train's warm Trainer (a
    cache hit) and strictly restores its step-6 checkpoint."""
    from repro.core.plane import ManagementPlane, SimLocalPlane
    from repro.pipelines import DAG, HybridComposer, Task
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=SimLocalPlane(caps=("control", "cheap-io")))
    plane.add_cluster("onprem", local_plane=SimLocalPlane(caps=("cpu", "onprem", "accel")))
    holders = {}
    comp = HybridComposer(
        plane, workers={"master": ["w-public"], "onprem": ["w-onprem"]},
        worker_queues={"w-public": ("cheap-io", "default"),
                       "w-onprem": ("accel", "accel,onprem", "onprem", "default")},
        cost_aware=True, worker_setup=_register_port_handlers(holders))
    ck_dir = str(tmp_path / "ck")
    dag = DAG("daily_finetune", [
        Task("extract", kind="etl", payload={"batches": 3, "seq_len": 32}),
        Task("train_private", kind="train", upstream=("extract",), requires=("onprem",),
             payload={"arch": "qwen3-0.6b", "steps": 6, "seq_len": 32, "global_batch": 4,
                      "checkpoint_dir": ck_dir, **CPU}),
        Task("evaluate", kind="eval", upstream=("train_private",),
             payload={"arch": "qwen3-0.6b", "seq_len": 32, "global_batch": 4,
                      "restore_from": {"path": ck_dir}, **CPU}),
        Task("export", kind="export", upstream=("evaluate",),
             payload={"arch": "qwen3-0.6b"}),
    ])
    comp.add_dag(dag)
    assert comp.run_dag("daily_finetune", max_ticks=400)
    state = comp.taskdb.handle({"op": "dag_state", "dag": "daily_finetune"})["tasks"]
    assert state["train_private"]["worker"] == "w-onprem"
    assert state["evaluate"]["worker"] == "w-onprem"
    assert state["extract"]["worker"] == "w-public"
    assert state["export"]["worker"] == "w-public"
    assert state["evaluate"]["result"]["restored_step"] == 6
    assert state["train_private"]["result"]["ran_steps"] == 6
    assert holders["w-onprem"].trainer_cache().stats() == \
        {"hits": 1, "misses": 1, "evictions": 0, "size": 1}
    assert state["extract"]["result"] == {"batches": 3, "tokens": 3 * 4 * 32}
    assert state["export"]["result"] == DEFAULT_HANDLERS["export"]({"arch": "qwen3-0.6b"})


def test_worker_cache_reuse_through_composer():
    """Twin of tests/test_workloads.py::test_worker_cache_reuse_through_composer: a
    chain of same-family train tasks on one worker builds one Trainer."""
    from repro.core.plane import ManagementPlane
    from repro.pipelines import DAG, HybridComposer, Task
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True)
    plane.add_cluster("onprem-a")
    holders = {}
    comp = HybridComposer(plane, workers={"onprem-a": ["w0"]}, step_cache=4,
                          worker_setup=_register_port_handlers(holders))
    payload = {"arch": "qwen3-0.6b", "steps": 1, "seq_len": 8, "global_batch": 2, **CPU}
    dag = DAG("c", [Task(f"s{i}", kind="train", payload=dict(payload),
                         upstream=(f"s{i - 1}",) if i else ()) for i in range(3)])
    comp.add_dag(dag)
    assert comp.run_dag("c", max_ticks=100)
    stats = holders["w0"].trainer_cache().stats()
    assert stats["misses"] == 1 and stats["hits"] == 2
    state = comp.taskdb.handle({"op": "dag_state", "dag": "c"})["tasks"]
    for row in state.values():
        assert row["status"] == "success"
        assert row["result"]["steps"] == 1 and row["result"]["ran_steps"] == 1
