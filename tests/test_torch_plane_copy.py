"""PyTorch port, its copy of the management and pipeline planes
(``repro_torch.core``, ``pipelines``, ``autoscale``, ``observability``) against
the JAX package's originals: each scenario runs once through ``repro``'s objects
and once through the port's, on the fabric's deterministic clock, and every
observable (job status, the overwatch op log, the boundary ledger, the DAG's
taskdb rows and queues, the autoscaler's pods and events) is compared field for
field. Each run keeps its objects within one package."""
import importlib

import pytest

pytest.importorskip("jax")

PACKAGES = ("repro", "repro_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _ledger(plane) -> dict:
    rep = plane.boundary_report()
    return {"report": rep, "op_log": list(plane.overwatch.op_log),
            "fabric": dict(plane.fabric.stats)}


# ----------------------------------------------------- 1. a fleet loses a cluster
def _fleet_loses_a_cluster(pkg: str) -> dict:
    P = _mod(pkg, "core.plane")
    plane = P.ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=P.SimLocalPlane(caps=("control",)))
    for i in range(3):
        plane.add_cluster(f"onprem-{i}", local_plane=P.SimLocalPlane(("cpu",), 1.0 + i))
    jobs = [plane.submit_job("sim", steps=30, tags={"requires": ("cpu",)})
            for _ in range(4)]
    plane.tick(n=3)
    jid = jobs[0]
    placed = plane.overwatch.handle(
        {"op": "get", "key": f"/jobs/{jid}/placement"})["value"]["cluster"]
    # the hosting cluster commits a manifest, then drops off the fabric: its
    # lease expires and the dispatcher re-dispatches from the manifest
    plane.agents[placed].ow.put(f"/checkpoints/{jid}",
                                {"step": 5, "progress": 5.0, "path": f"ck/{jid}"})
    plane.tick(n=2)
    plane.fabric.partition_cluster(placed)
    done = plane.run_until_done(jobs, max_ticks=200)
    moved = plane.overwatch.handle(
        {"op": "get", "key": f"/jobs/{jid}/placement"})["value"]["cluster"]
    resubmitted = plane.agents[moved].local_plane.jobs[jid]["job"]
    return {"done": done, "placed": placed, "moved": moved,
            "restore_from": resubmitted.get("restore_from"),
            "status": {j: plane.job_status(j) for j in jobs}, **_ledger(plane)}


# ------------------------------------------- 2. examples/hybrid_pipeline.py's DAG
def _stub_handlers(pkg: str) -> dict:
    """Deterministic train/eval results (the plane, not the substrate, is under
    test: the port's real handlers are held to the JAX ones elsewhere), and the
    port's etl and export, whose results equal the JAX package's."""
    from repro_torch.pipelines import DEFAULT_HANDLERS
    return {"etl": DEFAULT_HANDLERS["etl"], "export": DEFAULT_HANDLERS["export"],
            "train": lambda p: {"steps": p["steps"], "ran_steps": p["steps"],
                                "loss": 1.25, "checkpoint": {"step": p["steps"],
                                                             "path": p["checkpoint_dir"]}},
            "eval": lambda p: {"restored_step": 6, "eval_loss": 2.5}}


def _hybrid_pipeline(pkg: str) -> dict:
    P, PL = _mod(pkg, "core.plane"), _mod(pkg, "pipelines")
    S = _mod(pkg, "pipelines.scheduler")
    plane = P.ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=P.SimLocalPlane(caps=("control", "cheap-io")))
    plane.add_cluster("onprem", local_plane=P.SimLocalPlane(caps=("cpu", "onprem", "accel")))
    handlers = _stub_handlers(pkg)

    def setup(worker):
        for kind, fn in handlers.items():
            worker.register(kind, fn)

    comp = PL.HybridComposer(
        plane, workers={"master": ["w-public"], "onprem": ["w-onprem"]},
        worker_queues={"w-public": ("cheap-io", "default"),
                       "w-onprem": ("accel", "accel,onprem", "onprem", "default")},
        cost_aware=True, worker_setup=setup)
    ck_dir = "ck/daily_finetune"
    dag = PL.DAG("daily_finetune", [
        PL.Task("extract", kind="etl", payload={"batches": 3, "seq_len": 32}),
        PL.Task("train_private", kind="train", upstream=("extract",), requires=("onprem",),
                payload={"arch": "qwen3-0.6b", "steps": 6, "seq_len": 32,
                         "global_batch": 4, "checkpoint_dir": ck_dir}),
        PL.Task("evaluate", kind="eval", upstream=("train_private",),
                payload={"arch": "qwen3-0.6b", "seq_len": 32, "global_batch": 4,
                         "restore_from": {"path": ck_dir}}),
        PL.Task("export", kind="export", upstream=("evaluate",),
                payload={"arch": "qwen3-0.6b"}),
    ])
    queues = {t.name: S.queue_for(t, cost_aware=True) for t in dag.tasks.values()}
    comp.add_dag(dag)
    ok = comp.run_dag("daily_finetune", max_ticks=400)
    state = comp.taskdb.handle({"op": "dag_state", "dag": "daily_finetune"})["tasks"]
    return {"ok": ok, "state": state, "queues": queues, "rows": dict(comp.taskdb.rows),
            "taskdb_ops": dict(comp.taskdb.op_counts),
            "broker_queues": sorted(comp.broker.queues), "broker": dict(comp.broker.stats),
            "executed": {w.pod: w.executed for w in comp.workers}, **_ledger(plane)}


# ------------------------------------------------- 3. one autoscaler up and down
def _autoscale_up_and_drain(pkg: str) -> dict:
    P, PL = _mod(pkg, "core.plane"), _mod(pkg, "pipelines")
    A = _mod(pkg, "autoscale")
    plane = P.ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=P.SimLocalPlane(caps=("control",)))
    plane.add_cluster("onprem-a", local_plane=P.SimLocalPlane(caps=("cpu", "onprem")))
    plane.add_cluster("cloud-a", local_plane=P.SimLocalPlane(caps=("cpu",)))
    comp = PL.HybridComposer(plane, workers={}, worker_batch=4)
    policy = A.ScalingPolicy(family="default", queues=("default",), requires=("cpu",),
                             target_depth_per_worker=8, min_replicas=0, max_replicas=4,
                             scale_up_step=4, scale_down_step=2,
                             up_cooldown=0.0, down_cooldown=0.0)
    asc = comp.attach_autoscaler([policy], quotas={"onprem-a": 2, "master": 0},
                                 preferred=("onprem-a",))
    comp.add_dag(PL.DAG("burst", [PL.Task(f"a{i}", kind="python", payload={"i": i})
                                  for i in range(60)]))
    peak, ticks = 0, 0
    for ticks in range(1, 80):
        comp.tick()
        peak = max(peak, asc.replicas("default"))
        if comp.scheduler.dag_done("burst", probe=False) and asc.replicas("default") == 0:
            break
    state = comp.taskdb.handle({"op": "dag_state", "dag": "burst"})["tasks"]
    return {"peak": peak, "ticks": ticks, "replicas": asc.replicas("default"),
            "events": list(asc.events), "state": state,
            "success": comp.scheduler.dag_success("burst"), **_ledger(plane)}


SCENARIOS = {"fleet_loses_a_cluster": _fleet_loses_a_cluster,
             "hybrid_pipeline": _hybrid_pipeline,
             "autoscale_up_and_drain": _autoscale_up_and_drain}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_plane_gives_repros_results(name):
    jax_run, port_run = (SCENARIOS[name](pkg) for pkg in PACKAGES)
    assert jax_run.keys() == port_run.keys()
    for key in jax_run:
        assert port_run[key] == jax_run[key], key


def test_scenarios_exercise_what_they_name():
    fleet = _fleet_loses_a_cluster("repro_torch")
    assert fleet["done"] and fleet["moved"] != fleet["placed"]
    assert fleet["restore_from"]["step"] == 5
    assert fleet["report"]["cross_cluster_bytes"] > 0
    dag = _hybrid_pipeline("repro_torch")
    assert dag["ok"]
    assert {t: r["worker"] for t, r in dag["state"].items()} == {
        "extract": "w-public", "train_private": "w-onprem", "evaluate": "w-onprem",
        "export": "w-public"}
    assert dag["queues"]["train_private"] == "accel,onprem"
    assert dag["queues"]["extract"] == dag["queues"]["export"] == "cheap-io"
    scale = _autoscale_up_and_drain("repro_torch")
    assert scale["success"] and scale["peak"] == 4 and scale["replicas"] == 0
    kinds = {e[2] for e in scale["events"]}
    assert {"scale_up", "scale_down"} <= kinds
