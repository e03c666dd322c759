"""Paper §5 end to end on the PyTorch port: a hybrid Airflow/Composer
ETL->train->eval->export DAG, twin of ``examples/hybrid_pipeline.py``.

Scheduler/broker/taskdb live on the public master; one worker is public (the
cheap IO tier), one is on-prem (the accelerator tier). The 'train' task is
compliance-tagged to run on-prem (the paper's "data must stay private" case);
every hop between worker and broker/db crosses the hybrid platform's gateways.
The workers run the port's task handlers: qwen3-0.6b at full width on the card
(the default), the reduced config with ``device="cpu"``.

Two workload optimizations ride the same run:

  * roofline-cost-aware routing (``cost_aware=True``): each task is priced as
    a cost vector and its steering tag joins the queue name — the compute-
    bound train/eval stages ride the ``accel`` queues to the on-prem worker,
    the IO-bound extract/export stages ride ``cheap-io`` to the public one;
  * the step cache: train and eval share one warm Trainer on the on-prem
    worker (eval re-binds it instead of rebuilding).

  PYTHONPATH=src python examples/torch_hybrid_pipeline.py          # needs a card
  PYTHONPATH=src python examples/torch_hybrid_pipeline.py --device cpu
"""
import argparse
import tempfile

from repro_torch.core.plane import ManagementPlane, SimLocalPlane
from repro_torch.pipelines import DAG, Task, HybridComposer


def main(device: str = "cuda", checkpoint_dir: str = None) -> dict:
    """Run the DAG; the train task checkpoints into ``checkpoint_dir`` (default:
    a fresh temporary directory). Returns the DAG's task rows by name."""
    reduced = device == "cpu"
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=SimLocalPlane(caps=("control", "cheap-io")))
    plane.add_cluster("onprem",
                      local_plane=SimLocalPlane(caps=("cpu", "onprem",
                                                      "accel")))
    comp = HybridComposer(
        plane,
        workers={"master": ["w-public"], "onprem": ["w-onprem"]},
        # queue names are capability sets: with cost_aware on, the steered
        # queues are the steering tags (plus any compliance pins), so each
        # worker subscribes the queues its tier should drain
        worker_queues={"w-public": ("cheap-io", "default"),
                       "w-onprem": ("accel", "accel,onprem", "onprem",
                                    "default")},
        cost_aware=True)

    ck_dir = checkpoint_dir or tempfile.mkdtemp(prefix="titchener_pipeline_ck_")
    dag = DAG("daily_finetune", [
        Task("extract", kind="etl", payload={"batches": 3, "seq_len": 32}),
        Task("train_private", kind="train", upstream=("extract",),
             requires=("onprem",),                 # compliance pin
             payload={"arch": "qwen3-0.6b", "steps": 6, "seq_len": 32,
                      "global_batch": 4, "checkpoint_dir": ck_dir,
                      "reduced": reduced, "device": device}),
        Task("evaluate", kind="eval", upstream=("train_private",),
             payload={"arch": "qwen3-0.6b", "seq_len": 32, "global_batch": 4,
                      "restore_from": {"path": ck_dir},
                      "reduced": reduced, "device": device}),
        Task("export", kind="export", upstream=("evaluate",),
             payload={"arch": "qwen3-0.6b", "reduced": reduced}),
    ])
    comp.add_dag(dag)
    ok = comp.run_dag("daily_finetune", max_ticks=400)
    print("DAG success:", ok)
    state = comp.taskdb.handle({"op": "dag_state",
                                "dag": "daily_finetune"})["tasks"]
    for name, row in sorted(state.items()):
        print(f"  {name:15s} {row['status']:8s} worker={row.get('worker')} "
              f"result={row.get('result')}")
    # cost-aware steering: compute-bound stages on the accel tier, IO-bound
    # on the cheap tier; train+eval shared one warm Trainer
    assert state["train_private"]["worker"] == "w-onprem"
    assert state["evaluate"]["worker"] == "w-onprem"
    assert state["extract"]["worker"] == "w-public"
    assert state["export"]["worker"] == "w-public"
    cache = comp.workers[1].trainer_cache()
    print(f"step cache: {cache.stats()}")
    rep = plane.boundary_report()
    print(f"cross-cloud bytes {rep['cross_cluster_bytes']:,}, "
          f"locality {rep['locality_ratio']:.1%}")
    assert ok
    assert state["evaluate"]["result"]["restored_step"] == 6
    assert state["train_private"]["result"]["ran_steps"] == 6
    assert cache.stats() == {"hits": 1, "misses": 1, "evictions": 0, "size": 1}
    return state


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
