"""Elastic + fault-tolerant training through the management plane, on the PyTorch
port. Twin of ``examples/elastic_training.py``.

Timeline: dispatch a training job to a 2-cluster fleet -> kill the hosting
cluster mid-run -> failure detector fires -> the dispatcher re-dispatches from
the last committed checkpoint manifest -> a NEW cluster joins and is visible to
subsequent placements. The clusters run the port's ``TorchLocalPlane``; an
``ElasticController`` on the port's overwatch sees every change of membership.
Prints the plane's op log tail as the audit trail. On the card (the default)
the job trains qwen3-0.6b at full width; ``--device cpu`` runs the reduced
config on the kernels' plain versions.

  PYTHONPATH=src python examples/torch_elastic_training.py          # needs a card
  PYTHONPATH=src python examples/torch_elastic_training.py --device cpu
"""
import argparse
import tempfile

from repro_torch.core.plane import ManagementPlane, SimLocalPlane
from repro_torch.device import resolve
from repro_torch.runtime.elastic import ElasticController
from repro_torch.runtime.local_plane import TorchLocalPlane


def add_torch_cluster(plane, name, device, root):
    plane.add_cluster(name, local_plane=TorchLocalPlane(
        steps_per_poll=3,
        publish=lambda jid, man, _n=name: plane.agents[_n].ow.put(
            f"/checkpoints/{jid}", man),
        device=device, checkpoint_root=f"{root}/{name}"))


def main(device: str = "cuda", checkpoint_root: str = None) -> dict:
    """Run the timeline; checkpoints go under ``checkpoint_root`` (default: a
    fresh temporary directory). Returns the job's status, the cluster it was
    killed on and the memberships the controller saw. Without a card, "cuda"
    raises before any cluster is added."""
    resolve(device)
    root = checkpoint_root or tempfile.mkdtemp(prefix="titchener_elastic_")
    reduced = device == "cpu"
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=SimLocalPlane(caps=("control",)))
    for n in ("zone-a", "zone-b"):
        add_torch_cluster(plane, n, device, root)

    memberships = []
    ElasticController(plane.overwatch,
                      lambda m: memberships.append(tuple(m)))

    jid = plane.submit_job(
        "train", arch="qwen3-0.6b", steps=12, tags={"requires": ("train",)},
        payload={"arch": "qwen3-0.6b", "steps": 12, "seq_len": 16,
                 "global_batch": 2, "checkpoint_every": 4,
                 "reduced": reduced, "device": device})
    # run until the first checkpoint manifest commits
    for _ in range(40):
        plane.tick()
        if plane.overwatch.handle(
                {"op": "get", "key": f"/checkpoints/{jid}"})["value"]:
            break
    placed = plane.overwatch.handle(
        {"op": "get", "key": f"/jobs/{jid}/placement"})["value"]["cluster"]
    print(f"checkpoint committed while running on {placed}; killing it")
    plane.fabric.partition_cluster(placed)

    add_torch_cluster(plane, "zone-c", device, root)     # elastic join mid-failure
    assert plane.run_until_done([jid], max_ticks=300)
    st = plane.job_status(jid)
    print(f"job finished on {st['cluster']} (progress {st['progress']}, "
          f"loss {st.get('loss')})")
    assert st["cluster"] != placed
    print(f"membership transitions seen by the elastic controller: "
          f"{len(memberships)}")
    print("last membership:", memberships[-1])
    print("\noverwatch op-log tail (the audit trail):")
    for rev, op, key, _ in plane.overwatch.op_log[-5:]:
        print(f"  rev {rev:4d} {op:7s} {key}")
    return {"status": st, "killed": placed, "memberships": memberships}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
