"""Quickstart on the PyTorch port: the single pane of glass in ~40 lines.

Twin of ``examples/quickstart.py``. Builds a hybrid fleet (public master + two
private clusters) on the port's management plane, dispatches a real training
job and a serving job through the SAME interface, and prints the
boundary-traffic ledger. On the card (the default) the jobs run qwen3-0.6b at
full width; ``device="cpu"`` runs the reduced config on the kernels' plain
versions.

  PYTHONPATH=src python examples/torch_quickstart.py          # needs a card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import tempfile

from repro_torch.core.plane import ManagementPlane, SimLocalPlane
from repro_torch.runtime.local_plane import TorchLocalPlane


def main(device: str = "cuda", checkpoint_root: str = None) -> dict:
    """Run the quickstart; checkpoints go under ``checkpoint_root`` (default: a
    fresh temporary directory). Returns the plane and the two job ids."""
    root = checkpoint_root or tempfile.mkdtemp(prefix="titchener_quickstart_")
    reduced = device == "cpu"
    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=SimLocalPlane(caps=("control",)))
    for name in ("onprem-a", "onprem-b"):
        plane.add_cluster(name, local_plane=TorchLocalPlane(
            publish=lambda jid, man, _n=name: plane.agents[_n].ow.put(
                f"/checkpoints/{jid}", man),
            device=device, checkpoint_root=root))

    train_id = plane.submit_job(
        "train", arch="qwen3-0.6b", steps=10,
        tags={"requires": ("train",)},
        payload={"arch": "qwen3-0.6b", "steps": 10, "seq_len": 32,
                 "global_batch": 4, "checkpoint_every": 5,
                 "reduced": reduced, "device": device})
    serve_id = plane.submit_job(
        "serve", arch="qwen3-0.6b", tags={"requires": ("serve",)},
        payload={"arch": "qwen3-0.6b", "slots": 2, "max_len": 64,
                 "reduced": reduced, "device": device,
                 "requests": [{"prompt": [1, 2, 3], "max_new": 5},
                              {"prompt": [7, 8], "max_new": 4}]})

    assert plane.run_until_done([train_id, serve_id], max_ticks=300)
    for jid in (train_id, serve_id):
        st = plane.job_status(jid)
        print(f"{jid}: {st['status']} on {st['cluster']} "
              f"(progress {st['progress']})")

    rep = plane.boundary_report()
    print(f"cross-cloud bytes: {rep['cross_cluster_bytes']:,} "
          f"(locality {rep['locality_ratio']:.1%} local) — "
          "the paper's thin boundary, measured")
    return {"plane": plane, "train": train_id, "serve": serve_id}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
