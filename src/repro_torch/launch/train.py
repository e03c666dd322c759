"""Training launcher of the PyTorch port, twin of ``repro.launch.train``.

Two modes:
  * ``--driver``   (default) — run a real training job (reduced config with
    ``--device cpu``, full on the card) through the port's management plane:
    registers clusters, dispatches a train job, ticks heartbeats, prints
    progress + the boundary byte ledger.
  * ``--direct``   — run the Trainer directly (no management plane), useful for
    quick loss-curve checks.

``--device`` (default ``cuda``) goes into the job's payload and picks the local
planes' device; without a card and without ``--device cpu`` the launcher raises.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --direct --mode local_sgd
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None) -> dict:
    """Run the launcher on ``argv`` (default: the command line). Returns
    ``{"trainer": Trainer}`` in ``--direct`` mode and ``{"plane":
    ManagementPlane, "job": job id}`` in driver mode."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mode", choices=("sync", "local_sgd"), default="sync")
    ap.add_argument("--direct", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--clusters", type=int, default=2,
                    help="driver mode: number of private clusters")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the reduced config, plain kernels)")
    args = ap.parse_args(argv)

    from repro_torch import device as devices
    devices.resolve(args.device)           # no card and not --device cpu: raise
    payload = {"arch": args.arch, "steps": args.steps, "seq_len": args.seq_len,
               "global_batch": args.global_batch, "mode": args.mode,
               "checkpoint_dir": args.checkpoint_dir,
               "reduced": args.device == "cpu", "device": args.device}

    if args.direct:
        from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
        tr = Trainer(TrainJobConfig.from_job({"payload": payload}))
        for _ in range(args.steps):
            m = tr.step_once()
            if tr.step % 5 == 0 or tr.step == args.steps:
                print(f"step {tr.step:5d} loss {m.get('loss', m.get('delta_norm', 0)):.4f} "
                      f"({tr.timer.tokens_per_s:.0f} tok/s)")
        return {"trainer": tr}

    from repro_torch.core.plane import ManagementPlane
    from repro_torch.runtime.local_plane import TorchLocalPlane

    plane = ManagementPlane()
    plane.add_cluster("master", is_master=True,
                      local_plane=TorchLocalPlane(device=args.device))
    for i in range(args.clusters):
        name = f"private-{i}"
        lp = TorchLocalPlane(
            publish=lambda jid, man, _n=name: plane.agents[_n].ow.put(
                f"/checkpoints/{jid}", man),
            device=args.device,
            checkpoint_root=args.checkpoint_dir or os.path.join(
                tempfile.gettempdir(), "titchener_ckpt"))
        plane.add_cluster(name, local_plane=lp)

    jid = plane.submit_job("train", arch=args.arch, steps=args.steps,
                           payload=payload)
    print(f"dispatched {jid}")
    done = plane.run_until_done([jid], max_ticks=10 * args.steps + 100)
    st = plane.job_status(jid)
    print(f"status: {json.dumps(st, indent=1)}")
    print("boundary:", json.dumps(plane.boundary_report()["cross_cluster_bytes"]))
    if not done:
        raise SystemExit("job did not finish in the tick budget")
    return {"plane": plane, "job": jid}


if __name__ == "__main__":
    main()
