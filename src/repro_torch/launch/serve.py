"""Serving launcher of the PyTorch port, twin of ``repro.launch.serve``: batched
requests against a model (reduced with ``--device cpu``, full width on the card).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --driver

Drives the continuous-batching Server either directly or as a managed job
through the port's ManagementPlane (``--driver``), mirroring the train launcher.
``--device`` (default ``cuda``) goes into the job; without a card and without
``--device cpu`` the launcher raises.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Run the launcher on ``argv`` (default: the command line). Returns
    ``{"server": Server, "done": finished requests}`` in direct mode and
    ``{"plane": ManagementPlane, "job": job id, "ok": finished}`` with
    ``--driver``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--driver", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the reduced config, plain kernels)")
    args = ap.parse_args(argv)

    from repro_torch import device as devices
    devices.resolve(args.device)           # no card and not --device cpu: raise
    reduced = args.device == "cpu"
    prompts = [[1 + (i % 7), 2, 3 + i % 5] + [4] * (i % 4)
               for i in range(args.requests)]

    if args.driver:
        from repro_torch.core.plane import ManagementPlane
        from repro_torch.runtime.local_plane import TorchLocalPlane
        plane = ManagementPlane()
        plane.add_cluster("master", is_master=True,
                          local_plane=TorchLocalPlane(device=args.device))
        plane.add_cluster("edge-0", local_plane=TorchLocalPlane(device=args.device))
        jid = plane.submit_job(
            "serve", arch=args.arch,
            payload={"arch": args.arch, "slots": args.slots,
                     "max_len": args.max_len, "reduced": reduced,
                     "device": args.device,
                     "requests": [{"prompt": p, "max_new": args.max_new}
                                  for p in prompts]})
        ok = plane.run_until_done([jid], max_ticks=500)
        print("job:", plane.job_status(jid), "ok:", ok)
        return {"plane": plane, "job": jid, "ok": ok}

    from repro_torch.runtime.serve_loop import Server, ServeJobConfig
    server = Server(ServeJobConfig(arch=args.arch, slots=args.slots,
                                   max_len=args.max_len, reduced=reduced,
                                   device=args.device))
    for p in prompts:
        server.submit(p, max_new=args.max_new)
    done = server.run()
    for r in done:
        print(f"{r.req_id}: {r.prompt} -> {r.generated}")
    print(f"{len(done)} requests in {server.steps} decode steps "
          f"(batched slots={args.slots})")
    return {"server": server, "done": done}


if __name__ == "__main__":
    main()
