"""Whether two processes can share one card as a (data=1, model=2) mesh: for each of
NCCL and gloo, two spawned ranks, both on cuda:0, try an all-reduce, an all-gather
and one step of a reduced qwen3-0.6b Trainer on the (1, 2) ``DeviceMesh`` (the
tensor-parallel route), and report what ran and the first error.

    python3 tools/two_ranks_one_card.py [--timeout 120]

Needs a card (exits 1 without one). Each backend's ranks are killed after
``--timeout`` seconds; a hung backend is reported as such. Prints one JSON line
per backend and exits 0.
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def _rank(rank: int, world: int, backend: str, tmp: str, timeout: float) -> None:
    import torch.distributed as dist
    out = {"rank": rank, "backend": backend}

    def step(name, fn):
        t0 = time.perf_counter()
        try:
            value = fn()
            out[name] = {"ok": True, "s": round(time.perf_counter() - t0, 3), "value": value}
            return True
        except Exception as e:          # a report: the first error of each stage
            out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:400],
                         "where": traceback.format_exc(limit=3)[-400:]}
            return False

    def dump():
        with open(Path(tmp) / f"{backend}{rank}.json", "w") as f:
            json.dump(out, f)

    torch.cuda.set_device(0)
    ok = step("init", lambda: dist.init_process_group(
        backend, init_method=f"file://{tmp}/{backend}_store", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout)) or "joined")
    dump()

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return x.tolist()

    def all_gather():
        x = torch.full((2,), float(rank), device="cuda")
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        torch.cuda.synchronize()
        return torch.cat(parts).tolist()

    def train():
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.runtime.train_loop import Trainer, TrainJobConfig
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        tr = Trainer(TrainJobConfig(arch="qwen3-0.6b", seq_len=64, global_batch=8), mesh=mesh)
        return tr.step_once()["loss"]

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather), ("train", train)):
        if not ok:
            break
        ok = step(name, fn)
        dump()
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("two_ranks_one_card: no card", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.start_processes(_rank, args=(2, backend, tmp, args.timeout), nprocs=2,
                                     join=False, start_method="spawn")
            deadline = time.monotonic() + args.timeout + 30
            hung = False
            try:
                while not ctx.join(timeout=5):
                    if time.monotonic() > deadline:
                        hung = True
                        break
            except Exception as e:         # a rank died: report what it wrote
                print(f"{backend}: a rank exited: {type(e).__name__}: {str(e)[:200]}")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
            ranks = []
            for rank in range(2):
                path = Path(tmp) / f"{backend}{rank}.json"
                ranks.append(json.loads(path.read_text()) if path.exists() else None)
            print(json.dumps({"backend": backend, "hung": hung, "ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
