"""Continuous-batching serving on the PyTorch port, twin of
``examples/serve_batched.py``: mixed prompt/generation lengths share decode
slots; results are identical to unbatched greedy decoding. On the card (the
default) qwen3-0.6b at full width; ``device="cpu"`` the reduced config.

  PYTHONPATH=src python examples/torch_serve_batched.py          # needs a card
  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse

from repro_torch.runtime.serve_loop import Server, ServeJobConfig


def main(device: str = "cuda") -> list:
    """Serve the six prompts; returns the finished requests."""
    server = Server(ServeJobConfig(arch="qwen3-0.6b", slots=3, max_len=96,
                                   reduced=device == "cpu", device=device))
    prompts = [([1, 2, 3, 4, 5], 12), ([9, 8], 4), ([7, 7, 7], 8),
               ([2, 4, 6], 6), ([5], 10), ([3, 1, 4, 1, 5], 5)]
    for p, n in prompts:
        server.submit(p, max_new=n)
    done = server.run()
    total_new = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests / {total_new} tokens in "
          f"{server.steps} batched decode steps "
          f"(vs {total_new} unbatched steps)")
    for r in done:
        print(f"  {r.req_id}: {r.prompt} -> {r.generated}")
    assert len(done) == len(prompts)
    return done


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
