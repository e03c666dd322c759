"""Keyed LRU cache of warm servers and the serve task's semantics (the serve half
of ``repro.runtime.step_cache``).

A :class:`ServerCache` keys warm servers by (arch, reduced, slots, max_len,
device); a hit calls ``Server.rebind`` (fresh requests, slots and cache; same
model and, for the same seed, the same params). ``capacity=0`` disables caching
(a fresh build per task); eviction is LRU. ``run_serve_task`` sends synthetic
prompts through the continuous-batching server and returns the same result dict
as the JAX package's.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple


class _LRU:
    """Shared LRU mechanics; subclasses define key_of/build/rebind."""

    def __init__(self, capacity: int = 4):
        self.capacity = max(int(capacity), 0)
        self._lru: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lru)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._lru)}

    def get(self, cfg):
        key = self.key_of(cfg)
        hit = self._lru.get(key)
        if hit is not None:
            self.hits += 1
            self._lru.move_to_end(key)
            self.rebind(hit, cfg)
            return hit
        self.misses += 1
        obj = self.build(cfg)
        if self.capacity:
            self._lru[key] = obj
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
                self.evictions += 1
        return obj


class ServerCache(_LRU):
    @staticmethod
    def key_of(cfg) -> Tuple:
        return ("serve", cfg.arch, cfg.reduced, cfg.slots, cfg.max_len, cfg.device)

    @staticmethod
    def build(cfg):
        from repro_torch.runtime.serve_loop import Server
        return Server(cfg)

    @staticmethod
    def rebind(server, cfg) -> None:
        server.rebind(cfg)


def run_serve_task(cache: Optional[ServerCache], payload: dict) -> dict:
    """Serve ``n_requests`` synthetic prompts of ``prompt_len`` tokens, ``max_new``
    new tokens each. The payload's ``device`` (default "cuda") picks the card or,
    with "cpu", the plain PyTorch path."""
    from repro_torch.runtime.serve_loop import ServeJobConfig
    cfg = ServeJobConfig.from_job({"payload": dict(payload)})
    # `is None`, not truthiness: an EMPTY cache is falsy (len 0) but must
    # still be used, or the first task of every family would build cold
    srv = (ServerCache(0) if cache is None else cache).get(cfg)
    n = int(payload.get("n_requests", cfg.slots))
    max_new = int(payload.get("max_new", 8))
    prompt_len = max(int(payload.get("prompt_len", 4)), 1)
    vocab = srv.arch_cfg.vocab_size
    for i in range(n):
        srv.submit([(i + j) % vocab for j in range(prompt_len)], max_new=max_new)
    done = srv.run()
    return {"requests": len(done),
            "generated_tokens": sum(len(r.generated) for r in done),
            "decode_steps": srv.steps}
