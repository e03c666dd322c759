"""Copy of ``repro.pipelines.services`` under ``repro_torch``.

Service plumbing for pipeline components over the hybrid platform.

``ServiceEndpoint`` registers a handler at the service's real address on its
host cluster (where Algorithm 2 forwards ingress traffic); ``ServiceClient``
is how a *pod* (worker/scheduler) dials a service BY NAME: it resolves the
local DNS entry (Algorithm 1) and sends on the fabric — the route tables,
channels and ACLs (Algorithms 2-4) do the rest. Pods never know where a
service actually lives; that is the paper's seamless-partitioning claim.

Requests ride ``Envelope`` payloads: a batched request (``push_many`` /
``upsert_many`` carrying a whole frontier or commit batch) crosses several
fabric hops between a private worker and the master-hosted services, and the
envelope caches its byte size so the ledger walks the batch once, not once
per hop.

Clients work for ELASTIC pods too: a worker pod added at runtime (composer
``add_worker`` / autoscaler spawn) dials services the moment the AppSpec
re-broadcast lands — DNS and ACLs are per-spec state rebuilt by Algorithm 5,
not per-process state — and a pod removed from the spec is denied again at
the next call (default-deny ACL rebuild), which is what the drained-worker
tests assert.

Retry discipline (the multi-master robustness pass): the simulation is
synchronous, so retrying *within* a call is useless — the same instant gives
the same answer. Instead the client keeps a per-service **backoff window**
across calls: after a ``DeliveryError`` the service is marked down until a
deterministic (pod-seeded, sim-clock) exponential-backoff deadline, and calls
inside the window fail fast (``stats["fast_fails"]``) without touching the
fabric. Each real attempt past the first counts in ``stats["retries"]``; a
streak reaching ``MAX_ATTEMPTS`` counts one ``stats["gave_up"]`` (the
caller's cue to surface a task failure rather than spin), then the cycle
restarts at the capped delay. A success clears the window
(``stats["recovered"]``). ``reset_backoff()`` drops every window — recovery
barriers call it so a post-restart resync is never skipped by a stale
window.
"""
from __future__ import annotations

import random
import zlib
from collections import Counter
from typing import Callable, Dict, Tuple

from repro_torch.core import gateways as GW
from repro_torch.core.service_graph import AppSpec
from repro_torch.core.transport import DeliveryError, Envelope, Fabric


class ServiceEndpoint:
    def __init__(self, fabric: Fabric, spec: AppSpec, state: GW.GatewayState,
                 name: str, handler: Callable[[dict], dict]):
        svc = spec.service(name)
        if spec.host_cluster(name) != state.cluster:
            raise ValueError(f"{name} is not hosted on {state.cluster}")
        rank = GW.service_rank(spec, name)
        self.addr = (state.service_ip(rank), svc.port)
        fabric.register_handler(state.cluster, self.addr, handler)


class ServiceClient:
    MAX_ATTEMPTS = 5
    BACKOFF_BASE = 1.0                       # sim-seconds, ~one tick
    BACKOFF_CAP = 8.0

    def __init__(self, fabric: Fabric, state: GW.GatewayState, pod: str):
        self.fabric = fabric
        self.state = state
        self.pod = pod
        self.stats: Counter = Counter()
        # service -> (retry_at, consecutive-failure streak)
        self._down: Dict[str, Tuple[float, int]] = {}
        self._rng = random.Random(zlib.crc32(pod.encode()))

    def reset_backoff(self) -> None:
        self._down.clear()

    def call(self, service: str, msg: dict) -> dict:
        if service not in self.state.dns:
            raise DeliveryError(f"no DNS entry for {service} in "
                                f"{self.state.cluster}")
        down = self._down.get(service)
        now = self.fabric.clock
        if down is not None and now < down[0]:
            self.stats["fast_fails"] += 1
            raise DeliveryError(
                f"{service} backing off until t={down[0]:.2f} "
                f"(streak {down[1]})")
        addr = self.state.dns[service]
        if not isinstance(msg, Envelope):
            msg = Envelope(msg)              # size once, reuse across hops
        try:
            resp = self.fabric.send(self.state.cluster, self.pod,
                                    self.state.cluster, addr, msg)
        except DeliveryError:
            streak = (down[1] if down is not None else 0) + 1
            if streak > 1:
                self.stats["retries"] += 1
            if streak >= self.MAX_ATTEMPTS:
                self.stats["gave_up"] += 1
                streak = 0                   # restart the cycle at cap delay
                delay = self.BACKOFF_CAP
            else:
                delay = min(self.BACKOFF_BASE * (2 ** (streak - 1)),
                            self.BACKOFF_CAP)
            delay *= 0.5 + 0.5 * self._rng.random()
            self._down[service] = (now + delay, streak)
            raise
        if down is not None:
            del self._down[service]
            self.stats["recovered"] += 1
        return resp
