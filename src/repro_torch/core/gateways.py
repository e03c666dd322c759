"""Copy of ``repro.core.gateways`` under ``repro_torch``.

Algorithms 1-4 of the paper: DNS entries, route reservation, access control,
and cross-cluster channels — executed by each control agent against the fabric.

Port determinism: every agent allocates gateway ports for services in sorted
service-name order, so ``eport[i, s]`` / ``iport[i, s]`` are identical functions
of S in every cluster. This realizes Algorithm 5's "Estimate iport[m, s]" exactly
(the paper's agents can predict master-side ports without asking).

Topology is the paper's hub: private clusters tunnel to the master; a service
hosted on a private cluster is reached from another private cluster via a master
relay port (an extension of Algorithm 4's two cases, flagged in DESIGN.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.service_graph import AppSpec
from repro_torch.core.transport import AclTable, Address, Fabric

EPORT_BASE = 20_000      # egress gateway ports
IPORT_BASE = 30_000      # ingress gateway ports
RPORT_BASE = 40_000      # master relay ports (hub extension)
SVC_IP_BASE = 1          # 10.<idx>.1.<k> real service IPs
DUMMY_IP_BASE = 1        # 10.<idx>.2.<k> dummy DNS IPs


@dataclasses.dataclass
class GatewayState:
    """Per-cluster gateway + DNS + port tables (one per control agent)."""
    cluster: str
    idx: int                                   # cluster ordinal (subnet)
    dns: Dict[str, Address] = dataclasses.field(default_factory=dict)
    eport: Dict[str, int] = dataclasses.field(default_factory=dict)
    iport: Dict[str, int] = dataclasses.field(default_factory=dict)
    acl: AclTable = dataclasses.field(default_factory=AclTable)

    @property
    def igw_ip(self) -> str:
        return f"10.{self.idx}.0.10"

    @property
    def egw_ip(self) -> str:
        return f"10.{self.idx}.0.11"

    def service_ip(self, rank: int) -> str:
        return f"10.{self.idx}.1.{SVC_IP_BASE + rank}"

    def dummy_ip(self, rank: int) -> str:
        return f"10.{self.idx}.2.{DUMMY_IP_BASE + rank}"


def service_rank(spec: AppSpec, name: str) -> int:
    return sorted(s.name for s in spec.services).index(name)


# ------------------------------------------------------------------- Algorithm 1
def add_dns_entry(state: GatewayState, spec: AppSpec, s: str) -> None:
    """DNS for service s in this cluster: real IP if native, dummy IP otherwise."""
    svc = spec.service(s)
    rank = service_rank(spec, s)
    if spec.host_cluster(s) != state.cluster:
        state.dns[s] = (state.dummy_ip(rank), svc.port)
    else:
        state.dns[s] = (state.service_ip(rank), svc.port)


# ------------------------------------------------------------------- Algorithm 2
def reserve_route(fabric: Fabric, state: GatewayState, spec: AppSpec,
                  s: str) -> None:
    """External: dialed dummy addr forwards to egw[i]:eport. Native: igw[i]:iport
    forwards to the service pods."""
    svc = spec.service(s)
    rank = service_rank(spec, s)
    if spec.host_cluster(s) != state.cluster:
        eport = EPORT_BASE + rank
        state.eport[s] = eport
        fabric.add_forward(state.cluster, state.dns[s],
                           (state.egw_ip, eport))
    else:
        iport = IPORT_BASE + rank
        state.iport[s] = iport
        fabric.add_forward(state.cluster, (state.igw_ip, iport),
                           (state.service_ip(rank), svc.port))


# ------------------------------------------------------------------- Algorithm 3
def set_access_control(state: GatewayState, spec: AppSpec, s: str) -> None:
    """Default-deny; allow only pods with f[p, s] = 1, plus the gateway hop when
    the service is consumed from external clusters."""
    svc = spec.service(s)
    rank = service_rank(spec, s)
    external = spec.host_cluster(s) != state.cluster
    dialed = state.dns[s]
    state.acl.block_all(dialed)
    if external:
        # the egress-gateway hop is an allowed address too: clear it as well,
        # so a re-broadcast (elastic pod churn) is a true default-deny
        # rebuild — a removed pod loses BOTH its dialed and egress entries,
        # and the table never accretes stale tuples
        state.acl.block_all((state.egw_ip, state.eport[s]))
    for pod in spec.pods_needing(s):
        if spec.partition[pod] != state.cluster:
            continue
        if external:
            state.acl.allow(pod, dialed)
            state.acl.allow(pod, (state.egw_ip, state.eport[s]))
        else:
            state.acl.allow(pod, dialed)
    # (gateway-originated hops are exempt in AclTable — the paper's
    #  allow-access(igw -> service) rule.)


# ------------------------------------------------------------------- Algorithm 4
def create_channels(fabric: Fabric, state: GatewayState, spec: AppSpec, s: str,
                    master: str, master_state: GatewayState) -> None:
    """Interconnect this (non-master) cluster with the master for service s.

    h == master : local-forward channel  egw[i]:eport  ->  igw[m]:iport[m,s]
    h == i      : remote-forward channel egw[m]:eport[m,s] -> igw[i]:iport[i,s]
    h elsewhere : consumer side tunnels to a master relay port which forwards to
                  the master's own egress entry for s (hub transit, extension).
    """
    h = spec.host_cluster(s)
    rank = service_rank(spec, s)
    i = state.cluster
    # Idempotent under re-configuration: an AppSpec re-broadcast (elastic
    # fleets add/remove pods at runtime) re-runs this algorithm on every
    # agent; a tunnel that already terminates at the endpoint is kept —
    # including a deliberately killed one, so fault injection survives
    # reconfiguration — instead of stacking a duplicate channel.
    if h == master and s in state.eport:
        if fabric.channel_at(i, (state.egw_ip, state.eport[s])) is None:
            fabric.create_channel(
                i, (state.egw_ip, state.eport[s]),
                master, (master_state.igw_ip, IPORT_BASE + rank))
    elif h == i and spec.external_consumers(s):
        if fabric.channel_at(master,
                             (master_state.egw_ip, EPORT_BASE + rank)) is None:
            fabric.create_channel(
                master, (master_state.egw_ip, EPORT_BASE + rank),
                i, (state.igw_ip, state.iport[s]))
    elif h not in (master, i) and s in state.eport:
        relay = RPORT_BASE + rank
        fabric.add_forward(master, (master_state.igw_ip, relay),
                           (master_state.egw_ip, EPORT_BASE + rank))
        if fabric.channel_at(i, (state.egw_ip, state.eport[s])) is None:
            fabric.create_channel(i, (state.egw_ip, state.eport[s]),
                                  master, (master_state.igw_ip, relay))


def install_acl(fabric: Fabric, state: GatewayState) -> None:
    fabric.set_acl(state.cluster, state.acl)
