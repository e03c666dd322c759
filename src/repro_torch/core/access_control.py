"""Copy of ``repro.core.access_control`` under ``repro_torch``.

Access-control layer (Algorithm 3 support).

The enforcement point is ``transport.AclTable`` (checked by the fabric at send
time, default-deny). This module adds the policy-level helpers used by tests and
the plane: compute the exact allowed flow set implied by an AppSpec, and audit a
cluster's installed table against it.
"""
from __future__ import annotations

from typing import List, Set, Tuple

from repro_torch.core import gateways as GW
from repro_torch.core.service_graph import AppSpec
from repro_torch.core.transport import AclTable  # noqa: F401  (re-export)


def expected_flows(spec: AppSpec, state: "GW.GatewayState") -> Set[tuple]:
    """The set of (pod, dialed_addr) pairs Algorithm 3 must allow in a cluster."""
    out = set()
    for s in sorted(x.name for x in spec.services):
        svc = spec.service(s)
        rank = GW.service_rank(spec, s)
        external = spec.host_cluster(s) != state.cluster
        dialed = ((state.dummy_ip(rank), svc.port) if external
                  else (state.service_ip(rank), svc.port))
        for pod in spec.pods_needing(s):
            if spec.partition[pod] == state.cluster:
                out.add((pod, dialed))
                if external:
                    out.add((pod, (state.egw_ip, GW.EPORT_BASE + rank)))
    return out


def audit(spec: AppSpec, state: "GW.GatewayState") -> List[str]:
    """Violations between the installed ACL and the spec-implied flow set."""
    want = expected_flows(spec, state)
    have = state.acl.entries()
    missing = want - have
    extra = have - want
    problems = [f"missing allow: {m}" for m in sorted(missing)]
    problems += [f"unexpected allow: {e}" for e in sorted(extra)]
    return problems
