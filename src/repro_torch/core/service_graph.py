"""Copy of ``repro.core.service_graph`` under ``repro_torch``.

Pod-Service dependency model (paper §4): f : P x S -> {0, 1}, host_cluster[s].

The CRD the user uploads (paper: a Kubernetes CRD broadcast to every control agent)
is an ``AppSpec``: services with stable ports, pods with the services they must
reach, and a partition map pods -> cluster. Validation enforces the paper's
partitioning restriction: all pods backing a service land in one partition, i.e.
``host_cluster[s]`` is unique.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Service:
    name: str
    port: int
    backing_pods: Tuple[str, ...]          # pods that BACK (serve) this service


@dataclasses.dataclass(frozen=True)
class Pod:
    name: str
    needs: Tuple[str, ...]                 # services this pod must reach: f[p,s]=1


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """The CRD object: the full Pod-Service dependency graph + partitioning."""
    services: Tuple[Service, ...]
    pods: Tuple[Pod, ...]
    partition: Dict[str, str]              # pod name -> cluster name

    # ------------------------------------------------------------------ validation
    def validate(self, clusters: List[str]) -> None:
        pod_names = {p.name for p in self.pods}
        svc_names = {s.name for s in self.services}
        if len(pod_names) != len(self.pods):
            raise ValueError("duplicate pod names")
        if len(svc_names) != len(self.services):
            raise ValueError("duplicate service names")
        for p in self.pods:
            for s in p.needs:
                if s not in svc_names:
                    raise ValueError(f"pod {p.name} needs unknown service {s}")
        for s in self.services:
            for b in s.backing_pods:
                if b not in pod_names:
                    raise ValueError(f"service {s.name} backed by unknown pod {b}")
            hosts = {self.partition[b] for b in s.backing_pods}
            if len(hosts) != 1:
                raise ValueError(
                    f"service {s.name} backed from {sorted(hosts)}; the paper "
                    "requires a unique host_cluster[s]")
        for pod, cluster in self.partition.items():
            if pod not in pod_names:
                raise ValueError(f"partition names unknown pod {pod}")
            if cluster not in clusters:
                raise ValueError(f"partition places {pod} on unknown {cluster}")
        missing = pod_names - set(self.partition)
        if missing:
            raise ValueError(f"pods without a partition: {sorted(missing)}")

    # --------------------------------------------------------------------- queries
    def f(self, pod: str, service: str) -> bool:
        for p in self.pods:
            if p.name == pod:
                return service in p.needs
        return False

    def host_cluster(self, service: str) -> str:
        s = self.service(service)
        return self.partition[s.backing_pods[0]]

    def service(self, name: str) -> Service:
        for s in self.services:
            if s.name == name:
                return s
        raise KeyError(name)

    def pods_of_cluster(self, cluster: str) -> List[Pod]:
        return [p for p in self.pods if self.partition[p.name] == cluster]

    def pods_needing(self, service: str) -> List[str]:
        """P(s) — pods with f[p, s] = 1."""
        return [p.name for p in self.pods if service in p.needs]

    def external_consumers(self, service: str) -> FrozenSet[str]:
        """Clusters (other than the host) containing pods that need the service."""
        host = self.host_cluster(service)
        return frozenset(self.partition[p] for p in self.pods_needing(service)
                         if self.partition[p] != host)
