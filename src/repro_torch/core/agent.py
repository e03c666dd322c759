"""Copy of ``repro.core.agent`` under ``repro_torch``.

Control agent (paper §2.v + Algorithm 5): one per cluster/pod.

Responsibilities, mapped 1:1 from the paper:
  * configuration — run Algorithm 5 over a received AppSpec CRD: DNS entries,
    route reservation, access control for every service, then channels to the
    master (non-master clusters only);
  * job lifecycle — accept dispatched jobs, submit to the local control plane,
    track execution;
  * health/telemetry — lease-backed registration in the overwatch plus periodic
    heartbeats carrying load, job progress and step-rate telemetry.
  * replica hosting (the fan-out overhaul) — with ``enable_replica()`` the
    agent hosts a cluster-local ``LocalReplica`` fed by the master's shipped
    ``replica_batch`` envelopes; its overwatch client then serves
    ``range_stale`` reads (``fleet_telemetry``/``queue_depths`` below, worker
    depth gates, any telemetry consumer on this cluster) from local state —
    zero cross-boundary bytes per read while the ships keep it within bound.
  * cluster-local read service (the watch-plane overhaul) — the replica is
    also exposed as a service endpoint on ``REPLICA_PORT`` (``range_stale``
    + ``watch``/``watch_batch``) so worker pods, depth views, and autoscale
    observers on this cluster subscribe HERE instead of dialing the master:
    every watcher is fed from the one shipped envelope per sweep
    (``LocalReplica.watch``), so N watchers cost the cross-boundary bytes of
    zero. ``watch_local``/``local_view`` are the in-process fast path to the
    same plane; reads past the staleness bound transparently fall back to
    the primary (counted in ``fabric.stats["fallback_reads"]``).

The agent is an ordinary fabric endpoint: everything it says to the master-hosted
overwatch crosses the thin boundary and is byte-accounted. A partitioned cluster
stops heartbeating, its lease expires, and the dispatcher's failure detector sees
the tombstone — no extra machinery.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core import gateways as GW
from repro_torch.core.overwatch import OverwatchClient
from repro_torch.core.service_graph import AppSpec
from repro_torch.core.transport import Address, DeliveryError, Envelope, Fabric
from repro_torch.observability.metrics import MetricsRegistry

AGENT_PORT = 6000
REPLICA_PORT = 6001           # the cluster-local read service (replica-fed)
AGENT_IP_SUFFIX = "0.20"
OW_TUNNEL_RANK = 9_999        # reserved gateway rank for the overwatch tunnel


@dataclasses.dataclass
class JobRecord:
    job: dict
    status: str = "accepted"     # accepted | running | done | failed
    progress: float = 0.0
    rate: float = 0.0


class ControlAgent:
    def __init__(self, fabric: Fabric, cluster: str, idx: int, master: str,
                 local_plane, heartbeat_interval: float = 1.0,
                 lease_ttl: float = 3.5, ow_shards: int = 1):
        self.fabric = fabric
        self.cluster = cluster
        self.idx = idx
        self.master = master
        self.local_plane = local_plane
        self.heartbeat_interval = heartbeat_interval
        self.lease_ttl = lease_ttl
        self.ow_shards = max(1, ow_shards)
        self.state = GW.GatewayState(cluster=cluster, idx=idx)
        self.spec: Optional[AppSpec] = None
        self.jobs: Dict[str, JobRecord] = {}
        self.lease: Optional[int] = None
        self.missed_heartbeats = 0
        self.agent_id = f"agent@{cluster}"
        self.addr: Address = (f"10.{idx}.{AGENT_IP_SUFFIX}", AGENT_PORT)
        fabric.register_handler(cluster, self.addr, self._handle)
        self.ow: Optional[OverwatchClient] = None
        self.replica = None                  # LocalReplica (fan-out mode)
        self.replica_addr: Optional[Address] = None   # read-service endpoint
        self._views: Dict[str, Any] = {}     # prefix -> cached ReplicaView
        # flight recorder: every agent owns its cluster's metrics registry
        # (components hosted here register sources on it); publication into
        # /metrics/<cluster>/ is OPT-IN via ``metrics_every`` — None keeps
        # the heartbeat byte-identical to the unmetered plane
        self.metrics = MetricsRegistry(cluster)
        self.metrics_every: Optional[float] = None
        self._metrics_published_at: Optional[float] = None
        self._published_metrics: Dict[str, dict] = {}
        # plane-shared tracer (set by ManagementPlane when tracing is on):
        # dispatch handling opens an "accept" span under the riding context
        self.tracer = None
        # telemetry envelope size is shape-constant (fixed keys, numeric
        # values): computed on the first heartbeat, reused forever after so
        # the fabric's byte accounting never re-walks the hottest message
        self._telemetry_nbytes: Optional[int] = None

    # -------------------------------------------------------------- bootstrapping
    def bootstrap(self, master_state: GW.GatewayState) -> None:
        """Initialization phase (paper §4.1): install the overwatch tunnel(s).

        Master-cluster agents talk to the overwatch directly; private agents
        get one bootstrap channel egw[i] -> igw[m] that forwards to the
        overwatch front-end. With a sharded overwatch, one additional tunnel
        per shard (ranks just below ``OW_TUNNEL_RANK``) lets the client route
        key ops straight to the owning shard's endpoint; the base tunnel keeps
        carrying lease traffic and fan-out ranges.
        """
        from repro_torch.core.overwatch import OVERWATCH_IP, OVERWATCH_PORT
        n = self.ow_shards
        if self.cluster == self.master:
            shard_addrs = ([(OVERWATCH_IP, OVERWATCH_PORT + 1 + i)
                            for i in range(n)] if n > 1 else None)
            self.ow = OverwatchClient(self.fabric, self.cluster, self.agent_id,
                                      self.master, shard_addrs=shard_addrs,
                                      replica=self.replica)
            return
        eport = GW.EPORT_BASE + OW_TUNNEL_RANK
        iport = GW.IPORT_BASE + OW_TUNNEL_RANK
        self.fabric.add_forward(self.master, (master_state.igw_ip, iport),
                                (OVERWATCH_IP, OVERWATCH_PORT))
        self.fabric.create_channel(self.cluster, (self.state.egw_ip, eport),
                                   self.master, (master_state.igw_ip, iport))
        shard_vias = None
        if n > 1:
            shard_vias = []
            for i in range(n):
                rank = OW_TUNNEL_RANK - 1 - i
                s_eport = GW.EPORT_BASE + rank
                s_iport = GW.IPORT_BASE + rank
                self.fabric.add_forward(
                    self.master, (master_state.igw_ip, s_iport),
                    (OVERWATCH_IP, OVERWATCH_PORT + 1 + i))
                self.fabric.create_channel(
                    self.cluster, (self.state.egw_ip, s_eport),
                    self.master, (master_state.igw_ip, s_iport))
                shard_vias.append((self.state.egw_ip, s_eport))
        self.ow = OverwatchClient(self.fabric, self.cluster, self.agent_id,
                                  self.master, via=(self.state.egw_ip, eport),
                                  shard_vias=shard_vias,
                                  replica=self.replica)

    def enable_replica(self, prefixes=None):
        """Host a cluster-local overwatch replica (fan-out mode): shipped
        ``replica_batch`` deltas land here, and this agent's overwatch client
        serves in-bound ``range_stale`` reads from it without touching the
        fabric. Also registers the cluster-local read service on
        ``REPLICA_PORT`` so local pods consume the replica (reads + watches)
        as an ordinary service endpoint. Returns the replica (the shipper
        registers it master-side)."""
        from repro_torch.core.replica import REPLICA_PREFIXES, LocalReplica
        self.replica = LocalReplica(prefixes or REPLICA_PREFIXES)
        self.metrics.register_source(
            "replica", lambda: dict(self.replica.stats))
        if self.ow is not None:
            self.ow.replica = self.replica
        self.replica_addr = (self.addr[0], REPLICA_PORT)
        self.fabric.register_handler(self.cluster, self.replica_addr,
                                     self._handle_replica_service)
        return self.replica

    # ------------------------------------------------- cluster-local read service
    def _handle_replica_service(self, msg: dict) -> dict:
        """The replica as a service endpoint for pods on THIS cluster: a
        ``range_stale`` answered from local state (primary fallback past the
        staleness bound, exactly like the in-process client path), and watch
        registration onto the replica-fed notify plane. Watch callbacks are
        in-process references — the simulated fabric's stand-in for a
        streaming subscription; what the byte ledger sees is the honest
        part: registering and feeding N watchers costs zero cross-boundary
        traffic."""
        op = msg.get("op")
        if op == "range_stale":
            items = self.ow.range_stale(msg["prefix"],
                                        msg.get("max_lag", 2.0))
            return {"ok": True, "items": items}
        if op in ("watch", "watch_batch"):
            try:
                self.watch_local(msg["prefix"], msg["cb"],
                                 batch=(op == "watch_batch"))
            except (RuntimeError, ValueError) as e:
                return {"ok": False, "error": str(e)}
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op}"}

    def watch_local(self, prefix: str, cb, batch: bool = False):
        """Subscribe to shipped deltas under ``prefix`` on this cluster's
        replica — the notify half of the local read service. Revision-ordered
        and coalesced exactly like the primary's watch buckets, fed from the
        one envelope per sweep: no per-watcher cross-boundary traffic."""
        if self.replica is None:
            raise RuntimeError(
                f"cluster {self.cluster} hosts no replica (fan-out off)")
        if batch:
            return self.replica.watch_batch(prefix, cb)
        return self.replica.watch(prefix, cb)

    def local_view(self, prefix: str):
        """A cached watch-materialized ``ReplicaView`` over ``prefix`` — the
        cluster-local twin of the dispatcher's master-side views (worker
        depth gates, fleet-state observers)."""
        if self.replica is None:
            raise RuntimeError(
                f"cluster {self.cluster} hosts no replica (fan-out off)")
        view = self._views.get(prefix)
        if view is None:
            from repro_torch.core.replica import ReplicaView
            view = self._views[prefix] = ReplicaView(self.replica, prefix)
        return view

    def register(self) -> None:
        """Lease-backed registration (overwatch = discovery + failure detection)."""
        self.lease = self.ow.lease_grant(self.lease_ttl)
        self.ow.put(f"/clusters/{self.cluster}", {
            "idx": self.idx,
            "capabilities": self.local_plane.capabilities(),
            "agent_addr": list(self.addr),
        }, lease=self.lease)
        self._schedule_heartbeat()

    # ------------------------------------------------------------- Algorithm 5
    def configure_partition(self, spec: AppSpec,
                            master_state: GW.GatewayState) -> None:
        self.spec = spec
        svc_names = sorted(s.name for s in spec.services)
        for s in svc_names:
            GW.add_dns_entry(self.state, spec, s)
            GW.reserve_route(self.fabric, self.state, spec, s)
            GW.set_access_control(self.state, spec, s)
        if self.replica_addr is not None:
            # the cluster-local read service is default-deny like any other
            # service: rebuilt from scratch on every (re-)broadcast so only
            # the pods CURRENTLY partitioned onto this cluster may dial it
            self.state.acl.block_all(self.replica_addr)
            for pod, cl in spec.partition.items():
                if cl == self.cluster:
                    self.state.acl.allow(pod, self.replica_addr)
        GW.install_acl(self.fabric, self.state)
        if self.cluster != self.master:
            for s in svc_names:
                # iport[m, s] is estimated deterministically (sorted-rank ports)
                GW.create_channels(self.fabric, self.state, spec, s,
                                   self.master, master_state)

    # ------------------------------------------------------------- job lifecycle
    def _handle(self, msg: dict) -> dict:
        kind = msg.get("kind")
        if kind == "configure":
            self.configure_partition(msg["spec"], msg["master_state"])
            return {"ok": True}
        if kind == "dispatch":
            tr = self.tracer
            ctx = (self.fabric.current_trace() or msg.get("trace")) \
                if tr is not None else None
            if ctx is None:
                return self.accept_job(msg["job"])
            # the context rode the dispatch envelope across the relay hops;
            # the accept span records the remote-cluster half of submission
            t0 = tr.clock()
            try:
                resp = self.accept_job(msg["job"])
            except BaseException:
                tr.span_complete(ctx, "accept", "agent", t0, "failed",
                                 {"cluster": self.cluster})
                raise
            tr.span_complete(ctx, "accept", "agent", t0,
                             "ok" if resp.get("ok") else "failed",
                             {"cluster": self.cluster})
            return resp
        if kind == "cancel":
            return self.cancel_job(msg["job_id"])
        if kind == "retire":
            return self.retire_job(msg["job_id"])
        if kind == "drain":
            for jid in list(self.jobs):
                self.cancel_job(jid)
            return {"ok": True}
        if kind == "replica_batch":
            if self.replica is None:
                return {"ok": False, "error": "no replica hosted here"}
            applied = self.replica.apply_ship(msg["batch"])
            return {"ok": True, "applied_rev": applied}
        if kind == "replica_rev":
            # the recovering master's resume probe: how far this cluster's
            # replica had applied before the crash, so the rebuilt shipper can
            # resume the feed from that horizon instead of re-seeding
            rev = self.replica.applied_rev if self.replica is not None else 0
            return {"ok": True, "rev": rev}
        return {"ok": False, "error": f"unknown message {kind}"}

    def accept_job(self, job: dict) -> dict:
        """Job acceptance -> submission to the local control plane."""
        jid = job["job_id"]
        caps = set(self.local_plane.capabilities())
        needs = set(job.get("tags", {}).get("requires", ()))
        if not needs.issubset(caps):
            return {"ok": False, "error": f"missing capabilities {needs - caps}"}
        rec = JobRecord(job=job)
        self.jobs[jid] = rec
        try:
            self.local_plane.submit(job)
            rec.status = "running"
        except Exception as e:               # noqa: BLE001
            rec.status = "failed"
            return {"ok": False, "error": str(e)}
        self._report_job(jid)
        return {"ok": True}

    def cancel_job(self, job_id: str) -> dict:
        if job_id in self.jobs:
            self.local_plane.cancel(job_id)
            self.jobs[job_id].status = "failed"
        return {"ok": True}

    def retire_job(self, job_id: str) -> dict:
        """Graceful retirement (autoscaler scale-down): stop the job on the
        local plane and FORGET it — no failure recorded, no more heartbeat
        telemetry for it. The dispatcher tombstones the job's overwatch
        records in the same breath, so nothing anywhere still believes the
        pod exists."""
        rec = self.jobs.pop(job_id, None)
        if rec is not None:
            self.local_plane.cancel(job_id)
            rec.status = "done"
        return {"ok": True}

    # ------------------------------------------------------- heartbeat/telemetry
    def _schedule_heartbeat(self) -> None:
        self.fabric.call_later(self.heartbeat_interval, self.heartbeat)

    def heartbeat(self) -> None:
        try:
            self.ow.lease_keepalive(self.lease)
            # advance + track local jobs, then push telemetry
            for jid, rec in self.jobs.items():
                if rec.status != "running":
                    continue
                st = self.local_plane.poll(jid)
                rec.progress, rec.rate = st["progress"], st.get("rate", 0.0)
                if st["status"] in ("done", "failed"):
                    rec.status = st["status"]
                self._report_job(jid)
            req = Envelope({
                "op": "put", "key": f"/telemetry/{self.cluster}",
                "value": {
                    "clock": self.fabric.clock,
                    "load": self.local_plane.load(),
                    "running": sum(1 for r in self.jobs.values()
                                   if r.status == "running"),
                }, "lease": None,
            }, nbytes=self._telemetry_nbytes)
            self.ow.request(req)
            self._telemetry_nbytes = req.nbytes
            self.publish_metrics()
            self.missed_heartbeats = 0
        except (DeliveryError, RuntimeError):
            self.missed_heartbeats += 1
        self._schedule_heartbeat()

    def publish_metrics(self) -> None:
        """Export this cluster's metrics registry into the overwatch under
        ``/metrics/<cluster>/<section>`` — one put per CHANGED section, at
        most every ``metrics_every`` clock units (no-op when unset). The keys
        join the replica delta feed ("/metrics/" is a replicated prefix), so
        a fleet-wide scrape is a ``range_stale("/metrics/")`` against any
        replica: zero cross-boundary bytes per read. The publish itself rides
        this agent's existing overwatch tunnel and is priced like any put.
        The last-published cache updates only after a put LANDS — a
        partition-eaten publish retries on the next cadence."""
        if self.metrics_every is None or self.ow is None:
            return
        now = self.fabric.clock
        if (self._metrics_published_at is not None
                and now - self._metrics_published_at < self.metrics_every):
            return
        self._metrics_published_at = now
        for section, values in sorted(self.metrics.sections().items()):
            if self._published_metrics.get(section) == values:
                continue                     # unchanged: nothing to ship
            self.ow.put(f"/metrics/{self.cluster}/{section}", values)
            self._published_metrics[section] = values

    # ------------------------------------------------------ local-path reads
    def fleet_telemetry(self, max_lag: float = 2.0) -> Dict[str, dict]:
        """Every cluster's last telemetry row — served from the local replica
        when fan-out keeps it within ``max_lag``, primary round-trip
        otherwise (the remote telemetry probe of the locality benchmark)."""
        items = self.ow.range_stale("/telemetry/", max_lag=max_lag)
        return {k[len("/telemetry/"):]: v for k, v in items.items()}

    def queue_depths(self, max_lag: float = 2.0) -> Dict[str, dict]:
        """Published ``/queues/<name>`` depth view — the worker-side depth
        check, local under fan-out like ``fleet_telemetry``."""
        items = self.ow.range_stale("/queues/", max_lag=max_lag)
        return {k[len("/queues/"):]: v for k, v in items.items()}

    def fleet_states(self, max_lag: float = 2.0) -> Dict[str, dict]:
        """Published ``/autoscale/<family>`` fleet state — the remote
        autoscale observer's read surface, local under fan-out; pair with
        ``watch_local("/autoscale/", cb)`` for the notify side."""
        items = self.ow.range_stale("/autoscale/", max_lag=max_lag)
        return {k[len("/autoscale/"):]: v for k, v in items.items()}

    def _report_job(self, jid: str) -> None:
        rec = self.jobs[jid]
        self.ow.put(f"/jobs/{jid}/status", {
            "cluster": self.cluster, "status": rec.status,
            "progress": rec.progress, "rate": rec.rate,
            "clock": self.fabric.clock,
        })
