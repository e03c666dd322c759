"""Copy of ``repro.core.plane`` under ``repro_torch``.

ManagementPlane — the single pane of glass (paper §2).

One object through which users do everything: register clusters, upload the
application CRD, submit jobs, read statuses, inject faults (tests), and read the
cross-boundary byte ledger. Internally it wires the fabric, the master cluster,
the overwatch, the dispatcher, and one control agent per cluster — users never
touch those directly, which is precisely the paper's UX claim.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from repro_torch.core.agent import ControlAgent
from repro_torch.core.dispatcher import Dispatcher, RoutingRule
from repro_torch.core.overwatch import OverwatchService
from repro_torch.core.service_graph import AppSpec
from repro_torch.core.transport import Fabric


class SimLocalPlane:
    """Deterministic local control plane for management-plane tests: jobs advance
    ``rate`` progress-units per clock tick (no model code). The runtime package
    provides the real local plane, ``TorchLocalPlane``, with the same interface."""

    def __init__(self, caps=("cpu",), rate: float = 1.0):
        self._caps = tuple(caps)
        self.rate = rate
        self.jobs: Dict[str, dict] = {}

    def capabilities(self):
        return self._caps

    def submit(self, job: dict) -> None:
        start = float(job.get("restore_from", {}).get("progress", 0.0) or 0.0)
        self.jobs[job["job_id"]] = {"job": job, "progress": start,
                                    "status": "running"}

    def cancel(self, job_id: str) -> None:
        if job_id in self.jobs:
            self.jobs[job_id]["status"] = "failed"

    def poll(self, job_id: str) -> dict:
        rec = self.jobs[job_id]
        if rec["status"] == "running":
            rec["progress"] += self.rate
            total = float(rec["job"].get("steps", 10))
            if rec["progress"] >= total:
                rec["progress"] = total
                rec["status"] = "done"
        return {"progress": rec["progress"], "status": rec["status"],
                "rate": self.rate if rec["status"] == "running" else 0.0}

    def load(self) -> float:
        return sum(1.0 for r in self.jobs.values() if r["status"] == "running")


class ManagementPlane:
    def __init__(self, master: str = "master",
                 message_log_limit: Optional[int] = 100_000,
                 op_log_limit: Optional[int] = None,
                 ow_shards: int = 1,
                 coalesce_watches: bool = False,
                 replica_fanout: bool = False,
                 replica_prefixes=None,
                 durability=None,
                 trace_sample: float = 0.0,
                 metrics_every: Optional[float] = None,
                 num_masters: int = 1):
        self.fabric = Fabric(message_log_limit=message_log_limit)
        self.master = master
        # flight recorder: trace_sample > 0 arms a plane-wide tracer shared
        # by the dispatcher, every agent, and any composer built on top
        # (sampling is per-trace-id deterministic); 0 keeps every payload
        # byte-identical. ``metrics_every`` turns on per-agent registry
        # export under /metrics/<cluster>/ at that clock cadence (None: no
        # publication — the default plane is unmetered on the wire).
        self.tracer = None
        if trace_sample > 0:
            from repro_torch.observability.trace import Tracer
            self.tracer = Tracer(clock_fn=lambda: self.fabric.clock,
                                 sample=trace_sample)
        self.metrics_every = metrics_every
        self._idx = itertools.count(1)
        self.agents: Dict[str, ControlAgent] = {}
        self.ow_shards = max(1, ow_shards)
        # durability (repro_torch.core.durability.LogStore): WAL + snapshots for the
        # global-plane services; None => byte-identical in-memory-only plane.
        # Kept public: the chaos harness reaches it to model commit-loss.
        self.durability = durability
        self._op_log_limit = op_log_limit
        self._coalesce_watches = coalesce_watches
        self._replica_fanout = replica_fanout
        self.overwatch = OverwatchService(self.fabric, master,
                                          op_log_limit=op_log_limit,
                                          num_shards=self.ow_shards,
                                          coalesce_watches=coalesce_watches,
                                          durability=durability)
        self.dispatcher = Dispatcher(self.fabric, master, self.overwatch)
        self.dispatcher.tracer = self.tracer
        # replica fan-out (off by default — behavior-identical without it):
        # every non-master cluster hosts a LocalReplica fed by one coalesced
        # delta envelope per sweep, and remote range_stale reads go local
        self.shipper = None
        self._replica_prefixes = replica_prefixes
        if replica_fanout:
            from repro_torch.core.replica import REPLICA_PREFIXES, ReplicaShipper
            self._replica_prefixes = tuple(replica_prefixes
                                           or REPLICA_PREFIXES)
            self.shipper = ReplicaShipper(self.overwatch,
                                          self.dispatcher.send_agent,
                                          prefixes=self._replica_prefixes)
            # a tombstoned cluster stops accumulating ship backlog
            self.dispatcher.on_cluster_down(self.shipper.unregister)
        self.spec: Optional[AppSpec] = None
        self._job_ids = itertools.count(1)
        # master hosts its own agent (idx 0)
        self._master_agent = None
        # multi-master split (repro_torch.core.shardmap): N crashable fault domains
        # own the overwatch/broker shards behind an epoch-fenced shard map.
        # num_masters=1 (default) builds no coordinator and stays
        # behavior-identical to the single-process seed plane.
        self.num_masters = max(1, num_masters)
        self.coordinator = None
        if self.num_masters > 1:
            self._build_coordinator()

    # --------------------------------------------------------------- multi-master
    def _build_coordinator(self, fault_injector=None) -> None:
        """(Re)build the shard-map coordinator and place every overwatch
        shard under a master fault domain: the per-shard endpoints are
        re-registered through each owner's liveness guard, and the overwatch
        arms its fence. Assignment honors the WAL-recovered map, so a
        post-crash rebuild lands every shard with the owner clients last
        flipped to. Called from ``__init__`` and ``recover_global_plane``."""
        from repro_torch.core.shardmap import ShardMapCoordinator
        prior = self.coordinator
        co = ShardMapCoordinator(
            self.fabric, self.master, self.num_masters,
            durability=self.durability, tracer=self.tracer,
            fault_injector=fault_injector or (
                prior.fault_injector if prior is not None else None))
        ow = self.overwatch
        for i, name in enumerate(ow._shard_names):
            addr = (ow.addr[0], ow.addr[1] + 1 + i)
            co.register_shard(
                name, addr,
                # index closures: a migration's shard swap re-points the
                # endpoint with no re-registration
                lambda req, _i=i: ow._dispatch(req, ow.shards[_i]),
                ops={
                    # the overwatch consults the coordinator's frozen()
                    # directly, so freeze/unfreeze carry no store-side state
                    "freeze": lambda: None,
                    "unfreeze": lambda: None,
                    "export": lambda _i=i: ow._shard_snapshot(_i),
                    "import_": lambda p, _i=i: ow.install_shard(_i, p),
                    "rebuild": lambda _i=i: ow.rebuild_shard(_i),
                },
                wal_shards=(name,))
        ow.set_fence(co)
        co.publish = lambda payload: self.overwatch.handle(
            {"op": "put", "key": "/sys/shardmap", "value": payload})
        self.coordinator = co

    def kill_master(self, name: str):
        """Crash one master fault domain (multi-master planes only): its
        endpoints die, its WAL tails are lost, and the coordinator fails its
        shards over to survivors across the next ticks."""
        return self.coordinator.kill_master(name)

    def restart_master(self, name: str) -> None:
        self.coordinator.restart_master(name)

    # ------------------------------------------------------------------- clusters
    def add_cluster(self, name: str, local_plane=None,
                    is_master: bool = False) -> ControlAgent:
        if local_plane is None:
            local_plane = SimLocalPlane()
        idx = 0 if is_master else next(self._idx)
        agent = ControlAgent(self.fabric, name, idx, self.master, local_plane,
                             ow_shards=self.ow_shards)
        agent.tracer = self.tracer
        agent.metrics_every = self.metrics_every
        self.agents[name] = agent
        if is_master:
            self._master_agent = agent
            self._register_master_metrics(agent)
        master_state = (self._master_agent.state if self._master_agent
                        else agent.state)
        agent.bootstrap(master_state)
        if self.coordinator is not None:
            # epoch fencing: the agent's overwatch client stamps writes with
            # its map epoch and refreshes off stale-epoch bounces
            agent.ow.fenced = True
        agent.register()
        if self.shipper is not None and not is_master:
            # master-cluster reads are already fabric-local; remote clusters
            # get a replica seeded by the first ship (next tick)
            agent.enable_replica(self._replica_prefixes)
            self.shipper.register(name)
        return agent

    @property
    def master_agent(self) -> ControlAgent:
        return self._master_agent

    def _register_master_metrics(self, agent: ControlAgent) -> None:
        """The master agent's registry adopts the global-plane stats dicts:
        the fabric's byte/operational ledgers (``fallback_reads`` et al. —
        the same numbers ``boundary_report`` prints), the replica shipper,
        and per-overwatch-shard op counts. Sources late-bind through
        ``self``, so ``recover_global_plane``'s rebuilt services are picked
        up without re-registration."""
        def fabric_stats():
            f = self.fabric
            out = {"cross_cluster_bytes": f.cross_cluster_bytes(),
                   "local_bytes": sum(f.local_bytes.values())}
            out.update(f.stats)
            return out

        def shipper_stats():
            return dict(self.shipper.stats) if self.shipper is not None \
                else {}

        def overwatch_stats():
            ow = self.overwatch
            out = {f"ops.{k}": v for k, v in ow.op_counts.items()}
            for i, shard in enumerate(ow.shards):
                out.update({f"s{i}.ops.{k}": v
                            for k, v in shard.op_counts.items()})
            return out

        agent.metrics.register_source("fabric", fabric_stats)
        agent.metrics.register_source("shipper", shipper_stats)
        agent.metrics.register_source("overwatch", overwatch_stats)
        if self.coordinator is not None:
            # shardmap.epoch / per-shard migrations / frozen_ticks /
            # stale_epoch_rejections ride the same /metrics/<cluster>/ feed
            agent.metrics.register_source(
                "shardmap", lambda: self.coordinator.metrics())

    # ------------------------------------------------------------------ app config
    def upload_spec(self, spec: AppSpec) -> None:
        """Validate + broadcast the CRD to every agent (configuration phase)."""
        spec.validate(list(self.agents))
        self.spec = spec
        self.overwatch.handle({"op": "put", "key": "/config/appspec",
                               "value": {"services": len(spec.services),
                                         "pods": len(spec.pods)}})
        self.dispatcher.broadcast_spec(spec, self._master_agent.state)

    # ------------------------------------------------------------------ job surface
    def _build_job(self, kind: str, *, arch: str = "", steps: int = 10,
                   tags: Optional[dict] = None, job_id: Optional[str] = None,
                   payload: Optional[dict] = None) -> dict:
        jid = job_id or f"job-{next(self._job_ids):04d}"
        return {"job_id": jid, "kind": kind, "arch": arch, "steps": steps,
                "tags": tags or {}, "payload": payload or {}}

    def submit_job(self, kind: str, **kw) -> str:
        job = self._build_job(kind, **kw)
        self.dispatcher.submit(job)
        return job["job_id"]

    def submit_jobs(self, jobs: List[dict]) -> List[str]:
        """Batched admission: each item is a dict of ``submit_job`` keyword
        arguments (``kind`` required). The dispatcher amortizes placement over
        the whole batch (one min-load probe, round-robin across the tie block)
        instead of re-picking per job. Returns the job ids in order."""
        built = [self._build_job(**spec) for spec in jobs]
        self.dispatcher.submit_many(built)
        return [job["job_id"] for job in built]

    def job_status(self, job_id: str) -> Optional[dict]:
        return self.overwatch.handle(
            {"op": "get", "key": f"/jobs/{job_id}/status"})["value"]

    def retire_job(self, job_id: str) -> bool:
        """Gracefully stop a placed job and tombstone its store records —
        never recorded as a failure, never resurrected by recovery; the
        management-plane surface the autoscaler uses to return worker pods
        (see ``Dispatcher.retire``)."""
        return self.dispatcher.retire(job_id)

    def add_routing_rule(self, rule: RoutingRule) -> None:
        self.dispatcher.add_rule(rule)

    # --------------------------------------------------------------- crash recovery
    def recover_global_plane(self) -> dict:
        """Rebuild the crashed global-plane services in place (the master
        process restarting on the same addresses): a fresh ``OverwatchService``
        whose constructor replays snapshot + WAL, a fresh ``Dispatcher`` whose
        constructor re-seeds its materialized views from the recovered store,
        and (fan-out mode) a fresh ``ReplicaShipper`` that resumes each
        surviving cluster's feed from its replica's cumulative-ack horizon —
        full reseed (with a reset marker) only when the horizon predates the
        oldest replayable event. Control agents, workers, and the fabric
        survive a master crash and are never touched; ``register_handler``
        overwrites, so the rebuilt services answer on the exact addresses the
        survivors already talk to. Returns the overwatch recovery stats."""
        self.fabric.heal_cluster(self.master)
        self.overwatch = OverwatchService(self.fabric, self.master,
                                          op_log_limit=self._op_log_limit,
                                          num_shards=self.ow_shards,
                                          coalesce_watches=self._coalesce_watches,
                                          durability=self.durability)
        self.dispatcher = Dispatcher(self.fabric, self.master, self.overwatch)
        self.dispatcher.tracer = self.tracer
        if self.coordinator is not None:
            # the whole plane restarted: every master restarts empty-handed,
            # the map (epoch + assignment) replays from the shardmap WAL,
            # and the fresh overwatch's shard endpoints are re-guarded under
            # their WAL-recorded owners before any client retry lands
            self._build_coordinator()
        self.shipper = None
        if self._replica_fanout:
            from repro_torch.core.replica import ReplicaShipper
            from repro_torch.core.transport import DeliveryError
            self.shipper = ReplicaShipper(self.overwatch,
                                          self.dispatcher.send_agent,
                                          prefixes=self._replica_prefixes)
            self.dispatcher.on_cluster_down(self.shipper.unregister)
            tail = self.overwatch.recovery_tail
            tail_base = self.overwatch.recovery_base_rev
            for name in sorted(self.agents):
                agent = self.agents[name]
                if name == self.master or agent.replica is None:
                    continue
                try:
                    resp = self.dispatcher.send_agent(
                        name, {"kind": "replica_rev"})
                    applied = int(resp.get("rev", 0))
                except (DeliveryError, KeyError):
                    # unreachable (partitioned) or not yet re-registered:
                    # bootstrap-seed the feed with a RESET marker — the
                    # replica's horizon is unknowable and its snapshot may
                    # hold keys whose deletion the fresh seed cannot
                    # tombstone; ships fail harmlessly until the cluster
                    # heals or its lease tombstones it, and the first ship
                    # after heal re-converges the replica (and its watchers,
                    # deletions included) from scratch
                    self.shipper.register(name, reset=True)
                    continue
                self.shipper.register_resume(name, applied, tail, tail_base)
        # a cluster whose registration (lease grant + /clusters/ put) was
        # still in the uncommitted tail is unknown to the recovered store and
        # its surviving heartbeat can only keepalive a dead lease id: re-grant
        # and re-put for it here, WITHOUT re-scheduling its heartbeat timer
        # (the original timer never stopped). Partitioned clusters are skipped
        # and re-register by hand (or stay tombstoned) after they heal.
        from repro_torch.core.transport import DeliveryError
        for name in sorted(self.agents):
            agent = self.agents[name]
            try:
                known = agent.ow.get(f"/clusters/{name}")
                if known is None:
                    agent.lease = agent.ow.lease_grant(agent.lease_ttl)
                    agent.ow.put(f"/clusters/{name}", {
                        "idx": agent.idx,
                        "capabilities": agent.local_plane.capabilities(),
                        "agent_addr": list(agent.addr),
                    }, lease=agent.lease)
            except DeliveryError:
                continue
        return dict(self.overwatch.recovery_stats)

    # -------------------------------------------------------------------- operation
    def tick(self, dt: float = 1.0, n: int = 1) -> None:
        for _ in range(n):
            self.fabric.tick(dt)
            if self.coordinator is not None:
                # before the sweep: failover repairs emitted by a rebuild
                # flush to watchers/replicas within the same tick
                self.coordinator.step()
            self.overwatch.sweep()
            if self.shipper is not None:
                self.shipper.ship_all()      # one delta envelope per cluster

    def run_until_done(self, job_ids: List[str], max_ticks: int = 200) -> bool:
        for _ in range(max_ticks):
            self.tick()
            st = [self.job_status(j) for j in job_ids]
            if all(s and s["status"] == "done" for s in st):
                return True
        return False

    # ------------------------------------------------------------------ observation
    def boundary_report(self) -> dict:
        f = self.fabric
        out = {
            "cross_cluster_bytes": f.cross_cluster_bytes(),
            "local_bytes": sum(f.local_bytes.values()),
            "locality_ratio": f.locality_ratio(),
            "per_edge": dict(f.cross_bytes),
            "fabric_stats": dict(f.stats),
        }
        if self.shipper is not None:
            out["replica_ships"] = dict(self.shipper.stats)
        return out
