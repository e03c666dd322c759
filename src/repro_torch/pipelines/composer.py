"""Copy of ``repro.pipelines.composer`` under ``repro_torch``.

HybridComposer — the paper's §5 use case, end to end.

Embeds the Airflow components as pods/services of an AppSpec over the hybrid
platform: scheduler + broker + taskdb on the master (public) partition, workers
on any partitions (private clusters included). ``upload()`` runs the
configuration phase (CRD broadcast -> Algorithm 5 in every agent); afterwards
workers on private partitions consume the master-hosted broker/DB purely
through gateway routes — Figure 3 of the paper, reproduced as a test (see
tests/test_pipelines.py, which also asserts the ACLs block any pod NOT in the
dependency graph).

The composer also drives the broker's depth telemetry: on a sweep cadence
(``depth_publish_every`` fabric-clock units, only queues whose counts moved)
it publishes ``{"ready", "inflight"}`` under ``/queues/<name>`` in the
overwatch via the master agent, which feeds the dispatcher's materialized
queue-depth view — the "place workers near deep queues" loop. A queue that
drains to zero is TOMBSTONED (the key is deleted) rather than left at a
stale 0/0, so the depth view only ever lists queues with live backlog.

Worker fleets are elastic: ``add_worker``/``remove_worker`` grow and shrink
the pod set at runtime — each change rebuilds the AppSpec and re-broadcasts
it (Algorithm 5 re-runs on every agent: DNS/routes idempotently, ACLs from
scratch), so a new worker pod gains broker/taskdb access the moment it lands
and a removed pod loses it. ``attach_autoscaler`` wires the
``repro_torch.autoscale`` reconciler into the tick loop: the published queue
depths drive worker-pod placement and retirement with no manual sizing.

``broker_shards=N`` splits the broker per queue family behind a
``BrokerRouter`` (consistent hash over queue names, the overwatch shard
discipline): one ``Broker`` + one service/fabric endpoint per shard, with the
scheduler and every worker routing each queue's ops to its owning shard —
disjoint families stop serializing through one handler. One shard keeps the
single historic ``"broker"`` service and is behavior-identical.
``depth_gated_workers=True`` (needs the plane's replica fan-out) lets remote
workers consult their cluster's watch-materialized ``/queues/`` view — fed by
the replica notify plane, one shipped envelope per sweep however many workers
subscribe — and skip the cross-boundary ``pull_many`` for queues the local
view shows empty.

``pipelined=True`` (default) runs the batched data plane end to end: the
scheduler coalesces each tick's frontier into one ``upsert_many`` plus one
``push_many`` per queue, and workers drain ``worker_batch`` tasks per
``pull_many`` and commit through ``upsert_many``/``ack_many``.
``pipelined=False`` keeps the seed's per-task protocol (4+ RPCs per task) —
the two produce identical terminal taskdb states.

Crash survival (the durable control plane): with a shared ``LogStore``
(``durability=``) the taskdb and every broker shard write WAL records as they
mutate, group-committed once per composer tick — taskdb FIRST, then brokers,
so an ack can only be durable if the rows it covers are too (the invariant
that makes post-crash redelivery loss-free). ``recover()`` rebuilds the whole
master-hosted pipeline after a crash of the global plane: fresh
broker/taskdb services replay their snapshots + WAL onto the same fabric
addresses, a fresh scheduler re-registers the DAGs and probes the recovered
table from cursor 0, surviving workers run the recovery barrier (drop
unexecuted leases, retry interrupted commits verbatim, re-upsert their
``recent_rows`` resync rings), the autoscaler is rebuilt and ADOPTS the
surviving worker-pod fleet from overwatch placements, and ``_reseed_tasks``
re-pushes (flagged redelivered) any queued/running task whose broker message
died with the uncommitted tail. Exactly-once for executions holds across any
master crash; the one fundamental exception — a PARTITIONED worker's
executed-but-unlanded batch may re-run elsewhere — is the classic
impossibility, not a recovery bug.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.plane import ManagementPlane
from repro_torch.core.service_graph import AppSpec, Pod, Service
from repro_torch.core.transport import DeliveryError, StaleEpochError
from repro_torch.pipelines.broker import Broker, BrokerRouter, broker_service_names
from repro_torch.pipelines.dag import DAG
from repro_torch.pipelines.scheduler import Scheduler, queue_for
from repro_torch.pipelines.services import ServiceClient, ServiceEndpoint
from repro_torch.pipelines.taskdb import TaskDB
from repro_torch.pipelines.worker import PipelineWorker

BROKER_PORT = 6379      # the paper's redis
TASKDB_PORT = 5432      # the paper's SQL database


def composer_appspec(master: str, workers: Dict[str, Sequence[str]],
                     broker_shards: int = 1) -> AppSpec:
    """workers: cluster -> worker pod names hosted there. With
    ``broker_shards > 1`` the broker is one service PER SHARD
    (``broker-s<k>``, consecutive ports) so each shard gets its own fabric
    endpoint and gateway tunnels; one shard keeps the historic single
    ``"broker"`` service — the AppSpec is byte-identical to pre-sharding."""
    broker_svcs = broker_service_names(broker_shards)
    needs = tuple(broker_svcs) + ("taskdb",)
    pods = [Pod("scheduler-pod", needs=needs),
            Pod("broker-pod", needs=()),
            Pod("taskdb-pod", needs=())]
    partition = {"scheduler-pod": master, "broker-pod": master,
                 "taskdb-pod": master}
    for cluster, names in workers.items():
        for w in names:
            pods.append(Pod(w, needs=needs))
            partition[w] = cluster
    services = tuple(Service(s, BROKER_PORT + i, ("broker-pod",))
                     for i, s in enumerate(broker_svcs))
    services += (Service("taskdb", TASKDB_PORT, ("taskdb-pod",)),)
    return AppSpec(services=services, pods=tuple(pods), partition=partition)


class HybridComposer:
    def __init__(self, plane: ManagementPlane,
                 workers: Dict[str, Sequence[str]],
                 worker_queues: Optional[Dict[str, Tuple[str, ...]]] = None,
                 worker_batch: int = 16, pipelined: bool = True,
                 depth_publish_every: float = 1.0,
                 worker_setup=None,
                 broker_shards: int = 1,
                 depth_gated_workers: bool = False,
                 depth_gate_max_lag: float = 2.0,
                 durability=None,
                 wal_snapshot_every: int = 8192,
                 cost_aware: bool = False,
                 step_cache: int = 4,
                 trace_sample: float = 0.0,
                 tracer=None):
        self.plane = plane
        self.worker_batch = worker_batch
        self.pipelined = pipelined
        # flight recorder: an explicit tracer wins, else trace_sample > 0
        # creates one on the fabric clock, else the plane's own (if any).
        # No tracer anywhere => no "trace" keys ever attached => every fabric
        # payload is byte-identical to the uninstrumented plane.
        if tracer is not None:
            self.tracer = tracer
        elif trace_sample > 0:
            from repro_torch.observability.trace import Tracer
            self.tracer = Tracer(clock_fn=lambda: plane.fabric.clock,
                                 sample=trace_sample)
        else:
            self.tracer = getattr(plane, "tracer", None)
        # roofline-cost-aware queue routing (repro_torch.roofline.cost): priced
        # tasks gain their steering capability tag in the queue name, so
        # compute-bound stages route to accelerator-tier workers and IO-bound
        # stages to the cheap tier. False (default) is byte-identical to the
        # depth-aware-only plane; unpriced tasks are never steered.
        self.cost_aware = cost_aware
        # per-worker compiled-step cache capacity ((arch, shape, mode) ->
        # warm Trainer/Server); 0 disables (cold rebuild per task)
        self.step_cache = step_cache
        # durability (repro_torch.core.durability.LogStore): WAL shards "taskdb" +
        # one per broker service, group-committed per tick (taskdb first).
        # None => byte-identical to the non-durable composer. Public: the
        # chaos harness reaches it to model commit loss at a crash.
        self.durability = durability
        self.wal_snapshot_every = wal_snapshot_every
        self.recovery_stats: Dict[str, int] = {}
        # applied to every worker, static AND dynamically spawned — the hook
        # for registering custom task kinds on autoscaled pods
        self.worker_setup = worker_setup
        self.broker_shards = max(1, broker_shards)
        self.router = BrokerRouter(self.broker_shards)
        self._broker_services = broker_service_names(self.broker_shards)
        # remote workers consult their cluster-local overwatch replica's
        # /queues/ view before pulling (needs plane replica fan-out; workers
        # on clusters without a replica keep the always-pull protocol)
        self.depth_gated_workers = depth_gated_workers
        self.depth_gate_max_lag = depth_gate_max_lag
        self.spec = composer_appspec(plane.master, workers,
                                     self.broker_shards)
        plane.upload_spec(self.spec)

        self._build_master_services()

        self.workers: List[PipelineWorker] = []
        for cluster, names in workers.items():
            for w in names:
                queues = (worker_queues or {}).get(w, ("default",))
                self._make_worker(w, cluster, queues)
        self.depth_publish_every = depth_publish_every
        self._depth_published_at: Optional[float] = None
        self._published_queues: set = set()
        self._spec_dirty = False
        self.autoscaler = None
        self._autoscaler_args: Optional[tuple] = None
        self._dags: Dict[str, DAG] = {}

    def _build_master_services(self) -> None:
        """(Re)build the master-hosted services — broker shards, taskdb,
        scheduler — on their fabric addresses. With durability attached,
        fresh brokers/taskdb recover from their WAL shards in their
        constructors; ``register_handler`` overwrites, so a rebuild (crash
        recovery) answers on the exact addresses surviving workers use."""
        fabric = self.plane.fabric
        master_state = self.plane.master_agent.state
        self.brokers = [Broker(clock_fn=lambda: fabric.clock,
                               durability=self.durability, shard_name=sname,
                               tracer=self.tracer)
                        for sname in self._broker_services]
        self.broker = self.brokers[0]   # single-shard accessor (tests, back-compat)
        self.taskdb = TaskDB(durability=self.durability)
        co = getattr(self.plane, "coordinator", None)
        for i, sname in enumerate(self._broker_services):
            # index closure, not a bound method: a live migration or master
            # failover swaps self.brokers[i] in place and the endpoint (and
            # the coordinator's re-guards) follow for free
            handler = (lambda msg, _i=i: self.brokers[_i].handle(msg))
            ep = ServiceEndpoint(fabric, self.spec, master_state, sname,
                                 handler)
            if co is not None:
                co.register_shard(
                    sname, ep.addr, handler,
                    ops={"freeze": (lambda _i=i: setattr(
                            self.brokers[_i], "frozen", True)),
                         "unfreeze": (lambda _i=i: setattr(
                            self.brokers[_i], "frozen", False)),
                         "export": (lambda _i=i:
                                    self.brokers[_i].snapshot_payload()),
                         "import_": (lambda p, _i=i:
                                     self._install_broker_shard(_i, p)),
                         "rebuild": (lambda _i=i:
                                     self._failover_broker_shard(_i))},
                    wal_shards=(sname,))
                self.brokers[i].on_stale = (
                    lambda _s=sname, _co=co: _co.note_stale(_s))
        ServiceEndpoint(fabric, self.spec, master_state, "taskdb",
                        self.taskdb.handle)
        sched_client = ServiceClient(fabric, master_state, "scheduler-pod")
        self.scheduler = Scheduler(sched_client, clock_fn=lambda: fabric.clock,
                                   batched=self.pipelined,
                                   broker_for=self.router.service_for_queue,
                                   cost_aware=self.cost_aware,
                                   tracer=self.tracer)
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Adopt the pipeline's legacy stats dicts into the master agent's
        metrics registry under stable dotted names. Sources late-bind through
        ``self`` (``self.brokers[i]``, ``self.taskdb``, ``self.autoscaler``),
        so a crash-recovery rebuild needs no re-registration — the next
        snapshot reads the fresh objects."""
        reg = getattr(self.plane.master_agent, "metrics", None)
        if reg is None:
            return
        for i, sname in enumerate(self._broker_services):
            def broker_stats(i=i):
                b = self.brokers[i]
                out = dict(b.stats)
                out.update({f"ops.{k}": v for k, v in b.op_counts.items()})
                return out
            reg.register_source(f"broker.{sname}", broker_stats)
        reg.register_source("taskdb",
                            lambda: dict(self.taskdb.op_counts))
        reg.register_source("autoscale", self._autoscale_metrics)
        if self.tracer is not None:
            reg.register_source("trace",
                                lambda: dict(self.tracer.stats))

    def _autoscale_metrics(self) -> dict:
        a = self.autoscaler
        if a is None:
            return {}
        out = {"events": a.events.total_appended}
        for family, pods in a.pods.items():
            out[f"pods.{family}"] = len(pods)
        return out

    def _make_worker(self, name: str, cluster: str,
                     queues: Tuple[str, ...]) -> PipelineWorker:
        agent = self.plane.agents[cluster]
        fabric = self.plane.fabric
        client = ServiceClient(fabric, agent.state, name)
        worker = PipelineWorker(
            client, name, queues=queues, clock_fn=lambda: fabric.clock,
            batch=self.worker_batch, pipelined=self.pipelined,
            broker_for=self.router.service_for_queue,
            depth_hint=self._depth_hint_for(agent),
            step_cache=self.step_cache, tracer=self.tracer,
            metrics=getattr(agent, "metrics", None))
        reg = getattr(agent, "metrics", None)
        if reg is not None:
            def worker_stats(w=worker):
                out = {"executed": w.executed, "deduped": w.deduped,
                       "skipped_pulls": w.skipped_pulls}
                if w._trainer_cache is not None:
                    out.update({f"step_cache.{k}": v for k, v
                                in w._trainer_cache.stats().items()})
                return out
            reg.register_source(f"worker.{name}", worker_stats)
        if self.worker_setup is not None:
            self.worker_setup(worker)
        self.workers.append(worker)
        return worker

    def _depth_hint_for(self, agent):
        """The worker depth gate: believed ready depth off the hosting
        cluster's watch-materialized ``/queues/`` view (``agent.local_view``)
        — maintained purely from the replica-fed notify plane, never a
        per-call probe. None (always pull) when gating is off, the worker is
        master-local (its pulls never cross the boundary), or the cluster
        hosts no replica. An out-of-bound replica reports "unknown" (pull)
        rather than a confidently wrong zero — the same transparent
        primary-fallback contract as ``range_stale``."""
        if (not self.depth_gated_workers or agent.replica is None
                or agent.cluster == self.plane.master):
            return None
        replica, fabric = agent.replica, self.plane.fabric
        view = agent.local_view("/queues/")
        max_lag = self.depth_gate_max_lag

        def hint(queue: str) -> int:
            if replica.lag(fabric.clock) > max_lag:
                return 1                     # unknown: fall back to pulling
            row = view.get(f"/queues/{queue}")
            return int((row or {}).get("ready", 0))

        return hint

    # ------------------------------------------------------------------- user API
    def add_dag(self, dag: DAG) -> None:
        self._dags[dag.dag_id] = dag
        self.scheduler.add_dag(dag)

    def tick(self) -> None:
        self.scheduler.tick()
        for w in list(self.workers):
            try:
                w.tick()
            except DeliveryError:
                # the worker's cluster is partitioned/dead: its leased tasks
                # redeliver on lease expiry, and the autoscaler (if attached)
                # prunes and replaces the pod on its next pass
                continue
        self.publish_queue_depths()
        if self.autoscaler is not None:
            self.autoscaler.reconcile()
        self._commit_pipeline_wal()
        self.plane.tick()

    def _commit_pipeline_wal(self) -> None:
        """Per-tick group commit of the pipeline WAL shards. Taskdb FIRST:
        a crash between the two commits may leave an ack durable only when
        the rows it covers already are — never an acked task whose terminal
        row was lost (that would be a silently dropped execution). Snapshot +
        truncate whenever a shard's replay tail outgrows
        ``wal_snapshot_every``."""
        dur = self.durability
        if dur is None:
            return
        dur.commit(self.taskdb._shard)
        if (dur.records_since_snapshot(self.taskdb._shard)
                >= self.wal_snapshot_every):
            dur.snapshot(self.taskdb._shard, self.taskdb.snapshot_payload())
        for shard in self.brokers:
            dur.commit(shard._shard)
            if (dur.records_since_snapshot(shard._shard)
                    >= self.wal_snapshot_every):
                dur.snapshot(shard._shard, shard.snapshot_payload())

    # ------------------------------------------------------------- elastic fleet
    def add_worker(self, name: str, cluster: str,
                   queues: Tuple[str, ...] = ("default",),
                   broadcast: bool = True) -> PipelineWorker:
        """Materialize a new worker pod at runtime: extend the AppSpec with
        the pod, re-broadcast the CRD (every agent re-runs Algorithm 5 — the
        new pod gets DNS + ACL access to broker/taskdb), then start the
        local ``PipelineWorker``. ``broadcast=False`` defers the re-broadcast
        (mark dirty, ``flush_spec`` later) so a burst of pod changes costs
        ONE broadcast — safe as long as the flush lands before the new
        worker's first tick, which the autoscaler guarantees by flushing at
        the end of every reconcile pass."""
        pods = tuple(self.spec.pods) + (
            Pod(name, needs=tuple(self._broker_services) + ("taskdb",)),)
        partition = {**self.spec.partition, name: cluster}
        self.spec = AppSpec(services=self.spec.services, pods=pods,
                            partition=partition)
        self._spec_dirty = True
        if broadcast:
            self.flush_spec()
        return self._make_worker(name, cluster, queues)

    def remove_worker(self, worker: PipelineWorker,
                      broadcast: bool = True) -> None:
        """Tear a worker pod out of the app: drop it from the local fleet and
        re-broadcast the shrunk AppSpec so its ACL entries are revoked (a
        removed pod can no longer reach the broker — Algorithm 3 is rebuilt
        default-deny on every re-broadcast). ``broadcast=False`` defers like
        ``add_worker``."""
        # A drained pod's final rows + acks may still sit in the uncommitted
        # WAL tail, and its ``recent_rows`` resync ring leaves the fleet with
        # it: force the group commit NOW, so a crash after removal can never
        # lose work only this (now gone) pod could have re-proven terminal.
        # Pod removals are rare (scale-down / lost-pod events), so the extra
        # commit is noise.
        self._commit_pipeline_wal()
        if worker in self.workers:
            self.workers.remove(worker)
        if worker.pod not in self.spec.partition:
            return
        pods = tuple(p for p in self.spec.pods if p.name != worker.pod)
        partition = {k: v for k, v in self.spec.partition.items()
                     if k != worker.pod}
        self.spec = AppSpec(services=self.spec.services, pods=pods,
                            partition=partition)
        self._spec_dirty = True
        if broadcast:
            self.flush_spec()

    def flush_spec(self) -> None:
        """Re-broadcast the AppSpec if any deferred pod change is pending."""
        if self._spec_dirty:
            self._spec_dirty = False
            self.plane.upload_spec(self.spec)

    def attach_autoscaler(self, policies, **kwargs):
        """Create and wire a ``repro_torch.autoscale.Reconciler`` into the tick
        loop (see that module for the policy/quota/spillover model)."""
        from repro_torch.autoscale.reconciler import Reconciler
        self._autoscaler_args = (policies, dict(kwargs))
        self.autoscaler = Reconciler(self, policies, **kwargs)
        return self.autoscaler

    # ----------------------------------------------------------- crash recovery
    def recover(self) -> Dict[str, int]:
        """Rebuild the master-hosted pipeline after a global-plane crash
        (call AFTER ``plane.recover_global_plane()``). The sequence is the
        recovery barrier the worker docstring's contract assumes:

          1. fresh brokers/taskdb/scheduler replay their WAL shards onto the
             same fabric addresses; DAGs re-register (terminal states come
             back through the scheduler's first probe from cursor 0);
          2. surviving workers drop unexecuted leases (the recovered broker
             requeued them flagged), retry any commit the crash interrupted
             — verbatim, no re-execution — and re-upsert their
             ``recent_rows`` resync rings, making every completed execution's
             terminal row durable even if its original commit died with the
             uncommitted tail;
          3. the autoscaler is rebuilt and adopts the surviving worker-pod
             fleet from overwatch placements (finishing any interrupted
             drains);
          4. ``_reseed_tasks`` re-pushes lost messages / marks broker-held
             ones, then the WAL is committed so recovery itself is durable.

        Workers on partitioned clusters are skipped wherever they are
        unreachable and converge after heal via lease expiry + redelivery."""
        if self.tracer is not None:
            # spans owned by the crashed master's components truncate at the
            # recovery epoch BEFORE the rebuild: WAL replay inside the fresh
            # brokers re-opens queue spans under the same keys, so the order
            # is load-bearing (truncate-after would kill the replayed spans).
            # Task ROOT spans and worker execute/commit spans live on — roots
            # still close at the terminal row, worker commit spans when the
            # retried commit's acks land.
            self.tracer.truncate_open(components=("scheduler", "broker"))
        self._build_master_services()
        for dag in self._dags.values():
            self.scheduler.add_dag(dag)
        stats = {"dropped_leases": 0, "retried_commits": 0,
                 "resynced_rows": 0,
                 "taskdb_replayed": self.taskdb.recovery_replayed,
                 "broker_replayed": sum(
                     b.stats.get("recovery_replayed", 0)
                     for b in self.brokers)}
        for w in list(self.workers):
            # stale backoff windows must not skip the recovery barrier calls
            w.client.reset_backoff()
            stats["dropped_leases"] += w.reset_after_master_restart()
            try:
                if w._pending_commit is not None:
                    w.retry_pending()
                    stats["retried_commits"] += 1
                rows = list(w.recent_rows)
                if rows:
                    w.client.call("taskdb", {"op": "upsert_many",
                                             "rows": rows})
                    stats["resynced_rows"] += len(rows)
            except DeliveryError:
                continue   # partitioned: converges after heal via redelivery
        if self._autoscaler_args is not None:
            from repro_torch.autoscale.reconciler import Reconciler
            policies, kwargs = self._autoscaler_args
            self.autoscaler = Reconciler(self, policies, **kwargs)
            stats["adopted_pods"] = self.autoscaler.adopt(self.workers)
        stats.update(self._reseed_tasks())
        # recovered /queues/ state may predate the last published depths:
        # resync the tombstone set to the store and force a full republish
        ow_queues = self.plane.overwatch.handle(
            {"op": "range", "prefix": "/queues/"})["items"]
        self._published_queues = {k[len("/queues/"):] for k in ow_queues}
        self._depth_published_at = None
        self._commit_pipeline_wal()
        self.recovery_stats = stats
        return stats

    def _reseed_tasks(self) -> Dict[str, int]:
        """Close the scheduler-vs-broker gap the crash tore open. After WAL
        replay the taskdb and brokers are each internally consistent but may
        disagree: a task row can say queued/running while its broker message
        died in the uncommitted tail (re-push it, flagged redelivered — the
        worker-side dedup probe makes that safe even if it actually ran), and
        the broker can hold a message whose queued row was lost (mark it
        running via ``note_inflight`` so the frontier never stages a
        duplicate)."""
        held: set = set()
        for shard in self.brokers:
            held |= shard.held_task_keys()
        held_tasks = {(d, t) for d, t, _ in held}
        self.scheduler._probe()
        pushes: Dict[str, List[dict]] = {}
        reseeded = noted = 0
        for did, dag in sorted(self._dags.items()):
            state = self.scheduler._state.get(did, {})
            for name, task in sorted(dag.tasks.items()):
                row = state.get(name)
                status = (row or {}).get("status")
                if status in ("queued", "running"):
                    if (did, name, row["try"]) not in held:
                        m = Scheduler.build_message(did, task, row["try"])
                        if self.tracer is not None:
                            # re-attach to the surviving root span, if traced
                            ctx = self.tracer.ctx_for(("task", did, name))
                            if ctx is not None:
                                m["trace"] = ctx
                        pushes.setdefault(
                            queue_for(task, self.cost_aware), []).append(m)
                        reseeded += 1
                elif row is None and (did, name) in held_tasks:
                    self.scheduler.note_inflight(did, name)
                    noted += 1
        for q in sorted(pushes):
            # through the scheduler's bounded-retry push path: a target shard
            # that is itself frozen / failing over stashes the batch for next
            # tick instead of losing it (double-failover scenarios)
            self.scheduler._push(q, pushes[q], redelivered=True)
        return {"reseeded": reseeded, "noted_inflight": noted}

    # ------------------------------------------------------- shard migration
    def _install_broker_shard(self, i: int, payload: dict) -> None:
        """Live-migration import (coordinator ``import_`` op): a fresh
        ``Broker`` under the target master installs the transferred payload
        directly — no WAL replay, the payload IS the committed state (the
        coordinator snapshotted it at transfer). Counters start fresh: the
        target is a different process in the model."""
        fabric = self.plane.fabric
        sname = self._broker_services[i]
        old = self.brokers[i]
        fresh = Broker(clock_fn=lambda: fabric.clock,
                       durability=self.durability, shard_name=sname,
                       tracer=self.tracer, recover=False)
        fresh.install_payload(payload)
        fresh.on_stale = old.on_stale
        self.brokers[i] = fresh
        if i == 0:
            self.broker = fresh

    def _failover_broker_shard(self, i: int) -> None:
        """Failover rebuild (coordinator ``rebuild`` op): the owning master
        died with this shard's uncommitted WAL tail. A fresh ``Broker``
        replays the committed snapshot + records in its constructor —
        requeueing recovered in-flight flagged and bumping the tag epoch so
        the dead owner's outstanding leases can never ack — then
        ``_reseed_tasks`` closes the taskdb-vs-broker gap for messages that
        died in the lost tail."""
        fabric = self.plane.fabric
        sname = self._broker_services[i]
        old = self.brokers[i]
        fresh = Broker(clock_fn=lambda: fabric.clock,
                       durability=self.durability, shard_name=sname,
                       tracer=self.tracer)
        fresh.on_stale = old.on_stale
        self.brokers[i] = fresh
        if i == 0:
            self.broker = fresh
        # the rebuilt shard answers immediately (its frozen flag is fresh);
        # re-dirty its depth view so the next sweep republishes every queue
        self._depth_published_at = None
        stats = self._reseed_tasks()
        for k, v in stats.items():
            self.recovery_stats[f"failover_{k}"] = (
                self.recovery_stats.get(f"failover_{k}", 0) + v)

    # ------------------------------------------------------------ depth telemetry
    def publish_queue_depths(self) -> None:
        """Sweep-cadence depth publication: at most once per
        ``depth_publish_every`` fabric-clock units, put the (ready, inflight)
        counts of every queue whose depth changed under ``/queues/<name>`` —
        a handful of coalesce-friendly puts, not one per queue per tick.

        A queue that drained to zero (no ready, no inflight) is tombstoned:
        its key is DELETED so the dispatcher's ``_queue_depth`` view drops
        the entry instead of carrying a stale last-depth forever. A queue
        that appears and fully drains within one cadence window is never
        published at all."""
        now = self.plane.fabric.clock
        if (self._depth_published_at is not None
                and now - self._depth_published_at < self.depth_publish_every):
            return
        self._depth_published_at = now
        ow = self.plane.master_agent.ow
        for i, shard in enumerate(self.brokers):
            # each shard reports only the families it owns (belt-and-braces:
            # the router already steers every op to its owner), so a family
            # is published exactly once however many shards exist
            owned = (None if self.broker_shards == 1
                     else (lambda q, _i=i:
                           self.router.shard_for_queue(q) == _i))
            for queue, depth in shard.changed_depths(families=owned).items():
                try:
                    if not depth["ready"] and not depth["inflight"]:
                        if queue in self._published_queues:
                            ow.delete(f"/queues/{queue}")
                            self._published_queues.discard(queue)
                        continue
                    ow.put(f"/queues/{queue}", {**depth, "clock": now})
                    self._published_queues.add(queue)
                except (DeliveryError, StaleEpochError):
                    # the owning overwatch shard is frozen / failing over:
                    # re-dirty so the next sweep republishes this queue
                    shard._published.pop(queue, None)
                    shard._depth_dirty.add(queue)

    def run_dag(self, dag_id: str, max_ticks: int = 500) -> bool:
        for _ in range(max_ticks):
            self.tick()
            # probe-free doneness: the next tick's shared probe folds in any
            # commits this tick's workers made, so the check lags by at most
            # one tick instead of paying a second delta RPC every tick
            if self.scheduler.dag_done(dag_id, probe=False):
                return self.scheduler.dag_success(dag_id, probe=False)
        # budget exhausted: one probed check so a DAG finishing on the very
        # last tick isn't misreported by the one-tick observation lag
        if self.scheduler.dag_done(dag_id):
            return self.scheduler.dag_success(dag_id, probe=False)
        return False

    def status(self, dag_id: str) -> Dict[str, str]:
        return self.scheduler.dag_status(dag_id)
