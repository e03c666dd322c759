"""Copy of ``repro.core.dispatcher`` under ``repro_torch``.

Intelligent job dispatcher (paper §2.iv) + failure detector + stragglers.

Routing: a job carries tags (``requires`` capabilities, ``locality`` preference);
the dispatcher filters registered clusters by capability, honors explicit routing
rules (the paper's "pre-defined service routing rule"), then picks the least
loaded by telemetry. It doubles as the pubsub message publisher of §4.1: CRD
configuration objects are broadcast to every registered control agent.

Fault tolerance: cluster registrations are lease-backed; the overwatch deletes
them when heartbeats stop. The dispatcher watches the tombstones and re-dispatches
the dead cluster's jobs to healthy clusters — resuming from the job's last
committed checkpoint manifest (recorded under /checkpoints/<job>). Straggler
mitigation compares per-job step rates against the fleet median and re-dispatches
(or backup-dispatches) jobs that fall below a configurable fraction of it.

Hot path (the scaling overhaul): the dispatcher no longer issues overwatch
range scans per operation. It subscribes to ``/clusters/``, ``/telemetry/``
and ``/jobs/`` watch events and maintains materialized views:

  * ``_clusters`` / ``_telemetry`` — registration + telemetry directories,
    incrementally invalidated (``clusters()``/``telemetry()`` are now O(n)
    dict copies with zero store round-trips);
  * ``_load_order`` — a (load, cluster) sorted candidate structure, so
    ``pick()`` finds the least-loaded eligible clusters without re-reading
    telemetry;
  * ``_caps_index`` — capability -> clusters, so ``candidates()`` intersects
    small sets instead of scanning every registration;
  * ``_jobs_by_cluster`` / ``_placement`` / ``_status`` / ``_running`` —
    placement and status views, so ``recover_cluster_jobs`` touches only the
    dead cluster's jobs and ``check_stragglers`` only running jobs, never the
    whole ``/jobs/`` keyspace.

Every view is derived purely from watch events emitted by the (linearizable)
overwatch, so it is exactly as consistent as the range scans it replaces.

Batch-event form (the sharding/coalescing overhaul): the views subscribe via
``watch_batch`` and ingest revision-ordered event lists — one callback per
flush instead of one per mutation. Every public method that reads a view
opens with ``ow.flush_watches()``, the read barrier that makes the views
exactly as fresh as a linearizable range would be; with coalescing off the
batches are synchronous singletons and behavior is unchanged.

``submit_many`` amortizes admission over a batch: the min-load block of
``_load_order`` is computed once and unconstrained jobs round-robin across it
without re-probing per job.

Depth-aware placement (the data-plane overhaul): the broker publishes
per-queue ``{"ready", "inflight"}`` depth under ``/queues/<name>`` (via the
pipeline composer's sweep-cadence publisher), and the dispatcher keeps a
materialized ``_queue_depth`` view of it. A job that declares the queues its
workers will consume (``tags={"queues": [...]}`` — a worker-pod job) is
placed on the eligible cluster whose capabilities cover the deepest matching
backlog: ready tasks in a compliance queue can only be drained by workers on
clusters holding those capability tags, so placement follows the backlog.
Ties (including "no depth telemetry yet") fall back to least-load, so the
bias degrades to plain least-loaded placement when queues are empty.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.overwatch import OverwatchService
from repro_torch.core.transport import DeliveryError, Envelope, Fabric


@dataclasses.dataclass
class RoutingRule:
    """If ``match(job)`` then restrict candidates to ``clusters``."""
    name: str
    match: Callable[[dict], bool]
    clusters: List[str]


class Dispatcher:
    def __init__(self, fabric: Fabric, master: str, overwatch: OverwatchService,
                 straggler_factor: float = 0.5):
        self.fabric = fabric
        self.master = master
        self.ow = overwatch
        self.rules: List[RoutingRule] = []
        self.straggler_factor = straggler_factor
        self._rr = itertools.count()
        # flight recorder (set by ManagementPlane): sampled job submissions
        # open a "job" root + "dispatch" child whose context rides the
        # dispatch envelope to the remote agent
        self.tracer = None
        self.dispatch_log: List[tuple] = []
        self._relays: Dict[tuple, tuple] = {}
        # ------------------------- materialized views (watch-invalidated)
        self._clusters: Dict[str, dict] = {}
        self._telemetry: Dict[str, dict] = {}
        self._cur_load: Dict[str, float] = {}
        self._load_order: List[Tuple[float, str]] = []   # sorted (load, name)
        self._caps_index: Dict[str, Set[str]] = {}
        self._placement: Dict[str, dict] = {}
        self._jobs_by_cluster: Dict[str, Set[str]] = {}
        self._status: Dict[str, dict] = {}
        self._running: Set[str] = set()
        self._queue_depth: Dict[str, dict] = {}
        self._retired: Set[str] = set()     # retired in absentia, unconfirmed
        self._straggler_rules: Dict[str, RoutingRule] = {}
        self._down_callbacks: List[Callable[[str], None]] = []
        # failure detector + view maintenance: subscribe (batch form) before
        # any registration so the views never miss an event. Registration
        # order is load-bearing under coalesced delivery: batches flush in
        # registration order, and a cluster tombstone's recovery side effect
        # reads the job/telemetry views — so those views must ingest their
        # slice of the flush round FIRST, or a job placed in the same round a
        # cluster dies would be invisible to recover_cluster_jobs and lost.
        overwatch.watch_batch("/jobs/", self._on_job_batch)
        overwatch.watch_batch("/telemetry/", self._on_telemetry_batch)
        overwatch.watch_batch("/queues/", self._on_queue_batch)
        overwatch.watch_batch("/clusters/", self._on_cluster_batch)
        self._seed_views()

    # ----------------------------------------------------------- view maintenance
    def _seed_views(self) -> None:
        """Replay pre-existing state (no-op when, as usual, the dispatcher is
        created before any cluster registers)."""
        for key, val in self.ow.handle(
                {"op": "range", "prefix": "/clusters/"})["items"].items():
            self._cluster_put(key.split("/")[-1], val)
        for key, val in self.ow.handle(
                {"op": "range", "prefix": "/telemetry/"})["items"].items():
            self._telemetry_put(key.split("/")[-1], val)
        for key, val in self.ow.handle(
                {"op": "range", "prefix": "/jobs/"})["items"].items():
            self._job_put(key, val)
        for key, val in self.ow.handle(
                {"op": "range", "prefix": "/queues/"})["items"].items():
            self._queue_depth[key[len("/queues/"):]] = val

    def _cluster_put(self, name: str, info: dict) -> None:
        old = self._clusters.get(name)
        if old is not None:
            for cap in old.get("capabilities", ()):
                self._caps_index.get(cap, set()).discard(name)
        else:
            load = self._telemetry.get(name, {}).get("load", 0.0)
            self._cur_load[name] = load
            bisect.insort(self._load_order, (load, name))
        self._clusters[name] = info
        for cap in info.get("capabilities", ()):
            self._caps_index.setdefault(cap, set()).add(name)

    def _cluster_del(self, name: str) -> None:
        info = self._clusters.pop(name, None)
        if info is None:
            return
        for cap in info.get("capabilities", ()):
            self._caps_index.get(cap, set()).discard(name)
        self._load_order_discard(name)

    def _load_order_discard(self, name: str) -> None:
        load = self._cur_load.pop(name, None)
        if load is None:
            return
        i = bisect.bisect_left(self._load_order, (load, name))
        if i < len(self._load_order) and self._load_order[i] == (load, name):
            del self._load_order[i]

    def _telemetry_put(self, name: str, tele: dict) -> None:
        self._telemetry[name] = tele
        if name in self._clusters:
            self._load_order_discard(name)
            load = tele.get("load", 0.0)
            self._cur_load[name] = load
            bisect.insort(self._load_order, (load, name))

    def _on_cluster_batch(self, events: List[tuple]) -> None:
        for event, key, value, _rev in events:
            cluster = key.split("/")[-1]
            if event == "put":
                self._cluster_put(cluster, value)
                continue
            if event != "delete":
                continue
            self._cluster_del(cluster)
            for cb in self._down_callbacks:
                cb(cluster)
            self.recover_cluster_jobs(cluster)

    def _on_telemetry_batch(self, events: List[tuple]) -> None:
        for event, key, value, _rev in events:
            cluster = key.split("/")[-1]
            if event == "put":
                self._telemetry_put(cluster, value)
            elif event == "delete":
                self._telemetry.pop(cluster, None)
                if cluster in self._clusters:
                    self._load_order_discard(cluster)
                    self._cur_load[cluster] = 0.0
                    bisect.insort(self._load_order, (0.0, cluster))

    def _job_put(self, key: str, value: dict) -> None:
        parts = key.split("/")
        if len(parts) != 4:
            return
        _, _, jid, leaf = parts
        if leaf == "status" and jid in self._retired:
            # a retired-in-absentia pod's agent is talking again (partition
            # healed before its lease expired): finish the retirement —
            # re-send the retire and re-tombstone the key it just re-put —
            # instead of letting the zombie repopulate the views forever
            cluster = value.get("cluster")
            if cluster is not None and cluster in self._clusters:
                try:
                    self._send_agent(cluster,
                                     {"kind": "retire", "job_id": jid})
                    self._retired.discard(jid)
                except DeliveryError:
                    pass
            self.ow.handle({"op": "delete", "key": key})
            return
        if leaf == "placement":
            old = self._placement.get(jid)
            if old is not None:
                self._jobs_by_cluster.get(old["cluster"], set()).discard(jid)
            self._placement[jid] = value
            self._jobs_by_cluster.setdefault(value["cluster"], set()).add(jid)
        elif leaf == "status":
            self._status[jid] = value
            if value.get("status") == "running":
                self._running.add(jid)
            else:
                self._running.discard(jid)
            if value.get("status") == "done":
                self._gc_straggler_rule(jid)

    def _on_job_batch(self, events: List[tuple]) -> None:
        for event, key, value, _rev in events:
            if event == "put":
                self._job_put(key, value)
                continue
            parts = key.split("/")
            if len(parts) != 4:
                continue
            _, _, jid, leaf = parts
            if leaf == "placement":
                old = self._placement.pop(jid, None)
                if old is not None:
                    self._jobs_by_cluster.get(old["cluster"],
                                              set()).discard(jid)
            elif leaf == "status":
                self._status.pop(jid, None)
                self._running.discard(jid)

    def _on_queue_batch(self, events: List[tuple]) -> None:
        for event, key, value, _rev in events:
            queue = key[len("/queues/"):]
            if event == "put":
                self._queue_depth[queue] = value
            elif event == "delete":
                self._queue_depth.pop(queue, None)

    def _gc_straggler_rule(self, jid: str) -> None:
        """Satellite fix: straggler rules used to accumulate forever, slowing
        ``candidates()`` for every future job. Drop the rule once the
        re-dispatched job completes."""
        rule = self._straggler_rules.pop(jid, None)
        if rule is not None:
            try:
                self.rules.remove(rule)
            except ValueError:
                pass

    # ---------------------------------------------------------------- directories
    def clusters(self) -> Dict[str, dict]:
        self.ow.flush_watches()              # read barrier for the views
        return dict(self._clusters)

    def telemetry(self) -> Dict[str, dict]:
        self.ow.flush_watches()
        return dict(self._telemetry)

    def queue_depths(self) -> Dict[str, dict]:
        self.ow.flush_watches()
        return dict(self._queue_depth)

    def job_status(self, job_id: str) -> Optional[dict]:
        """The job's last reported status, straight from the watch view."""
        self.ow.flush_watches()
        return self._status.get(job_id)

    def placement_of(self, job_id: str) -> Optional[dict]:
        """The job's placement record, straight from the watch view."""
        self.ow.flush_watches()
        return self._placement.get(job_id)

    def placements(self) -> Dict[str, dict]:
        """Every live placement record (job_id -> record) — the recovered
        autoscaler's adoption view: placements are the only surviving truth
        about which worker-pod jobs existed before a master crash."""
        self.ow.flush_watches()
        return dict(self._placement)

    def _agent_addr(self, cluster: str):
        return tuple(self._clusters[cluster]["agent_addr"])

    # ----------------------------------------------------------------- CRD pubsub
    def broadcast_spec(self, spec, master_state) -> None:
        """The pubsub publisher: push the CRD to every registered agent."""
        self.ow.flush_watches()
        # one Envelope for the whole fan-out: the message is identical per
        # cluster, so the AppSpec walk for byte accounting happens once, not
        # O(clusters) times
        msg = Envelope({"kind": "configure", "spec": spec,
                        "master_state": master_state})
        for cluster in list(self._clusters):
            try:
                self._send_agent(cluster, msg)
            except DeliveryError:
                # partitioned but not yet tombstoned: skip it — the lease
                # sweep will deregister it, and a broadcast must never be
                # hostage to one unreachable cluster (elastic fleets
                # re-broadcast the spec on every pod change)
                continue

    def send_agent(self, cluster: str, msg: dict) -> dict:
        """Public master->agent RPC over the dispatch relay (the replica
        shipper's path). Raises ``KeyError`` for an unknown/tombstoned
        cluster and ``DeliveryError`` when the relay is unreachable."""
        return self._send_agent(cluster, msg)

    def _send_agent(self, cluster: str, msg: dict) -> dict:
        info = self._clusters[cluster]          # one lookup, zero round-trips
        addr = tuple(info["agent_addr"])
        if cluster == self.master:              # single hop: no Envelope copy
            return self.fabric.send(self.master, "system@dispatcher",
                                    cluster, addr, msg)
        # master -> private agent rides the lazily-created dispatch relay
        # (multiple hops: size the envelope once)
        if not isinstance(msg, Envelope):
            msg = Envelope(msg)
        return self.fabric.send(self.master, "system@dispatcher", self.master,
                                self._master_relay(cluster, info["idx"], addr),
                                msg)

    def _master_relay(self, cluster: str, idx: int, agent_addr) -> tuple:
        """Lazily create the master->agent dispatch channel (initialization).
        A channel already terminating at the relay address is reused — a
        dispatcher rebuilt by crash recovery rides its predecessor's tunnels
        instead of stacking duplicates."""
        key = ("dispatch-relay", cluster)
        if key not in self._relays:
            local = (f"10.200.0.{idx}", 6100)
            if self.fabric.channel_at(self.master, local) is None:
                self.fabric.create_channel(self.master, local, cluster,
                                           agent_addr)
            self._relays[key] = local
        return self._relays[key]

    # ------------------------------------------------------------------- dispatch
    def add_rule(self, rule: RoutingRule) -> None:
        self.rules.append(rule)

    def _eligible(self, needs: Set[str],
                  matched_rules: List[RoutingRule]) -> Set[str]:
        if needs:
            sets = [self._caps_index.get(cap, set()) for cap in needs]
            cands = set.intersection(*sets) if sets else set(self._clusters)
        else:
            cands = set(self._clusters)
        for rule in matched_rules:
            cands &= set(rule.clusters)
        return cands

    def candidates(self, job: dict) -> List[str]:
        self.ow.flush_watches()
        needs = set(job.get("tags", {}).get("requires", ()))
        return sorted(self._eligible(
            needs, [r for r in self.rules if r.match(job)]))

    def pick(self, job: dict) -> Optional[str]:
        self.ow.flush_watches()
        needs = set(job.get("tags", {}).get("requires", ()))
        matched = [r for r in self.rules if r.match(job)]
        return self._pick(needs, matched,
                          job.get("tags", {}).get("queues", ()),
                          job.get("tags", {}).get("cost_class"))

    def _min_load_hi(self) -> int:
        """End index of the least-loaded tie block: the contiguous,
        name-sorted front of ``_load_order`` — O(log n). 0 when no cluster
        is registered."""
        if not self._load_order:
            return 0
        min_load = self._load_order[0][0]
        return bisect.bisect_right(self._load_order, (min_load, "\U0010ffff"))

    def _pick(self, needs: Set[str], matched: List[RoutingRule],
              queue_pref=(), cost_class: Optional[str] = None
              ) -> Optional[str]:
        # roofline steering: a job tagged with a cost class prefers clusters
        # whose capability profile matches its tier (accel for compute/
        # memory-bound, cheap-io for IO-bound). Soft preference only — with
        # no matching tier registered, placement degrades to the depth/load
        # logic below, and an untagged job is byte-identical to today.
        pref_cap = None
        if cost_class is not None:
            from repro_torch.roofline.cost import steering_cap
            pref_cap = steering_cap(cost_class)
        if queue_pref:
            # worker-pod job: deepest matching backlog wins, least-load breaks
            # ties (and carries the decision when no depth is published yet).
            # Queue names ARE capability sets (see ``scheduler.queue_for``):
            # decode each preferred queue's tags + ready depth once, then the
            # per-cluster loop is just a subset test and a sum.
            cands = self._eligible(needs, matched)
            if not cands:
                return None
            pref = []
            for q in queue_pref:
                ready = self._queue_depth.get(q, {}).get("ready", 0)
                if ready:
                    pref.append((set(q.split(",")) if q != "default"
                                 else set(), ready))
            best: List[str] = []
            best_key = None
            for name in sorted(cands):
                caps = set(self._clusters[name].get("capabilities", ()))
                score = sum(r for tags, r in pref if tags <= caps)
                # depth first; tier match breaks depth ties (cold start: no
                # depth published yet steers by profile alone); then load
                key = (-score,
                       0 if pref_cap is None or pref_cap in caps else 1,
                       self._cur_load.get(name, 0.0))
                if best_key is None or key < best_key:
                    best_key, best = key, [name]
                elif key == best_key:
                    best.append(name)
            return best[next(self._rr) % len(best)]
        if pref_cap is not None:
            cands = self._eligible(needs, matched)
            tier = cands & self._caps_index.get(pref_cap, set())
            if tier and tier != cands:
                # least-load within the matching tier
                best, best_load = [], None
                for load, name in self._load_order:
                    if name not in tier:
                        continue
                    if best_load is None:
                        best_load = load
                    elif load != best_load:
                        break
                    best.append(name)
                return best[next(self._rr) % len(best)]
        if not needs and not matched:
            # unconstrained job: every cluster is eligible — index the tie
            # block directly, no list materialization on the per-job path
            hi = self._min_load_hi()
            if not hi:
                return None
            return self._load_order[next(self._rr) % hi][1]
        cands = self._eligible(needs, matched)
        if not cands:
            return None
        # walk the load-ordered structure: the first eligible entry carries the
        # minimum load; ties are adjacent and already name-sorted
        best: List[str] = []
        best_load: Optional[float] = None
        for load, name in self._load_order:
            if name not in cands:
                continue
            if best_load is None:
                best_load = load
            elif load != best_load:
                break
            best.append(name)
        # cands is a subset of _clusters and _load_order mirrors _clusters,
        # so the walk always finds at least one entry
        return best[next(self._rr) % len(best)]

    def _trace_root(self, job: dict):
        """Root span for a sampled job submission (None when untraced)."""
        tr = self.tracer
        if tr is None:
            return None
        tid = f"job/{job['job_id']}"
        if not tr.sampled(tid):
            return None
        return tr.open_span("job", "dispatcher", trace_id=tid)

    def submit(self, job: dict) -> str:
        root = self._trace_root(job)
        try:
            cluster = self.pick(job)
            if cluster is None:
                raise RuntimeError(
                    f"no eligible cluster for job {job['job_id']} "
                    f"(requires {job.get('tags', {})})")
            self._dispatch_to(cluster, job, _root=root)
            return cluster
        finally:
            if root is not None:
                self.tracer.end_span(root)

    def dispatch_to(self, cluster: str, job: dict) -> None:
        """Public placement-decided dispatch: the caller picked the cluster
        (e.g. the autoscaler, which needs to know WHICH cluster an
        unreachable dispatch was aimed at so it can exclude it and retry)."""
        self._dispatch_to(cluster, job)

    def _dispatch_to(self, cluster: str, job: dict, _root=None) -> None:
        """Placement already decided: ship the job and record the placement.
        Traced submissions attach the dispatch span's context to the
        envelope; without a caller-held root (``dispatch_to``/
        ``submit_many``) a sampled job gets its own root here."""
        tr = self.tracer
        msg = {"kind": "dispatch", "job": job}
        sp = owned = None
        if tr is not None:
            if _root is None:
                _root = owned = self._trace_root(job)
            if _root is not None:
                sp = tr.open_span("dispatch", "dispatcher", parent=_root,
                                  attrs={"cluster": cluster})
                msg["trace"] = sp
        try:
            resp = self._send_agent(cluster, msg)
            if not resp.get("ok"):
                raise RuntimeError(f"dispatch failed: {resp.get('error')}")
            self.ow.handle(
                {"op": "put", "key": f"/jobs/{job['job_id']}/placement",
                 "value": {"cluster": cluster, "job": job,
                           "clock": self.fabric.clock}})
            self.dispatch_log.append(
                (self.fabric.clock, job["job_id"], cluster))
        finally:
            if sp is not None:
                tr.end_span(sp)
            if owned is not None:
                tr.end_span(owned)

    def submit_many(self, jobs: List[dict]) -> List[str]:
        """Batched admission: amortize ``pick()`` over the batch.

        The min-load block at the front of ``_load_order`` is computed once;
        unconstrained jobs round-robin across it with no per-job re-probe
        (telemetry cannot move mid-batch — loads only change via heartbeats,
        which land between fabric ticks). Constrained jobs (capability tags,
        matching routing rules, or a queue-depth placement preference) fall
        back to a per-job ``pick()``. Returns the chosen cluster per job, in
        submission order.
        """
        self.ow.flush_watches()
        placed: List[str] = []
        block: Optional[List[str]] = None
        for job in jobs:
            needs = set(job.get("tags", {}).get("requires", ()))
            matched = [r for r in self.rules if r.match(job)]
            queue_pref = job.get("tags", {}).get("queues", ())
            cost_class = job.get("tags", {}).get("cost_class")
            if not needs and not matched and not queue_pref \
                    and cost_class is None:
                while True:
                    if block is None:
                        hi = self._min_load_hi()
                        if not hi:
                            raise RuntimeError(
                                f"no eligible cluster for job {job['job_id']}")
                        block = [name for _, name in self._load_order[:hi]]
                    cluster = block[next(self._rr) % len(block)]
                    if cluster in self._clusters:
                        break
                    # a cluster died mid-batch (lease swept by one of our own
                    # placement puts, sync-notify mode): drop the stale block
                    # and re-probe
                    block = None
            else:
                cluster = self._pick(needs, matched, queue_pref, cost_class)
                if cluster is None:
                    raise RuntimeError(
                        f"no eligible cluster for job {job['job_id']} "
                        f"(requires {job.get('tags', {})})")
            try:
                self._dispatch_to(cluster, job)
            except DeliveryError:
                # under coalesced delivery the death of a cluster mid-batch is
                # only a pending tombstone, invisible to the membership check
                # above — the dispatch itself fails instead. Take the barrier,
                # re-place this one job on the refreshed views, and keep the
                # rest of the batch going. Only unreachability retries: an
                # agent-side rejection (RuntimeError) is job-intrinsic and
                # propagates exactly as submit() would — already-placed jobs
                # of the batch stay placed.
                self.ow.flush_watches()
                block = None
                cluster = self._pick(needs, matched, queue_pref, cost_class)
                if cluster is None:
                    raise RuntimeError(
                        f"no eligible cluster for job {job['job_id']} "
                        f"(requires {job.get('tags', {})})")
                self._dispatch_to(cluster, job)
            placed.append(cluster)
        return placed

    def retire(self, job_id: str) -> bool:
        """Gracefully retire a placed job (the autoscaler's scale-down path):
        the hosting agent stops it, then the job's ``/jobs/<id>`` placement
        and status records are DELETED — unlike ``cancel``, retirement never
        reads as a failure, and unlike completion it leaves no store records
        behind, so recovery/stragglers can never resurrect a retired pod and
        elastic churn (fleets scaling 0 -> N -> 0 forever) cannot leak keys
        or view entries. If the hosting cluster is unreachable the records
        are still tombstoned ("retired in absentia"): with no placement on
        file, the eventual cluster-death recovery skips the job. Returns
        False only when the job has no placement at all (already gone —
        retirement is idempotent)."""
        self.ow.flush_watches()
        placement = self._placement.get(job_id)
        if placement is None:
            return False
        cluster = placement["cluster"]
        confirmed = False
        if cluster in self._clusters:
            try:
                self._send_agent(cluster, {"kind": "retire",
                                           "job_id": job_id})
                confirmed = True
            except DeliveryError:
                pass                     # in absentia: tombstones still land
        if not confirmed:
            # the agent never heard the retire: if its partition heals before
            # the lease sweep, its next heartbeat re-puts the status key —
            # _job_put watches for that and finishes the retirement then
            self._retired.add(job_id)
        self.ow.handle({"op": "delete", "key": f"/jobs/{job_id}/placement"})
        self.ow.handle({"op": "delete", "key": f"/jobs/{job_id}/status"})
        self.ow.handle({"op": "delete", "key": f"/checkpoints/{job_id}"})
        return True

    # ----------------------------------------------------------- failure handling
    def on_cluster_down(self, cb: Callable[[str], None]) -> None:
        self._down_callbacks.append(cb)

    def recover_cluster_jobs(self, dead: str) -> List[str]:
        """Re-dispatch every job placed on a dead cluster from its last committed
        checkpoint manifest. Uses the per-cluster placement index: cost scales
        with the dead cluster's jobs, not the whole /jobs/ keyspace."""
        self.ow.flush_watches()
        moved = []
        for jid in sorted(self._jobs_by_cluster.get(dead, set())):
            placement = self._placement.get(jid)
            if placement is None:
                continue
            status = self._status.get(jid)
            if status and status.get("status") == "done":
                continue
            job = dict(placement["job"])
            ck = self.ow.handle({"op": "get",
                                 "key": f"/checkpoints/{jid}"})["value"]
            if ck:
                job["restore_from"] = ck
            try:
                new_cluster = self.submit(job)
                moved.append(f"{jid}->{new_cluster}")
            except (RuntimeError, DeliveryError):
                self.ow.handle({"op": "put", "key": f"/jobs/{jid}/status",
                                "value": {"cluster": None, "status": "pending",
                                          "progress": 0.0, "rate": 0.0,
                                          "clock": self.fabric.clock}})
        return moved

    # -------------------------------------------------------- straggler mitigation
    def check_stragglers(self) -> List[str]:
        """Compare per-job step rates; re-dispatch jobs below factor x median.
        Scans the running-jobs view only — no /jobs/ range round-trip."""
        self.ow.flush_watches()
        rates = {}
        for jid in sorted(self._running):
            val = self._status.get(jid)
            if val is not None:
                rates[jid] = (val.get("rate", 0.0), val["cluster"])
        if len(rates) < 2:
            return []
        rs = sorted(r for r, _ in rates.values())
        median = rs[len(rs) // 2]
        moved = []
        for jid, (rate, cluster) in rates.items():
            if median > 0 and rate < self.straggler_factor * median:
                placement = self._placement.get(jid)
                if placement is None:
                    continue
                job = dict(placement["job"])
                ck = self.ow.handle({"op": "get",
                                     "key": f"/checkpoints/{jid}"})["value"]
                if ck:
                    job["restore_from"] = ck
                # exclude the slow cluster, cancel there, re-dispatch; one rule
                # per job, GC'd on completion (see _gc_straggler_rule). A job
                # straggling again folds the new exclusion into the replacement
                # rule instead of orphaning the old one in self.rules
                prev = self._straggler_rules.get(jid)
                eligible = (prev.clusters if prev is not None
                            else list(self._clusters))
                self._gc_straggler_rule(jid)
                rule = RoutingRule(
                    name=f"straggler-{jid}",
                    match=lambda j, _jid=jid: j["job_id"] == _jid,
                    clusters=[c for c in eligible if c != cluster])
                self.add_rule(rule)
                self._straggler_rules[jid] = rule
                try:
                    self._send_agent(cluster, {"kind": "cancel", "job_id": jid})
                    new_cluster = self.submit(job)
                    moved.append(f"{jid}:{cluster}->{new_cluster}")
                except (RuntimeError, DeliveryError):
                    pass
        return moved
