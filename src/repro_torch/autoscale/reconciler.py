"""Copy of ``repro.autoscale.reconciler`` under ``repro_torch``.

The autoscaling control loop: diff desired vs. actual worker-pod fleets.

One :class:`Reconciler` runs beside the dispatcher on the master (global)
plane. Each ``reconcile()`` pass, per policy family:

  1. **Observe** — read the watch-materialized ``/queues/<name>`` depth view
     (``dispatcher.queue_depths()``, which takes the read barrier) and sum
     the ready backlog of the family's queues.
  2. **Sync inventory** — reconcile the in-memory pod table against the
     overwatch truth: a pod whose job lost its placement, moved clusters
     (recovery), terminated, or sits on a deregistered cluster is forgotten
     (its leased tasks are redelivered by broker lease expiry — at-least-once
     under failures, exactly-once under graceful operations).
  3. **Decide** — ``policy.desired_replicas(backlog, live)`` with the
     reconciler enforcing the per-direction cooldowns (cold starts from zero
     bypass the up-cooldown).
  4. **Act** — scale up by submitting worker-pod jobs through the
     dispatcher's depth-aware placement, restricted by a per-family routing
     rule to the clusters currently under quota (preferred clusters first,
     spilling over into the rest when the preferred tier is full); scale
     down by draining victims (spillover clusters first, newest pods first)
     through the worker drain protocol, then retiring their jobs.
  5. **Publish** — write the fleet state under ``/autoscale/<family>``
     whenever it changed, so operators (and tests) watch the trajectory the
     same way they watch any other overwatch directory.

The reconciler touches clusters only through the dispatcher (submit/retire)
and the composer (materializing/removing the local ``PipelineWorker``) —
never a cluster-direct RPC, keeping the paper's plane split intact.

Locality: every read in the loop — the depth view, cluster membership,
placements, statuses — is a watch-materialized dispatcher view, i.e.
master-LOCAL state maintained from the overwatch event stream; an inventory
sync never issues a cross-boundary round-trip. The published
``/autoscale/<family>`` state rides the replica fan-out (it is in
``REPLICA_PREFIXES``): remote observers READ fleet trajectories off their
cluster-local replica (``agent.fleet_states()``) and — the notify half —
SUBSCRIBE to them with :meth:`Reconciler.fleet_watch` / a ``ReplicaView``
over ``/autoscale/``, fed by the one shipped envelope per sweep; N observers
on a cluster cost the cross-boundary bytes of zero.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.autoscale.policy import ScalingPolicy
from repro_torch.core.dispatcher import RoutingRule
from repro_torch.core.transport import DeliveryError, RingLog

WORKER_POD_STEPS = 10 ** 9      # a worker pod runs until retired, never "done"


@dataclasses.dataclass
class PodRecord:
    name: str
    family: str
    cluster: str
    job_id: str
    worker: object                      # the materialized PipelineWorker
    seq: int
    state: str = "running"              # running | draining | drained


class Reconciler:
    def __init__(self, composer, policies: Sequence[ScalingPolicy],
                 quotas: Optional[Dict[str, int]] = None,
                 preferred: Tuple[str, ...] = (),
                 default_quota: Optional[int] = None,
                 every: float = 1.0,
                 events_limit: Optional[int] = 10_000):
        self.composer = composer
        self.plane = composer.plane
        self.dispatcher = self.plane.dispatcher
        self.policies: Dict[str, ScalingPolicy] = {}
        for p in policies:
            if p.family in self.policies:
                raise ValueError(f"duplicate policy family {p.family!r}")
            self.policies[p.family] = p
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota      # None = unlimited
        self.preferred = tuple(preferred)
        self.every = every
        self.pods: Dict[str, Dict[str, PodRecord]] = {
            f: {} for f in self.policies}
        # (clock, family, action, pod, cluster) — bounded like every other
        # long-lived log in the plane (fabric message_log, overwatch op_log)
        self.events: RingLog = RingLog(events_limit)
        self._seq = itertools.count(1)
        self._last_up: Dict[str, float] = {}
        self._last_down: Dict[str, float] = {}
        self._last_published: Dict[str, dict] = {}
        self._reconciled_at: Optional[float] = None
        # one routing rule per family: restricts worker-pod jobs to the
        # clusters currently under quota; the cluster list is rewritten in
        # place before every submit, so the dispatcher's depth-aware pick
        # chooses WITHIN the quota envelope
        self._rules: Dict[str, RoutingRule] = {}
        for family in self.policies:
            rule = RoutingRule(
                name=f"autoscale-{family}",
                match=lambda job, _f=family: (
                    job.get("tags", {}).get("family") == _f),
                clusters=[])
            self.dispatcher.add_rule(rule)
            self._rules[family] = rule

    # ------------------------------------------------------------ the main loop
    def reconcile(self, force: bool = False) -> None:
        """One pass over every family; rate-limited to ``every`` clock units
        (``force=True`` skips the cadence check — tests and drains)."""
        now = self.plane.fabric.clock
        if (not force and self._reconciled_at is not None
                and now - self._reconciled_at < self.every):
            return
        self._reconciled_at = now
        depths = self.dispatcher.queue_depths()
        for family in sorted(self.policies):
            self._reconcile_family(family, depths, now)
        # ONE AppSpec re-broadcast per pass, however many pods changed —
        # spawned workers only start ticking after this reconcile returns,
        # so deferring the DNS/ACL rebuild to here is safe and turns a
        # scale step of N from N broadcasts into one
        self.composer.flush_spec()

    def _reconcile_family(self, family: str, depths: Dict[str, dict],
                          now: float) -> None:
        policy = self.policies[family]
        self._sync_inventory(family, now)
        live = [r for r in self.pods[family].values() if r.state == "running"]
        current = len(live)
        backlog = sum(depths.get(q, {}).get("ready", 0)
                      for q in policy.queues)
        desired = policy.desired_replicas(backlog, current)
        blocked = None                   # None | "at_quota" | "unreachable"
        if desired > current:
            cold = current == 0
            last = self._last_up.get(family)
            if cold or last is None or now - last >= policy.up_cooldown:
                spawned = 0
                for _ in range(desired - current):
                    cluster, blocked = self._spawn(family, policy, now)
                    if cluster is None:
                        break
                    spawned += 1
                if spawned:
                    self._last_up[family] = now
        elif desired < current:
            last = self._last_down.get(family)
            if last is None or now - last >= policy.down_cooldown:
                for rec in self._pick_victims(live, current - desired):
                    self._drain(rec, now)
                self._last_down[family] = now
        self._publish(family, policy, desired, backlog, blocked, now)

    # ------------------------------------------------------------- inventory
    def _sync_inventory(self, family: str, now: float) -> None:
        """Reconcile the pod table against overwatch placements: the actual
        side of the desired-vs-actual diff is what the global plane can SEE,
        not what this process remembers."""
        clusters = self.dispatcher.clusters()
        for name, rec in list(self.pods[family].items()):
            if rec.state != "running":
                continue
            placement = self.dispatcher.placement_of(rec.job_id)
            status = self.dispatcher.job_status(rec.job_id)
            gone = (
                placement is None
                or placement["cluster"] != rec.cluster   # recovery moved it
                or rec.cluster not in clusters           # cluster dead
                or (status or {}).get("status") in ("failed", "done"))
            if not gone:
                continue
            # forget the pod: its leased tasks redeliver via broker lease
            # expiry. Retire the job unconditionally (idempotent): if
            # recovery re-placed it elsewhere that zombie is stopped, and
            # either way its /jobs records are tombstoned so lost pods never
            # leak store keys or resurrect via a healed agent's heartbeat
            if placement is not None:
                self.dispatcher.retire(rec.job_id)
            self.composer.remove_worker(rec.worker, broadcast=False)
            del self.pods[family][name]
            self.events.append((now, family, "lost", name, rec.cluster))

    def _quota(self, cluster: str) -> Optional[int]:
        return self.quotas.get(cluster, self.default_quota)

    def _pod_counts(self) -> Counter:
        counts: Counter = Counter()
        for fam in self.pods.values():
            for rec in fam.values():
                if rec.state == "running":
                    counts[rec.cluster] += 1
        return counts

    def _eligible_clusters(self, policy: ScalingPolicy) -> List[str]:
        """Capability-eligible clusters for this family's pods (no quotas)."""
        needs = set(policy.requires)
        return [c for c, info in self.dispatcher.clusters().items()
                if needs <= set(info.get("capabilities", ()))]

    def allowed_clusters(self, policy: ScalingPolicy) -> List[str]:
        """Clusters a new pod of this family may land on right now:
        capability-eligible AND under quota, preferred tier first — the
        spillover decision. Empty means every eligible cluster is at quota
        (or nothing is eligible at all — see ``_spawn``'s blocked reason)."""
        eligible = self._eligible_clusters(policy)
        counts = self._pod_counts()
        under = [c for c in eligible
                 if self._quota(c) is None or counts[c] < self._quota(c)]
        pref = [c for c in under if c in self.preferred]
        return sorted(pref or under)

    # ----------------------------------------------------------------- actions
    def _spawn(self, family: str, policy: ScalingPolicy,
               now: float) -> Tuple[Optional[str], Optional[str]]:
        """One pod: returns ``(cluster, None)`` on success, else
        ``(None, reason)`` with reason ``"at_quota"`` (every eligible cluster
        is at capacity) or ``"unreachable"`` (placement targets exist but
        none could be dispatched to — e.g. partitioned while still leased)."""
        allowed = self.allowed_clusters(policy)
        if not allowed:
            # distinguish "everything eligible is full" from "nothing is
            # eligible at all" (missing capability / no registered cluster)
            return None, ("at_quota" if self._eligible_clusters(policy)
                          else "no_eligible_cluster")
        seq = next(self._seq)
        name = f"wp-{family}-{seq}"
        tags = {"requires": list(policy.requires),
                "queues": list(policy.queues), "family": family}
        if policy.cost_class is not None:
            # the dispatcher's cost-class steering covers the cold start,
            # when the family's queues have no published depth yet
            tags["cost_class"] = policy.cost_class
        job = {"job_id": name, "kind": "worker-pod", "arch": "",
               "steps": WORKER_POD_STEPS, "tags": tags, "payload": {}}
        # Pick-then-dispatch so an unreachable cluster (partitioned while its
        # registration lease is still live) can be EXCLUDED and the pick
        # re-run over the survivors — a plain retry could re-pick the same
        # cluster forever when it uniquely wins the depth score. Gives up
        # gracefully (next pass retries; the lease sweep deregisters the
        # cluster within its TTL) rather than crash the composer tick.
        rule = self._rules[family]
        tried: set = set()
        cluster = None
        try:
            while cluster is None:
                avail = [c for c in allowed if c not in tried]
                if not avail:
                    self.events.append((now, family, "spawn_failed",
                                        name, None))
                    return None, "unreachable"
                rule.clusters[:] = avail
                picked = self.dispatcher.pick(job)
                if picked is None:
                    self.events.append((now, family, "spawn_failed",
                                        name, None))
                    return None, "unreachable"
                try:
                    self.dispatcher.dispatch_to(picked, job)
                    cluster = picked
                except DeliveryError:
                    tried.add(picked)
        finally:
            # leave the rule capability-wide, not frozen at this spawn's
            # quota snapshot: dispatcher recovery re-places a dead cluster's
            # worker-pod jobs through the same rule, and a stale one-cluster
            # list would park them as unplaceable
            rule.clusters[:] = sorted(self._eligible_clusters(policy))
        worker = self.composer.add_worker(name, cluster, queues=policy.queues,
                                          broadcast=False)
        self.pods[family][name] = PodRecord(
            name=name, family=family, cluster=cluster, job_id=name,
            worker=worker, seq=seq)
        self.events.append((now, family, "scale_up", name, cluster))
        return cluster, None

    def _pick_victims(self, live: List[PodRecord], n: int) -> List[PodRecord]:
        """Retreat from the spillover tier first (non-preferred clusters),
        newest pods first within a tier."""
        ranked = sorted(live, key=lambda r: (r.cluster in self.preferred,
                                             -r.seq))
        return ranked[:n]

    def _drain(self, rec: PodRecord, now: float) -> None:
        rec.state = "draining"
        worker = rec.worker

        def finished(_w, _rec=rec, _now=now):
            _rec.state = "drained"
            self.dispatcher.retire(_rec.job_id)
            self.composer.remove_worker(_rec.worker, broadcast=False)
            self.pods[_rec.family].pop(_rec.name, None)
            self.events.append((_now, _rec.family, "scale_down",
                                _rec.name, _rec.cluster))

        worker.on_drained = finished
        try:
            worker.drain()
        except DeliveryError:
            # the pod's cluster went unreachable mid-drain: the graceful path
            # is gone — any uncommitted leases redeliver on expiry (back to
            # at-least-once, like a worker death). Retire in absentia and
            # forget the pod instead of leaving it stuck in "draining".
            worker.on_drained = None
            worker.state = "drained"
            self.dispatcher.retire(rec.job_id)
            self.composer.remove_worker(worker, broadcast=False)
            self.pods[rec.family].pop(rec.name, None)
            self.events.append((now, rec.family, "lost",
                                rec.name, rec.cluster))

    # ---------------------------------------------------------- crash adoption
    def adopt(self, workers) -> int:
        """Rebuild the pod table after a master crash: overwatch placements
        (recovered from the WAL) are the only surviving truth about which
        worker-pod jobs existed, and the composer's surviving
        ``PipelineWorker`` objects are the pods themselves. Match them by pod
        name (``wp-<family>-<seq>``), resume the sequence counter past the
        highest adopted seq (never reuse a live pod's name), finish any drain
        the crash interrupted, and retire orphan placements whose worker is
        gone. Returns the number of pods adopted as running."""
        now = self.plane.fabric.clock
        by_pod = {w.pod: w for w in workers}
        adopted = 0
        max_seq = 0
        for jid, placement in sorted(self.dispatcher.placements().items()):
            job = placement.get("job", {})
            if job.get("kind") != "worker-pod":
                continue
            family = job.get("tags", {}).get("family")
            if family not in self.pods:
                continue
            try:
                seq = int(jid.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            max_seq = max(max_seq, seq)
            worker = by_pod.get(jid)
            if worker is None or worker.state == "drained":
                # the pod is gone (or finished draining mid-crash, before its
                # retirement landed): tombstone the job records
                self.dispatcher.retire(jid)
                if worker is not None:
                    self.composer.remove_worker(worker, broadcast=False)
                continue
            rec = PodRecord(name=jid, family=family,
                            cluster=placement["cluster"], job_id=jid,
                            worker=worker, seq=seq)
            self.pods[family][jid] = rec
            if worker.state == "draining":
                # the recovery barrier already retried its pending commit;
                # re-arm the drain closure (the crash cleared it) and finish
                self._drain(rec, now)
            else:
                adopted += 1
                self.events.append((now, family, "adopted", jid,
                                    rec.cluster))
        self._seq = itertools.count(max_seq + 1)
        return adopted

    # ------------------------------------------------------------ observability
    def _publish(self, family: str, policy: ScalingPolicy, desired: int,
                 backlog: float, blocked: Optional[str], now: float) -> None:
        pods = self.pods[family]
        state = {
            "desired": desired,
            "replicas": sum(1 for r in pods.values() if r.state == "running"),
            "draining": sum(1 for r in pods.values() if r.state == "draining"),
            "backlog": backlog,
            # why the fleet is below desired, if it is: quota exhaustion vs.
            # unreachable placement targets — an operator diagnosing capacity
            # must not be steered at a connectivity fault (or vice versa)
            "blocked": blocked,
            "at_quota": blocked == "at_quota",
            "max_replicas": policy.max_replicas,
            "pods": {r.name: r.cluster for r in pods.values()},
        }
        if state == self._last_published.get(family):
            return                      # coalesce-friendly: only deltas
        self._last_published[family] = state
        self.plane.master_agent.ow.put(f"/autoscale/{family}",
                                       {**state, "clock": now})

    @staticmethod
    def fleet_watch(agent, family: str, cb):
        """Subscribe a remote fleet-state observer on ``agent``'s cluster:
        ``cb(event, key, value, rev)`` fires for every published change to
        ``/autoscale/<family>`` off the cluster-local replica feed — the
        observer never dials the master, and any number of observers share
        the one shipped envelope per sweep. Raises on a cluster without a
        replica (fan-out off): there is deliberately NO silent cross-boundary
        fallback for subscriptions, only for reads."""
        return agent.watch_local(f"/autoscale/{family}", cb)

    def replicas(self, family: str) -> int:
        return sum(1 for r in self.pods[family].values()
                   if r.state == "running")
