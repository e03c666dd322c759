"""Copy of ``repro.core.faults`` under ``repro_torch``.

Deterministic fault injection: scripted crash/partition plans + the
crash-restart harness that drives them.

Crash model (what a "master crash" means here)
    The GLOBAL plane's services die: overwatch shards, lease table,
    dispatcher, replica shipper, brokers, taskdb, scheduler, autoscaler.
    Everything cluster-local survives — control agents, workers mid-lease,
    local replicas, gateway state — exactly the paper's split: local planes
    keep their state through master loss and resync after it returns. A crash
    additionally drops every ``LogStore``'s uncommitted tail
    (``lose_uncommitted()``) and partitions the master cluster so the outage
    window is visible to heartbeats; restart heals the partition and rebuilds
    every service from WAL + snapshots (``ManagementPlane.
    recover_global_plane()`` then ``HybridComposer.recover()``).

``CrashError`` deliberately subclasses ``BaseException``: production code
catches ``Exception``/``RuntimeError``/``DeliveryError`` in several retry
paths, and an injected crash must never be swallowed by any of them — only
the harness catches it.

Scripting a ``FaultPlan``
    A plan is an ordered list of ``FaultPoint``s, consumed head-first; each
    fires once when its trigger is reached and the next becomes active.
    Triggers (first match wins, all counted deterministically):

      * ``at_op=N``       — the Nth fabric delivery on the master cluster
                            (every service RPC and recovery replay counts, so
                            a second point can land mid-recovery-storm);
      * ``op_kind="x", hit=K`` — just before the Kth master delivery whose
                            payload ``op`` field equals ``x`` (e.g. crash
                            between a worker's ``pull_many`` and its
                            ``upsert_many`` by arming ``op_kind=
                            "upsert_many"``);
      * ``site="commit:taskdb", hit=K`` — the Kth time that LogStore
                            commit/snapshot boundary is reached, *before* it
                            persists (crash-mid-sweep with the tail still
                            volatile);
      * ``site="migrate:<shard>:<step>"`` — the Kth time the shard-map
                            coordinator reaches that live-migration step
                            (``freeze``/``transfer``/``flip``/``replay``),
                            fired BEFORE the step executes — the seam for
                            killing a master or splitting the fabric at every
                            protocol boundary.

    Actions: ``crash`` (default — raise ``CrashError``), ``partition`` /
    ``heal`` (flip ``cluster``'s connectivity, for partition-then-crash
    scripts), ``kill_master`` (crash ONE master fault domain via the
    injector's ``kill_master_fn`` hook — ``cluster`` names the master, e.g.
    ``"m1"``; the multi-master plane keeps serving on the survivors instead
    of dying wholesale). ``FaultPlan.seeded(seed, crashes=k)`` derives a
    reproducible crash-only schedule from one integer — the chaos matrix is
    a list of seeds.

Example::

    plan = FaultPlan([
        FaultPoint(action="partition", cluster="cloud-a", at_op=300),
        FaultPoint(at_op=500),                      # crash master
        FaultPoint(action="heal", cluster="cloud-a", at_op=900),
    ])
    harness = ChaosHarness(plane, composer, plan)
    assert harness.run(until=lambda: scheduler.dag_done("etl"))

The harness ticks the pipeline, catches each ``CrashError``, models the loss
(uncommitted WAL tails dropped, master partitioned), restarts the plane, and
keeps going until ``until()`` holds; ``harness.recoveries`` records per-crash
replay/reseed/wall-time metrics for the durability benchmark.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import Counter
from typing import Any, Callable, List, Optional


class CrashError(BaseException):
    """Injected process death. A BaseException so no service-level
    ``except Exception`` retry path can accidentally survive it."""


@dataclasses.dataclass
class FaultPoint:
    at_op: Optional[int] = None        # fire at the Nth master delivery
    op_kind: Optional[str] = None      # ...or before the Kth <op_kind> RPC
    site: Optional[str] = None         # ...or at a "commit:<shard>" boundary
    hit: int = 1                       # which occurrence (op_kind/site)
    action: str = "crash"              # crash | partition | heal | kill_master
    cluster: Optional[str] = None      # target for partition/heal/kill_master

    def describe(self) -> str:
        trig = (f"op>={self.at_op}" if self.at_op is not None else
                f"{self.op_kind or self.site}#{self.hit}")
        tgt = f" {self.cluster}" if self.cluster else ""
        return f"{self.action}{tgt}@{trig}"


class FaultPlan:
    """Ordered, single-shot fault schedule (head point is the armed one)."""

    def __init__(self, points: List[FaultPoint]):
        self.points: List[FaultPoint] = list(points)

    @classmethod
    def crash_at_ops(cls, *ops: int) -> "FaultPlan":
        return cls([FaultPoint(at_op=n) for n in sorted(ops)])

    @classmethod
    def crash_at_site(cls, site: str, hit: int = 1) -> "FaultPlan":
        return cls([FaultPoint(site=site, hit=hit)])

    @classmethod
    def seeded(cls, seed: int, crashes: int = 3, first: int = 200,
               span: int = 900) -> "FaultPlan":
        """Reproducible crash-only schedule: ``crashes`` points, the first in
        ``[first, first+span)``, each subsequent one a further ``[span/4,
        span)`` ops out — far enough apart to let recovery finish, close
        enough to hit different pipeline phases across seeds."""
        rng = random.Random(seed)
        ops, at = [], 0
        for i in range(crashes):
            lo = first if i == 0 else max(span // 4, 1)
            at += lo + rng.randrange(max(span - lo, 1))
            ops.append(at)
        return cls.crash_at_ops(*ops)


class FaultInjector:
    """Counts deterministic event streams and fires the plan's head point.

    Wired into two seams: ``fabric.on_deliver`` (every handler invocation on
    any cluster — only master-cluster deliveries advance the op counters) and
    ``LogStore.fault_hook`` (commit/snapshot boundaries). Both survive
    service rebuilds, so recovery traffic is counted too.
    """

    def __init__(self, plan: FaultPlan, fabric, master: str):
        self.plan = plan
        self.fabric = fabric
        self.master = master
        self.ops = 0                         # master-cluster deliveries
        self.op_kind_hits: Counter = Counter()
        self.site_hits: Counter = Counter()
        self.fired: List[tuple] = []
        # multi-master hook: set to ``plane.kill_master`` (or the
        # coordinator's) so ``action="kill_master"`` points can crash one
        # fault domain instead of the whole global plane
        self.kill_master_fn: Optional[Callable[[str], Any]] = None

    # ------------------------------------------------------------------ seams
    def on_deliver(self, cluster: str, addr, payload) -> None:
        if cluster != self.master:
            return
        self.ops += 1
        kind = payload.get("op") if isinstance(payload, dict) else None
        if kind:
            self.op_kind_hits[kind] += 1
        self._maybe_fire()

    def on_site(self, kind: str, shard: str) -> None:
        self.site_hits[f"{kind}:{shard}"] += 1
        self._maybe_fire()

    # ------------------------------------------------------------------ firing
    def _due(self, p: FaultPoint) -> bool:
        if p.at_op is not None:
            return self.ops >= p.at_op
        if p.op_kind is not None:
            return self.op_kind_hits[p.op_kind] >= p.hit
        if p.site is not None:
            return self.site_hits[p.site] >= p.hit
        return False

    def _maybe_fire(self) -> None:
        while self.plan.points and self._due(self.plan.points[0]):
            p = self.plan.points.pop(0)
            self.fired.append((p.describe(), self.ops))
            if p.action == "partition":
                self.fabric.partition_cluster(p.cluster)
            elif p.action == "heal":
                self.fabric.heal_cluster(p.cluster)
            elif p.action == "kill_master":
                if self.kill_master_fn is None:
                    raise CrashError(
                        f"injected {p.describe()} (no kill_master_fn wired)")
                self.kill_master_fn(p.cluster)
            else:
                raise CrashError(f"injected {p.describe()}")


class ChaosHarness:
    """Tick loop with scripted kill/restart of the global plane.

    ``plane`` must be durability-enabled (``ManagementPlane(durability=...)``)
    and ``composer`` (optional — control-plane-only scripts omit it) built
    over the same or its own ``LogStore``. ``downtime_ticks`` advances the
    fabric clock while the master is dead, so leases age and heartbeats miss
    realistically before recovery begins.
    """

    def __init__(self, plane, composer=None, plan: Optional[FaultPlan] = None,
                 downtime_ticks: int = 0):
        self.plane = plane
        self.composer = composer
        self.downtime_ticks = downtime_ticks
        self.injector = FaultInjector(plan or FaultPlan([]), plane.fabric,
                                      plane.master)
        plane.fabric.on_deliver = self.injector.on_deliver
        stores = [plane.durability]
        if composer is not None and composer.durability is not None \
                and composer.durability is not plane.durability:
            stores.append(composer.durability)
        self.logstores = [s for s in stores if s is not None]
        for s in self.logstores:
            s.fault_hook = self.injector.on_site
        co = getattr(plane, "coordinator", None)
        if co is not None:
            # multi-master plane: migration protocol steps become fault
            # sites, and kill_master points crash single fault domains
            co.fault_injector = self.injector
            self.injector.kill_master_fn = plane.kill_master
        self.crashed = False
        self.crashes = 0
        self.events: List[dict] = []
        self.recoveries: List[dict] = []

    # --------------------------------------------------------------- tick loop
    def run(self, until: Callable[[], Any], max_ticks: int = 10_000) -> bool:
        """Tick until ``until()`` holds, crash-restarting as the plan fires.
        Returns False if ``max_ticks`` elapse first."""
        ticks = 0
        while ticks < max_ticks:
            try:
                if self.crashed:
                    self.restart()
                self.tick()
                ticks += 1
                if until():
                    return True
            except CrashError:
                self.on_crash()
        return False

    def tick(self) -> None:
        if self.composer is not None:
            self.composer.tick()
        else:
            self.plane.tick()

    # ----------------------------------------------------------- crash/restart
    def on_crash(self) -> None:
        """Model the death: uncommitted WAL tails evaporate, the master
        cluster drops off the fabric."""
        self.crashes += 1
        lost = sum(s.lose_uncommitted() for s in self.logstores)
        self.plane.fabric.partition_cluster(self.plane.master)
        self.crashed = True
        self.events.append({"event": "crash", "n": self.crashes,
                            "at_op": self.injector.ops,
                            "lost_records": lost})

    def restart(self) -> None:
        """Heal + rebuild every global-plane service from WAL/snapshots. A
        ``CrashError`` fired mid-restart (a mid-recovery-storm point)
        propagates to ``run()``, which crashes and restarts again — recovery
        itself is restartable."""
        for _ in range(self.downtime_ticks):
            self.plane.fabric.tick(1.0)
        wal_len = sum(s.stats["committed"] for s in self.logstores)
        t0 = time.perf_counter()
        self.plane.recover_global_plane()
        rec = {"event": "recover", "after_crash": self.crashes,
               "wal_records": wal_len,
               "overwatch": dict(self.plane.overwatch.recovery_stats)}
        if self.composer is not None:
            self.composer.recover()
            rec["pipeline"] = dict(self.composer.recovery_stats)
        rec["wall_s"] = time.perf_counter() - t0
        pipe = rec.get("pipeline", {})
        rec["replayed"] = (rec["overwatch"].get("replayed", 0)
                           + pipe.get("taskdb_replayed", 0)
                           + pipe.get("broker_replayed", 0))
        self.crashed = False
        self.recoveries.append(rec)
        self.events.append(rec)
