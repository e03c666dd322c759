"""Copy of ``repro.core.shardmap`` under ``repro_torch``.

Multi-master global plane: epoch-numbered shard map + live migration.

The paper's global plane is "highly available [and] public cloud hosted";
until now every overwatch shard and broker shard lived inside ONE simulated
master process, so a single crash site covered the whole global plane. This
module splits the plane into N independently crashable **master fault
domains** (``MasterNode``) over the existing fabric and coordinates shard
ownership through an **epoch-numbered shard map**:

  * ``MasterNode`` — a fault domain, not a scheduler: the shard OBJECTS stay
    where they are (this is a single-process simulation), but every fabric
    endpoint a master owns is registered through its ``guard`` wrapper, so
    crashing the node makes exactly its shards unreachable
    (``DeliveryError``) while the survivors keep serving. The front-end
    services the paper calls cloud-managed — the overwatch revision clock,
    lease table, watch delivery, taskdb, the coordinator itself — stay HA
    (they model Spanner/CloudSQL, not a master process).
  * ``ShardMap`` — ``epoch`` + ``shard name -> master name``. Shard
    ADDRESSES never change (clients derive routing from the consistent-hash
    ring alone); the map records which fault domain answers at each address,
    and the epoch fences writers: a request stamped with an old epoch bounces
    with ``{"stale_epoch": True, "epoch": <current>}`` and the client
    refreshes + retries (bounded) instead of double-applying against a moved
    shard. Every flip is WAL'd to the ``shardmap`` durability shard, so a
    whole-plane crash recovers the map (epoch included) before any client
    retry can land.
  * ``ShardMapCoordinator`` — drives **live migration** as a four-step
    protocol advanced ONE step per plane tick (so the freeze window spans
    real ticks and is measurable):

      freeze     writes to the shard bounce with a stale-epoch hint; reads
                 keep serving (the shard is a replica of itself until flip)
      transfer   commit the shard's WAL tail, export its snapshot payload,
                 and persist that exact payload as the durable snapshot —
                 the transferred state and the WAL can never diverge
      flip       epoch++, assignment updated, the flip WAL'd + committed,
                 the endpoint re-guarded under the target master
      replay     the target imports the payload (live) or rebuilds from
                 WAL (failover), then unfreezes

    Master **failover** is the same protocol minus the export: ``step()``
    notices a dead owner, enqueues a ``from_wal`` migration to the next
    alive master, and the rebuild path replays the shard's committed WAL —
    the dying master's uncommitted tail is exactly the loss window, and the
    overwatch's rebuild diffs lost in-memory state against durable state to
    emit watch-repair events at fresh revisions (the replica fan-out's
    rev-dedupe would silently drop reused ones). Master add / drain /
    rebalance are thin wrappers over the same primitive.

Chaos integration: every step fires ``on_site("migrate", "<shard>:<step>")``
BEFORE executing, so a ``FaultPlan`` can kill a master or partition the
fabric at each protocol boundary deterministically
(``site="migrate:<shard>:freeze"`` etc.). ``num_masters=1`` planes never
construct a coordinator and are behavior-identical to the single-process
seed.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.transport import Address, DeliveryError, Fabric

# protocol steps, in order; also the chaos site suffixes
MIGRATION_STEPS = ("freeze", "transfer", "flip", "replay")

# durability shard holding the map's flip log
SHARDMAP_WAL = "shardmap"

# overwatch key the coordinator serializes the map under after each
# migration (best-effort observability; the WAL is the durable copy)
SHARDMAP_KEY = "/sys/shardmap"


class MasterNode:
    """One crashable master fault domain. ``guard(addr, handler)`` registers
    the handler wrapped in a liveness check: a dead master's endpoints raise
    ``DeliveryError`` exactly like an unregistered address, while the shard
    objects (and every other master's endpoints) keep working."""

    def __init__(self, fabric: Fabric, cluster: str, name: str):
        self.fabric = fabric
        self.cluster = cluster
        self.name = name
        self.alive = True

    def guard(self, addr: Address,
              handler: Callable[[dict], dict]) -> None:
        def guarded(req, _h=handler):
            if not self.alive:
                raise DeliveryError(
                    f"master {self.name} is down ({self.cluster}{addr})")
            return _h(req)
        self.fabric.register_handler(self.cluster, addr, guarded)

    def crash(self) -> None:
        self.alive = False

    def restart(self) -> None:
        self.alive = True


@dataclasses.dataclass
class ShardMap:
    """Epoch-numbered shard -> master assignment. Addresses are derived from
    the hash ring and never move; the map says which fault domain ANSWERS."""
    epoch: int = 0
    assignment: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_payload(self) -> dict:
        return {"epoch": self.epoch, "assignment": dict(self.assignment)}


class _Managed:
    """Registration record for one migratable shard: its endpoint, the raw
    (unguarded) handler for re-guarding at flip, the store-specific migration
    ops, and the WAL shard(s) that die with its owner."""

    __slots__ = ("name", "addr", "handler", "ops", "wal_shards")

    def __init__(self, name: str, addr: Address, handler, ops: dict,
                 wal_shards: Tuple[str, ...]):
        self.name = name
        self.addr = addr
        self.handler = handler
        self.ops = ops
        self.wal_shards = tuple(wal_shards)


class _Migration:
    __slots__ = ("shard", "source", "target", "from_wal", "step", "payload",
                 "t0")

    def __init__(self, shard: str, source: Optional[str], target: str,
                 from_wal: bool, t0: float):
        self.shard = shard
        self.source = source
        self.target = target
        self.from_wal = from_wal
        self.step = 0
        self.payload = None
        self.t0 = t0


class ShardMapCoordinator:
    """Owns the map, the masters, and the migration state machine.

    HA by construction (it models the cloud-managed control service, like
    the overwatch front-end): it is never guarded by a ``MasterNode``, and a
    whole-plane crash rebuilds it with the map replayed from the
    ``shardmap`` WAL shard — epoch and assignment survive, so post-restart
    client retries still fence correctly.

    ``step()`` runs once per plane tick: it detects dead owners (enqueueing
    ``from_wal`` failover migrations), then advances every active migration
    exactly ONE protocol step — a migration therefore spans four ticks and
    its freeze window is a measurable number of ticks, during which writes
    bounce-and-retry rather than hang.
    """

    def __init__(self, fabric: Fabric, cluster: str, num_masters: int,
                 durability=None, tracer=None, fault_injector=None):
        self.fabric = fabric
        self.cluster = cluster
        self.masters: Dict[str, MasterNode] = {}
        self._order: List[str] = []
        for i in range(max(1, num_masters)):
            name = f"m{i}"
            self.masters[name] = MasterNode(fabric, cluster, name)
            self._order.append(name)
        self.map = ShardMap()
        self._managed: Dict[str, _Managed] = {}
        self._reg_n = 0                      # round-robin default placement
        self._active: List[_Migration] = []
        self._frozen: set = set()            # shard names mid-migration
        self._dur = durability
        self.tracer = tracer
        self.fault_injector = fault_injector
        # best-effort map serialization into the overwatch (set by the plane)
        self.publish: Optional[Callable[[dict], dict]] = None
        self.stats: Counter = Counter()
        self.migrations_by_shard: Counter = Counter()
        self.frozen_ticks_by_shard: Counter = Counter()
        self.stale_by_shard: Counter = Counter()
        # a whole-plane restart replays the flip log so the recovered map
        # (epoch included) matches what clients last saw
        if durability is not None and durability.has_data(SHARDMAP_WAL):
            payload, recs = durability.load(SHARDMAP_WAL)
            if payload:
                self.map.epoch = payload["epoch"]
                self.map.assignment.update(payload["assignment"])
            for rec in recs:
                if rec[0] == "flip":
                    self.map.epoch = max(self.map.epoch, rec[1])
                    self.map.assignment[rec[2]] = rec[3]
            self.stats["map_replayed_flips"] += len(recs)

    # ------------------------------------------------------------ registration
    def register_shard(self, name: str, addr: Address, handler,
                       ops: dict, wal_shards: Tuple[str, ...] = ()) -> str:
        """Place a shard under a master and guard its endpoint. Idempotent
        across service rebuilds: a WAL-recovered (or existing) assignment
        wins over the round-robin default, so recovery re-registers every
        shard under the owner clients last flipped to. ``ops`` is the
        store-specific migration vocabulary::

            freeze()          quiesce writes (may be a no-op if the host
                              consults ``coordinator.frozen()`` directly)
            unfreeze()
            export() -> dict  snapshot payload (live transfer)
            import_(payload)  install a transferred payload (live replay)
            rebuild()         rebuild from committed WAL (failover replay)
        """
        owner = self.map.assignment.get(name)
        if owner not in self.masters:
            owner = self._order[self._reg_n % len(self._order)]
            self.map.assignment[name] = owner
        self._reg_n += 1
        m = _Managed(name, addr, handler, ops, wal_shards)
        self._managed[name] = m
        self.masters[owner].guard(addr, handler)
        return owner

    # ---------------------------------------------------------------- queries
    @property
    def epoch(self) -> int:
        return self.map.epoch

    def frozen(self, name: str) -> bool:
        """True while writes to the shard must bounce: mid-migration freeze
        window, or its owning master is dead (the failover's implicit
        freeze — the coordinator notices on the next tick)."""
        if name in self._frozen:
            return True
        node = self.masters.get(self.map.assignment.get(name))
        return node is not None and not node.alive

    def frozen_names(self) -> List[str]:
        return sorted(n for n in self._managed if self.frozen(n))

    def note_stale(self, name: str) -> None:
        """A fenced write bounced off this shard (stale epoch or frozen)."""
        self.stale_by_shard[name] += 1
        self.stats["stale_epoch_rejections"] += 1

    def owner_of(self, name: str) -> Optional[str]:
        return self.map.assignment.get(name)

    def shards_of(self, master: str) -> List[str]:
        return sorted(n for n, o in self.map.assignment.items()
                      if o == master and n in self._managed)

    def wal_shards_of(self, master: str) -> List[str]:
        out: List[str] = []
        for name in self.shards_of(master):
            out.extend(self._managed[name].wal_shards)
        return out

    @property
    def busy(self) -> bool:
        return bool(self._active)

    # ------------------------------------------------------------- fault model
    def kill_master(self, name: str) -> List[str]:
        """Crash one fault domain: its endpoints start raising
        ``DeliveryError``, and its shards' uncommitted WAL tails evaporate
        (only ITS shards — the survivors' buffered records are untouched).
        Returns the shard names that now need failover."""
        node = self.masters[name]
        if not node.alive:
            return []
        node.crash()
        if self._dur is not None:
            self._dur.lose_shards(self.wal_shards_of(name))
        self.stats["master_kills"] += 1
        return self.shards_of(name)

    def restart_master(self, name: str) -> None:
        """Bring a crashed fault domain back empty-handed: its shards have
        (or will have) migrated away; it becomes a rebalance target."""
        self.masters[name].restart()
        self.stats["master_restarts"] += 1

    def add_master(self, name: str) -> MasterNode:
        node = MasterNode(self.fabric, self.cluster, name)
        self.masters[name] = node
        self._order.append(name)
        self.stats["masters_added"] += 1
        return node

    # -------------------------------------------------------------- migrations
    def migrate(self, shard: str, target: str) -> bool:
        """Enqueue a live migration (one protocol step per tick). Rejected if
        the shard is unknown, already migrating, or already owned there."""
        if shard not in self._managed or target not in self.masters:
            return False
        if not self.masters[target].alive:
            return False
        if self.map.assignment.get(shard) == target:
            return False
        if any(m.shard == shard for m in self._active):
            return False
        self._active.append(_Migration(shard, self.map.assignment.get(shard),
                                       target, False, self.fabric.clock))
        self.stats["migrations_started"] += 1
        return True

    def drain_master(self, name: str) -> int:
        """Move every shard off a master (decommission / maintenance): one
        live migration per shard, targets round-robin over the other alive
        masters. Returns how many migrations were enqueued."""
        moved = 0
        for shard in self.shards_of(name):
            target = self._pick_target(exclude=name, salt=moved)
            if target is not None and self.migrate(shard, target):
                moved += 1
        return moved

    def rebalance(self) -> int:
        """Round-robin the managed shards over the alive masters (sorted
        registration order) and migrate every mismatch — the hot-shard /
        new-master leveling primitive."""
        alive = [n for n in self._order if self.masters[n].alive]
        if not alive:
            return 0
        moved = 0
        for i, shard in enumerate(sorted(self._managed)):
            want = alive[i % len(alive)]
            if self.map.assignment.get(shard) != want:
                if self.migrate(shard, want):
                    moved += 1
        return moved

    def _pick_target(self, exclude: Optional[str],
                     salt: int = 0) -> Optional[str]:
        alive = [n for n in self._order
                 if n != exclude and self.masters[n].alive]
        if not alive:
            return None
        # spread consecutive picks (drain, multi-shard failover) round-robin
        return alive[(self.stats["targets_picked"] + salt) % len(alive)]

    # ------------------------------------------------------------------- tick
    def step(self) -> None:
        """One coordinator tick: detect dead owners, advance each active
        migration one protocol step, account frozen time."""
        # 1. failover detection — a shard whose owner died gets a from_wal
        #    migration to the next alive master (also covers killing the
        #    TARGET of an in-flight migration: once that migration finishes
        #    or the map flips, the dead owner is detected here again)
        for shard in sorted(self._managed):
            owner = self.map.assignment.get(shard)
            node = self.masters.get(owner)
            if node is not None and node.alive:
                continue
            if any(m.shard == shard for m in self._active):
                continue
            target = self._pick_target(exclude=owner)
            if target is None:
                self.stats["failover_stalled_ticks"] += 1
                continue
            self.stats["targets_picked"] += 1
            self._active.append(_Migration(shard, owner, target, True,
                                           self.fabric.clock))
            self.stats["failovers_started"] += 1
        # 2. frozen-window accounting: every shard unwritable this tick
        for name in self._managed:
            if self.frozen(name):
                self.frozen_ticks_by_shard[name] += 1
                self.stats["frozen_ticks"] += 1
        # 3. advance — one step per migration per tick, so freeze windows
        #    span real ticks and chaos can land between any two steps
        for mig in list(self._active):
            self._advance(mig)

    def _advance(self, mig: _Migration) -> None:
        step_name = MIGRATION_STEPS[mig.step]
        m = self._managed[mig.shard]
        if self.fault_injector is not None:
            # fires BEFORE the step executes: a crash here leaves the
            # protocol at a well-defined boundary (pre-flip: the old owner
            # still holds the shard; post-flip: the WAL'd map wins)
            self.fault_injector.on_site("migrate",
                                        f"{mig.shard}:{step_name}")
        if (not mig.from_wal and step_name in ("freeze", "transfer")
                and mig.source in self.masters
                and not self.masters[mig.source].alive):
            # the live source died before the export landed (possibly via
            # the fault hook just above): a dead master cannot be asked for
            # anything — degrade to a WAL failover (its committed log is the
            # transfer). A source dying AFTER transfer is fine: the payload
            # already left it and was persisted as the durable snapshot.
            mig.from_wal = True
            mig.payload = None
            self.stats["live_migrations_degraded"] += 1
        if step_name == "freeze":
            m.ops["freeze"]()
            self._frozen.add(mig.shard)
        elif step_name == "transfer":
            if not mig.from_wal:
                # live handoff: commit the tail, export the quiesced state,
                # and persist that exact payload as the durable snapshot so
                # the WAL and the in-flight transfer can never diverge
                if self._dur is not None:
                    for w in m.wal_shards:
                        self._dur.commit(w)
                mig.payload = m.ops["export"]()
                if self._dur is not None and len(m.wal_shards) == 1:
                    self._dur.snapshot(m.wal_shards[0], mig.payload)
            # failover: nothing to export — the committed WAL *is* the
            # transfer (the dead master cannot be asked for anything)
        elif step_name == "flip":
            self.map.epoch += 1
            self.map.assignment[mig.shard] = mig.target
            if self._dur is not None:
                self._dur.append(SHARDMAP_WAL,
                                 ("flip", self.map.epoch, mig.shard,
                                  mig.target, mig.from_wal))
                self._dur.commit(SHARDMAP_WAL)
            # the endpoint answers under the target fault domain from here on
            self.masters[mig.target].guard(m.addr, m.handler)
        elif step_name == "replay":
            if mig.from_wal:
                m.ops["rebuild"]()
            else:
                m.ops["import_"](mig.payload)
            m.ops["unfreeze"]()
            self._frozen.discard(mig.shard)
            self._active.remove(mig)
            self.migrations_by_shard[mig.shard] += 1
            self.stats["migrations"] += 1
            if mig.from_wal:
                self.stats["failovers"] += 1
            if self.tracer is not None:
                self.tracer.span_complete(
                    f"shardmap/{mig.shard}", "migrate", "shardmap", mig.t0,
                    attrs={"shard": mig.shard, "from": mig.source,
                           "to": mig.target, "failover": mig.from_wal,
                           "epoch": self.map.epoch})
            self._publish_map()
            return
        mig.step += 1

    def _publish_map(self) -> None:
        """Serialize the map into the overwatch (``/sys/shardmap``) so any
        client/replica can observe it. Best-effort: a bounce (the owning
        shard itself frozen or failing over) is counted, not raised — the
        WAL remains the authoritative copy."""
        if self.publish is None:
            return
        try:
            resp = self.publish(self.map.to_payload())
        except DeliveryError:
            resp = {"ok": False}
        if not (resp or {}).get("ok"):
            self.stats["map_publish_bounced"] += 1

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, Any]:
        """Registry source for the ``shardmap`` section of the master
        agent's ``/metrics/<cluster>/`` feed."""
        out: Dict[str, Any] = {
            "epoch": self.map.epoch,
            "migrations": self.stats["migrations"],
            "failovers": self.stats["failovers"],
            "frozen_ticks": self.stats["frozen_ticks"],
            "stale_epoch_rejections": self.stats["stale_epoch_rejections"],
            "masters_alive": sum(1 for n in self.masters.values()
                                 if n.alive),
        }
        for shard, n in sorted(self.migrations_by_shard.items()):
            out[f"{shard}.migrations"] = n
        for shard, n in sorted(self.frozen_ticks_by_shard.items()):
            out[f"{shard}.frozen_ticks"] = n
        for shard, n in sorted(self.stale_by_shard.items()):
            out[f"{shard}.stale_epoch_rejections"] = n
        return out
