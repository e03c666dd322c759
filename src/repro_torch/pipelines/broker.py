"""Copy of ``repro.pipelines.broker`` under ``repro_torch``.

Message broker (the redis of paper §5) — named FIFO queues with lease-style
redelivery: a pulled message is invisible until acked or its lease expires
(worker died mid-task -> the task instance is redelivered, not lost).

Batched protocol (the data-plane throughput overhaul): alongside the original
per-message ops (``push``/``pull``/``ack``/``nack``/``depth``) the broker
speaks batch ops that amortize one round-trip over many messages:

  * ``push_many(queue, msgs)``   — enqueue a whole ready frontier in one RPC;
  * ``pull_many(queue, max_n)``  — a worker drains up to ``max_n`` task
    instances per round-trip (partial fills are fine, empty queues return
    empty lists);
  * ``ack_many(tags)``           — one commit acknowledges a whole executed
    batch (idempotent: unknown/already-acked tags are skipped);
  * ``depth_many(queues?)``      — one probe reads every queue's depth.

Lease bookkeeping is O(log n): pulls push ``(expires_at, tag)`` onto a
lazy-deletion min-heap (acked tags leave stale heap entries that are skipped
when popped), so every op pays one heap peek instead of the old full
``inflight`` scan — the same structure the overwatch lease table uses.

Depth telemetry is truthful: ``depth`` reports ``(ready, inflight)`` — the
messages waiting in the queue AND the ones leased out to workers — and
``changed_depths()`` yields only queues whose counts moved since the last
call, so a sweep-cadence publisher (the composer) writes coalesce-friendly
``/queues/<name>`` deltas into the overwatch instead of re-putting every
queue every tick.

Redelivery keeps the message dict — ``try`` metadata included — byte-for-byte
intact. By default an expired or nacked message re-enters its queue at the
BACK (FIFO arrival order); the old always-``appendleft`` behavior starved the
queue head under churn, because every redelivery jumped ahead of messages
that had been waiting longer. ``requeue_front=True`` (per-broker, or per-op
on ``nack``/``nack_many``) restores jump-the-queue redelivery where lower
redelivery latency matters more than fairness.

Redelivery accounting distinguishes cause: ``stats["redelivered"]`` counts
lease-EXPIRY redeliveries (a worker died holding the lease) while
``stats["redelivered_nacked"]`` counts explicit returns (``nack`` /
``nack_many`` — a worker handing work back on purpose). An autoscaler
draining fleets cleanly should leave the expiry counter untouched; a rising
expiry count is a fleet-health signal, a rising nack count is backpressure.

Read ops are strictly read-only on queue state: ``pull``/``pull_many``/
``depth``/``depth_many`` against an unknown queue return empty/zero and
create NOTHING — probing a queue name must never materialize broker state.
``depth_many`` without an explicit queue list reports only queues with a
non-zero ready or inflight count, matching the tombstoned ``/queues/<name>``
view (a fully drained queue disappears rather than lingering at 0/0).

Per-family sharding (the cross-boundary traffic overhaul): ``BrokerRouter``
splits the broker behind a consistent-hash ring over queue families (a family
IS the queue name — ``scheduler.queue_for`` derives it from the capability
set), the exact discipline the overwatch ``ShardRouter`` uses. Each shard is a
full ``Broker`` behind its OWN fabric endpoint/service (``broker-s<k>``), so
worker ``pull_many``/``ack_many`` batches for disjoint families stop
serializing through one handler, and every client (scheduler, workers) derives
identical routing from the shard count alone — no topology exchange.
``num_shards=1`` keeps the single ``"broker"`` service and is
behavior-identical to the unsharded broker. Both ``depth_many`` and
``changed_depths`` accept a family filter so a publisher only reports the
families its shard owns.

Durability (the crash-survivable control plane): constructed with a
``repro_torch.core.durability.LogStore``, every state-changing op appends a WAL
record and the composer group-commits once per tick — taskdb before broker,
so an acknowledged effect is always at least as durable as its ack. After a
crash ``recover()`` rebuilds from snapshot + replay, requeues every in-flight
lease, marks all surviving messages ``redelivered`` (workers dedup-probe the
taskdb before re-executing), and bumps a persisted tag *epoch* so acks for
pre-crash tags are recognized as stale (``stats["stale_acks"]``) instead of
releasing someone else's lease.
"""
from __future__ import annotations

import heapq
from collections import Counter, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

from repro_torch.core.overwatch import ShardRouter


BROKER_SERVICE = "broker"


def broker_service_names(num_shards: int) -> Tuple[str, ...]:
    """Service names backing the (possibly sharded) broker. One shard keeps
    the historic ``"broker"`` name — identical AppSpec, DNS, ACLs, channels."""
    if num_shards <= 1:
        return (BROKER_SERVICE,)
    return tuple(f"broker-s{i}" for i in range(num_shards))


class BrokerRouter(ShardRouter):
    """Deterministic queue-family -> shard routing: the overwatch's
    consistent-hash ring (crc32, 32 vnodes/shard) under an independent seed.
    Clients and the composer build the same ring from the shard count alone,
    so routing is a pure function — part of the wire contract exactly like
    the overwatch ring parameters."""

    def __init__(self, num_shards: int, vnodes: int = 32):
        super().__init__(max(1, num_shards), vnodes=vnodes,
                         seed="broker-shard")

    def shard_for_queue(self, queue: str) -> int:
        return self.shard_for_segment(queue)

    def service_for_queue(self, queue: str) -> str:
        """The service name a client dials for this queue's ops."""
        if self.num_shards == 1:
            return BROKER_SERVICE
        return f"broker-s{self.shard_for_queue(queue)}"


FamilyFilter = Union[None, Callable[[str], bool], set, frozenset, list, tuple]


def _family_match(families: FamilyFilter, queue: str) -> bool:
    if families is None:
        return True
    if callable(families):
        return bool(families(queue))
    return queue in families


TAG_EPOCH_STRIDE = 1_000_000_000


class Broker:
    def __init__(self, clock_fn=None, lease: float = 30.0,
                 requeue_front: bool = False,
                 durability=None, shard_name: str = "broker",
                 tracer=None, recover: bool = True):
        # flight recorder: a "queue" span opens at push/requeue and closes at
        # pull — the queue-wait segment of a task's trace. Set BEFORE the
        # durability check below: WAL replay re-pushes messages and must
        # re-open their spans (the pre-crash ones were truncated).
        self.tracer = tracer
        self.queues: Dict[str, Deque[dict]] = {}
        # parallel to queues: per-message redelivered flags. Kept as a SEPARATE
        # aligned deque (not wrapped tuples) so queue entries stay the raw
        # message dicts clients pushed — observable queue state is unchanged.
        self._flags: Dict[str, Deque[bool]] = {}
        # tag -> (queue, msg, expires_at, redelivered); tags are unique per
        # pull, so a heap entry is stale iff its tag is gone from this table
        self.inflight: Dict[int, Tuple[str, dict, float, bool]] = {}
        self._expiry_heap: List[Tuple[float, int]] = []
        self._inflight_count: Counter = Counter()    # per-queue leased-out
        # tag = epoch * TAG_EPOCH_STRIDE + n. Epoch 0 (no durability, or no
        # crash yet) makes tags the plain 1,2,3,... they always were; recovery
        # bumps the epoch so every pre-crash tag misses the new lease table
        # and lands in stats["stale_acks"] instead of acking the wrong lease.
        self._epoch = 0
        self._tag_n = 0
        self.clock_fn = clock_fn or (lambda: 0.0)
        self.lease = lease
        self.requeue_front = requeue_front
        self.op_counts: Counter = Counter()          # per-op RPC accounting
        self.stats: Counter = Counter()              # expire_scanned/redelivered
        self._depth_dirty: set = set()
        self._published: Dict[str, Tuple[int, int]] = {}
        # durability: every state-changing op appends a WAL record (see the
        # replay table in _apply_replay); the composer group-commits per tick
        # and snapshots via snapshot_payload(). None => identical behavior.
        self._dur = durability
        self._shard = shard_name
        self.recovered_task_keys: set = set()
        # multi-master live migration (repro_torch.core.shardmap): while frozen,
        # every state-changing op bounces with a stale-epoch hint (depth
        # reads keep serving); on_stale reports bounces to the coordinator.
        # ``recover=False`` builds an empty broker for ``install_payload``
        # (a live-migration import must not replay the WAL it is replacing).
        self.frozen = False
        self.on_stale = None
        if recover and durability is not None \
                and durability.has_data(shard_name):
            self.recover()

    # ------------------------------------------------------------------ leases
    def _expire(self) -> None:
        """Pop due leases off the min-heap and redeliver their messages.

        O(expired · log n): a peek when nothing is due — never a scan of the
        live ``inflight`` table. ``stats['expire_scanned']`` counts heap pops
        so tests can pin the no-scan property.
        """
        now = self.clock_fn()
        heap = self._expiry_heap
        while heap and heap[0][0] < now:
            _, tag = heapq.heappop(heap)
            self.stats["expire_scanned"] += 1
            rec = self.inflight.pop(tag, None)
            if rec is None:
                continue                     # stale entry (acked) — lazy delete
            queue, msg = rec[0], rec[1]
            self._requeue(queue, msg, self.requeue_front, redelivered=True)
            self.stats["redelivered"] += 1          # lease-expiry redelivery
            if self._dur is not None:
                self._dur.append(self._shard, ("exp", tag))

    def _requeue(self, queue: str, msg: dict, front: bool,
                 redelivered: bool = True) -> None:
        q = self.queues.setdefault(queue, deque())
        f = self._flags.setdefault(queue, deque())
        if front:
            q.appendleft(msg)
            f.appendleft(redelivered)
        else:
            q.append(msg)
            f.append(redelivered)
        self._inflight_count[queue] -= 1
        self._depth_dirty.add(queue)
        self._trace_push(msg, redelivered=True)   # second queue-wait segment

    # -------------------------------------------------------------- tracing
    def _trace_push(self, msg, redelivered: bool = False,
                    now=None) -> None:
        """Open the queue-wait span for a traced message (no-op otherwise).
        Keyed by (dag, task, try) so pull — or post-crash replay — closes the
        same span; re-pushing an already-open key reuses it (no orphans).
        Batch pushes pass ``now`` so the clock is read once per batch."""
        tr = self.tracer
        if tr is None or not isinstance(msg, dict) or "trace" not in msg:
            return
        tr.open_keyed(("queue", msg["dag"], msg["task"], msg["try"]),
                      "queue", "broker", parent=msg["trace"],
                      attrs={"redelivered": redelivered} if redelivered
                      else None, t0=now)

    def _trace_pull(self, msg, now=None) -> None:
        """Close the queue-wait span at lease time (no-op when untraced,
        already closed, or crash-truncated)."""
        if self.tracer is None or not isinstance(msg, dict) \
                or "trace" not in msg:
            return
        self.tracer.close_keyed(
            ("queue", msg["dag"], msg["task"], msg["try"]), t1=now)

    # ------------------------------------------------------------- op helpers
    def _next_tag(self) -> int:
        self._tag_n += 1
        return self._epoch * TAG_EPOCH_STRIDE + self._tag_n

    def _push(self, queue: str, msg: dict, redelivered: bool = False) -> None:
        self.queues.setdefault(queue, deque()).append(msg)
        self._flags.setdefault(queue, deque()).append(redelivered)
        self._depth_dirty.add(queue)
        self._trace_push(msg, redelivered)

    def _pull_one(self, queue: str,
                  trace: bool = True) -> Optional[Tuple[dict, int, bool]]:
        q = self.queues.get(queue)
        if not q:
            return None
        item = q.popleft()
        flag = self._flags[queue].popleft()
        now = self.clock_fn()
        if trace:                        # pull_many batch-closes instead
            self._trace_pull(item, now=now)
        tag = self._next_tag()
        expires = now + self.lease
        self.inflight[tag] = (queue, item, expires, flag)
        heapq.heappush(self._expiry_heap, (expires, tag))
        self._inflight_count[queue] += 1
        self._depth_dirty.add(queue)
        return item, tag, flag

    def _ack_one(self, tag) -> bool:
        rec = self.inflight.pop(tag, None)
        if rec is None:
            self.stats["stale_acks"] += 1    # idempotent: unknown/double ack
            return False
        self._inflight_count[rec[0]] -= 1
        self._depth_dirty.add(rec[0])
        if self._dur is not None:
            self._dur.append(self._shard, ("ack", tag))
        return True

    def _nack_one(self, tag, front) -> bool:
        """Explicit return of a leased message (idempotent like ack)."""
        rec = self.inflight.pop(tag, None)
        if rec is None:
            self.stats["stale_acks"] += 1
            return False
        self._requeue(rec[0], rec[1],
                      self.requeue_front if front is None else front,
                      redelivered=rec[3])
        self.stats["redelivered_nacked"] += 1
        if self._dur is not None:
            self._dur.append(self._shard, ("nack", tag, front))
        return True

    def _depth_of(self, queue: str) -> Tuple[int, int]:
        return (len(self.queues.get(queue) or ()),
                self._inflight_count.get(queue, 0))

    # ------------------------------------------------------------ service API
    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        self.op_counts[op] += 1
        if self.frozen and op not in ("depth", "depth_many"):
            # mid-migration: no state change may land behind the transferred
            # snapshot (not even a lease expiry). Callers bounce-and-retry —
            # the scheduler stashes its pushes, workers treat it like an
            # empty pull / unacked batch (lease redelivery + dedup probe).
            self.stats["frozen_bounced"] += 1
            if self.on_stale is not None:
                self.on_stale()
            return {"ok": False, "error": "broker shard frozen (migrating)",
                    "stale_epoch": True, "frozen": True}
        self._expire()
        if op == "push":
            redel = bool(msg.get("redelivered"))
            self._push(msg["queue"], msg["msg"], redel)
            if self._dur is not None:
                self._dur.append(self._shard,
                                 ("push", msg["queue"], msg["msg"], redel))
            return {"ok": True, "depth": len(self.queues[msg["queue"]])}
        if op == "push_many":
            redel = bool(msg.get("redelivered"))
            q = self.queues.setdefault(msg["queue"], deque())
            q.extend(msg["msgs"])
            self._flags.setdefault(msg["queue"], deque()).extend(
                redel for _ in msg["msgs"])
            self._depth_dirty.add(msg["queue"])
            if self.tracer is not None:
                ra = {"redelivered": True} if redel else None
                items = [(("queue", m["dag"], m["task"], m["try"]),
                          m["trace"], ra)
                         for m in msg["msgs"] if "trace" in m]
                if items:                # one call for the whole batch
                    self.tracer.open_keyed_many(items, "queue", "broker",
                                                self.clock_fn())
            if self._dur is not None:
                self._dur.append(self._shard,
                                 ("pushN", msg["queue"], msg["msgs"], redel))
            return {"ok": True, "depth": len(q)}
        if op == "pull":
            got = self._pull_one(msg["queue"])
            if got is None:
                return {"ok": True, "msg": None}
            if self._dur is not None:
                self._dur.append(self._shard,
                                 ("pullN", msg["queue"], [got[1]]))
            resp = {"ok": True, "msg": got[0], "tag": got[1]}
            if got[2]:
                resp["redelivered"] = True
            return resp
        if op == "pull_many":
            msgs: List[dict] = []
            tags: List[int] = []
            flags: List[bool] = []
            for _ in range(max(int(msg.get("max_n", 1)), 0)):
                got = self._pull_one(msg["queue"], trace=False)
                if got is None:
                    break
                msgs.append(got[0])
                tags.append(got[1])
                flags.append(got[2])
            if self.tracer is not None and msgs:
                keys = [("queue", m["dag"], m["task"], m["try"])
                        for m in msgs if "trace" in m]
                if keys:                 # one close for the whole batch
                    self.tracer.close_keyed_many(keys, self.clock_fn())
            if tags and self._dur is not None:
                self._dur.append(self._shard, ("pullN", msg["queue"], tags))
            resp = {"ok": True, "msgs": msgs, "tags": tags}
            if any(flags):
                # only present when something needs a dedup probe: the clean
                # path's response stays byte-identical to the flagless broker
                resp["redelivered"] = flags
            return resp
        if op == "ack":
            self._ack_one(msg.get("tag"))
            return {"ok": True}
        if op == "ack_many":
            tags = msg.get("tags", ())
            acked = sum(1 for t in tags if self._ack_one(t))
            return {"ok": True, "acked": acked}
        if op == "nack":
            self._nack_one(msg.get("tag"), msg.get("requeue_front"))
            return {"ok": True}
        if op == "nack_many":
            front = msg.get("requeue_front")
            nacked = sum(1 for t in msg.get("tags", ())
                         if self._nack_one(t, front))
            return {"ok": True, "nacked": nacked}
        if op == "depth":
            ready, inflight = self._depth_of(msg["queue"])
            return {"ok": True, "depth": ready,
                    "ready": ready, "inflight": inflight}
        if op == "depth_many":
            queues = msg.get("queues")
            families = msg.get("families")   # per-family filter (sharding)
            listing = queues is None
            if listing:
                queues = sorted(set(self.queues) | set(self._inflight_count))
            depths = {}
            for q in queues:
                if not _family_match(families, q):
                    continue
                ready, inflight = self._depth_of(q)
                if listing and not ready and not inflight:
                    continue            # drained queues drop out of listings
                depths[q] = {"ready": ready, "inflight": inflight}
            return {"ok": True, "depths": depths}
        return {"ok": False, "error": f"unknown op {op}"}

    # ------------------------------------------------------------- durability
    def snapshot_payload(self) -> dict:
        """Full broker state for snapshot+truncate compaction: ready queues
        with their redelivered flags, the in-flight lease table, and the tag
        epoch/counter. ``Broker.recover()`` rebuilds from this plus the
        post-snapshot WAL tail."""
        return {
            "epoch": self._epoch, "tag_n": self._tag_n,
            "queues": {q: [[m, f] for m, f in
                           zip(dq, self._flags.get(q, ()))]
                       for q, dq in self.queues.items() if dq},
            "inflight": [[tag, rec[0], rec[1], rec[2], rec[3]]
                         for tag, rec in self.inflight.items()],
        }

    def install_payload(self, payload: dict) -> None:
        """Live-migration import: the transferred ``snapshot_payload`` becomes
        this broker's state verbatim — ready queues with flags, the in-flight
        lease table (expiry heap rebuilt), and the tag epoch/counter. Leases
        and tags SURVIVE the handoff: a worker acking a pre-migration pull
        after the flip still lands it, so a migration costs zero redeliveries
        (failover uses ``recover()`` instead, which requeues + bumps the
        epoch because the old leases died with the master)."""
        self._epoch = payload["epoch"]
        self._tag_n = payload["tag_n"]
        self.queues = {}
        self._flags = {}
        for q, items in payload["queues"].items():
            dq = self.queues.setdefault(q, deque())
            fq = self._flags.setdefault(q, deque())
            for msg, flag in items:
                dq.append(msg)
                fq.append(flag)
        self.inflight = {}
        self._expiry_heap = []
        self._inflight_count = Counter()
        for tag, q, msg, expires, flag in payload["inflight"]:
            self.inflight[tag] = (q, msg, expires, flag)
            heapq.heappush(self._expiry_heap, (expires, tag))
            self._inflight_count[q] += 1
        self._depth_dirty = set(self.queues) | set(self._inflight_count)
        self._published = {}

    def held_task_keys(self) -> set:
        """Every (dag, task, try) this broker currently holds — ready OR
        leased out. The reseed-after-failover set: a queued/running taskdb
        row with no held message lost its message and must be re-pushed."""
        held = {(m["dag"], m["task"], m["try"])
                for dq in self.queues.values() for m in dq
                if isinstance(m, dict) and "dag" in m and "task" in m}
        for q, m, _expires, _flag in self.inflight.values():
            if isinstance(m, dict) and "dag" in m and "task" in m:
                held.add((m["dag"], m["task"], m["try"]))
        return held

    def _apply_replay(self, rec) -> None:
        """One WAL record. Types: ``push``/``pushN`` (queue, msg(s), flag),
        ``pullN`` (queue, tags — head messages move in-flight under the
        recorded tags), ``ack``/``nack`` (tag), ``exp`` (lease-expiry
        requeue), ``epoch``. Replay is NOT idempotent (pull/ack move state);
        the LogStore's LSN filtering guarantees each record applies exactly
        once, starting right after the snapshot."""
        kind = rec[0]
        if kind == "push":
            self._push(rec[1], rec[2], rec[3])
        elif kind == "pushN":
            for m in rec[2]:
                self._push(rec[1], m, rec[3])
        elif kind == "pullN":
            q = self.queues.get(rec[1])
            flags = self._flags.get(rec[1])
            for tag in rec[2]:
                if not q:
                    break
                m = q.popleft()
                self.inflight[tag] = (rec[1], m, 0.0, flags.popleft())
                self._inflight_count[rec[1]] += 1
                self._trace_pull(m)
        elif kind == "ack":
            self._ack_one(rec[1])
        elif kind == "nack":
            self._nack_one(rec[1], rec[2])
        elif kind == "exp":
            irec = self.inflight.pop(rec[1], None)
            if irec is not None:
                self._requeue(irec[0], irec[1], self.requeue_front,
                              redelivered=True)
        elif kind == "epoch":
            self._epoch = max(self._epoch, rec[1])

    def recover(self) -> None:
        """Rebuild from snapshot + WAL replay, then (1) requeue every
        recovered in-flight message — its pre-crash lease died with the
        worker RPCs — (2) mark every surviving ready message redelivered, so
        workers dedup-probe against the taskdb before executing (an ack the
        crash swallowed means the message may already have run), and (3) bump
        and immediately persist the tag epoch so stale acks can never land."""
        dur = self._dur
        self._dur = None                 # replay must not re-log itself
        try:
            payload, records = dur.load(self._shard)
            if payload:
                self._epoch = payload["epoch"]
                self._tag_n = payload["tag_n"]
                for q, items in payload["queues"].items():
                    dq = self.queues.setdefault(q, deque())
                    fq = self._flags.setdefault(q, deque())
                    for msg, flag in items:
                        dq.append(msg)
                        fq.append(flag)
                for tag, q, msg, expires, flag in payload["inflight"]:
                    self.inflight[tag] = (q, msg, expires, flag)
                    self._inflight_count[q] += 1
            for rec in records:
                self._apply_replay(rec)
            self.stats["recovery_replayed"] += len(records)
            for tag in sorted(self.inflight):
                irec = self.inflight.pop(tag)
                self._requeue(irec[0], irec[1], False, redelivered=True)
                self.stats["recovered_inflight"] += 1
            self._expiry_heap = []
            for q, flags in self._flags.items():
                self._flags[q] = deque(True for _ in flags)
            self.recovered_task_keys = {
                (m["dag"], m["task"], m["try"])
                for dq in self.queues.values() for m in dq
                if isinstance(m, dict) and "dag" in m and "task" in m}
        finally:
            self._dur = dur
        self._epoch += 1
        self._tag_n = 0
        dur.append(self._shard, ("epoch", self._epoch))
        dur.commit(self._shard)          # epoch durable before any new lease
        self._depth_dirty = set(self.queues) | set(self._inflight_count)
        self._published = {}

    # ------------------------------------------------------- depth publication
    def changed_depths(self, families: FamilyFilter = None) -> Dict[str, dict]:
        """(ready, inflight) for queues whose counts moved since the last call
        — the sweep-cadence feed a publisher writes under ``/queues/<name>``.
        Queues whose dirty ops netted out to the last-published counts are
        skipped, keeping the watch stream quiet on steady state.

        ``families`` (a container or predicate of queue names) restricts the
        report to the families this shard OWNS: a sharded composer publishes
        each family exactly once, from its owning shard. Non-owned dirty
        queues stay dirty — an unfiltered call (or the owner) still sees
        them, nothing is silently un-flagged.
        """
        self._expire()
        out: Dict[str, dict] = {}
        skipped = []
        for q in sorted(self._depth_dirty):
            if not _family_match(families, q):
                skipped.append(q)
                continue
            cur = self._depth_of(q)
            if self._published.get(q) != cur:
                self._published[q] = cur
                out[q] = {"ready": cur[0], "inflight": cur[1]}
        self._depth_dirty.clear()
        self._depth_dirty.update(skipped)
        return out
