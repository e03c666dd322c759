"""Copy of ``repro.core.replica`` under ``repro_torch``.

Per-cluster overwatch replica fan-out: local reads AND local notify.

The paper's core scalability claim is that the hybrid plane keeps
cross-boundary traffic THIN: local control planes act on local state while the
global plane only ships deltas (§4). This module is that thin boundary for the
whole OBSERVATION plane — both halves of it:

  * the **read path** (PR 5): every remote ``range_stale`` — an agent probing
    fleet telemetry, a worker checking queue depth — used to round-trip
    through gateway channels to the master-side overwatch, paying the full
    request+response byte cost per read. The master instead ships each
    cluster ONE coalesced, revision-tagged delta envelope per sweep, and
    remote reads are served from the local snapshot for free.

  * the **notify path** (this PR): remote watch subscriptions used to be
    impossible without per-watcher cross-boundary traffic — every observer of
    ``/queues/``, ``/telemetry/`` or ``/autoscale/`` state on a private
    cluster had to poll the primary per tick. ``LocalReplica`` now exposes
    ``watch(prefix, cb)`` / ``watch_batch(prefix, cb)`` with the same
    revision-ordered, coalesced semantics as the primary's watch buckets, fed
    entirely from the SAME shipped envelope — so N watchers on a cluster cost
    exactly the cross-boundary bytes of zero watchers, and the agent can
    expose the replica as a cluster-local service endpoint (``range_stale`` +
    ``watch``, see ``ControlAgent.enable_replica``) that worker pods, depth
    views, and autoscale observers consume instead of dialing the master.

Three pieces:

  * ``LocalReplica`` — hosted by each control agent: a ``ReplicaState``
    snapshot restricted to a prefix set, plus freshness bookkeeping
    (``synced_at``, the master clock of the last applied ship) that lets
    ``OverwatchClient.range_stale`` decide locally whether the caller's
    ``max_lag`` is satisfied (out of bound: transparent fallback to the
    primary round trip, counted in ``fabric.stats["fallback_reads"]``) — and
    now the local watch plane. Watch delivery is exactly-once per key-state:
    cumulative redelivery after a failed ack is deduplicated by revision, and
    a ``reset`` batch (crash recovery re-seeded the feed) is DIFFED against
    the pre-reset snapshot so watchers see synthesized tombstones for keys
    deleted during the gap, puts only for keys that actually changed, and
    nothing at all for state they already hold. Per-watcher pending queues
    are bounded (RingLog discipline: drop-oldest + ``stats["watch_dropped"]``)
    so a stuck callback can't grow memory without bound; a raising callback
    keeps its queue and is retried on the next ship.

  * ``ReplicaView`` — a watch-materialized dict over one shipped prefix: the
    cluster-local analogue of the dispatcher's master-side views, used by the
    composer's worker depth gate and any fleet-state observer.

  * ``ReplicaShipper`` — master-side: subscribes one catch-all batch watcher
    to the overwatch and maintains ONE shared, key-coalesced delta log (only
    the latest state of a key matters to a snapshot) with a revision-ordered
    index, plus a per-cluster cumulative-ack horizon (``acked_rev``).
    Event intake is O(events) however many clusters are fed. ``ship_all()``
    — called on the plane's sweep cadence — sends each cluster one envelope
    carrying every log entry above ITS horizon, over the existing
    master->agent dispatch relay; the horizon advances only on a confirmed
    apply, so a failed ship costs nothing and the first ship after heal
    carries everything missed. Registration is idempotent for live feeds (a
    duplicate register after a timed-out ack neither re-ships the bootstrap
    seed nor resets the horizon). The log compacts below the minimum horizon
    across feeds. Empty ships still go out: they are the freshness beacon
    that distinguishes "nothing changed" from "cut off".

Byte-ledger truth: shipped envelopes are the ONLY cross-boundary cost of the
fan-out (measured in ``Fabric.cross_bytes`` like all channel traffic); local
replica reads and watch deliveries touch no fabric path at all.
``benchmarks/control_plane.py``'s locality + notify blocks gate both the
cross-bytes-per-read and the cross-bytes-per-notify win.
"""
from __future__ import annotations

import bisect
from collections import Counter, deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.overwatch import OverwatchService, ReplicaState
from repro_torch.core.transport import DeliveryError, Envelope

# The remote-read vocabulary: discovery, telemetry, queue depths, autoscaler
# fleet state, and per-cluster metrics snapshots (the flight recorder's
# export — published only when ``metrics_every`` is set, so the prefix is
# free otherwise). Deliberately excludes the high-churn per-entity ``/jobs/``
# keyspace — placements/statuses are the dispatcher's (master-local) concern,
# and shipping them to every cluster would be the fan-out's own traffic storm.
REPLICA_PREFIXES: Tuple[str, ...] = ("/clusters/", "/telemetry/", "/queues/",
                                     "/autoscale/", "/metrics/", "/sys/")

# Per-watcher pending-queue cap (RingLog discipline): generous enough that a
# healthy watcher never sees it, small enough that a permanently raising
# callback bounds its own memory instead of the whole replica's.
WATCH_QUEUE_LIMIT = 4096


class _LocalWatch:
    """One replica watch subscription: a prefix, a callback, and a bounded
    pending queue that survives a raising callback (retried next ship)."""

    __slots__ = ("seq", "prefix", "cb", "batch", "pending", "dropped")

    def __init__(self, seq: int, prefix: str, cb: Callable, batch: bool,
                 limit: Optional[int]):
        self.seq = seq
        self.prefix = prefix
        self.cb = cb
        self.batch = batch
        self.pending: deque = deque(maxlen=limit)
        self.dropped = 0


class LocalReplica(ReplicaState):
    """A cluster-local, prefix-scoped overwatch snapshot fed by shipped
    deltas — both the bounded-staleness read surface and the local watch
    plane. ``lag`` is measured against the master clock stamped into the
    last applied ship — infinite until the first ship lands, so a replica
    that has never synced can never satisfy a staleness bound."""

    def __init__(self, prefixes: Tuple[str, ...] = REPLICA_PREFIXES,
                 watch_queue_limit: Optional[int] = WATCH_QUEUE_LIMIT):
        super().__init__()
        self.prefixes = tuple(prefixes)
        self.synced_at: Optional[float] = None
        self.watch_queue_limit = watch_queue_limit
        self.stats: Counter = Counter()      # batches/events/watch counters
        self._watches: List[_LocalWatch] = []
        self._watch_seq = 0

    def covers(self, prefix: str) -> bool:
        """True when every key the prefix could match is inside the shipped
        set (a subscribed prefix of ``""`` covers everything)."""
        return any(prefix.startswith(p) for p in self.prefixes)

    def lag(self, now: float) -> float:
        if self.synced_at is None:
            return float("inf")
        return now - self.synced_at

    # -------------------------------------------------------- the watch plane
    def watch(self, prefix: str,
              cb: Callable[[str, str, object, int], None]) -> _LocalWatch:
        """Per-event subscription: ``cb(event, key, value, rev)`` for every
        shipped delta under ``prefix``, in revision order — the replica-side
        twin of ``OverwatchService.watch``, at zero cross-boundary cost."""
        return self._register_watch(prefix, cb, batch=False)

    def watch_batch(self, prefix: str,
                    cb: Callable[[List[tuple]], None]) -> _LocalWatch:
        """Coalesced subscription: one ``cb(events)`` per applied ship with
        the revision-ordered ``(event, key, value, rev)`` deltas under
        ``prefix`` — the replica-side twin of ``watch_batch``."""
        return self._register_watch(prefix, cb, batch=True)

    def _register_watch(self, prefix: str, cb: Callable,
                        batch: bool) -> _LocalWatch:
        if not self.covers(prefix):
            raise ValueError(
                f"replica does not ship prefix {prefix!r} "
                f"(shipped: {self.prefixes})")
        self._watch_seq += 1
        w = _LocalWatch(self._watch_seq, prefix, cb, batch,
                        self.watch_queue_limit)
        self._watches.append(w)
        return w

    def unwatch(self, watch: _LocalWatch) -> None:
        try:
            self._watches.remove(watch)
        except ValueError:
            pass

    def _enqueue(self, events: List[tuple]) -> None:
        for w in self._watches:
            pend, limit = w.pending, w.pending.maxlen
            for ev in events:
                if ev[1].startswith(w.prefix):
                    if limit is not None and len(pend) == limit:
                        # RingLog discipline: the deque drops the OLDEST
                        # pending event; account for it before it vanishes
                        w.dropped += 1
                        self.stats["watch_dropped"] += 1
                    pend.append(ev)

    def _drain_watches(self) -> None:
        """Deliver pending events watcher-by-watcher in subscription order
        (events within a watcher are revision-ordered). A raising callback
        keeps its undelivered events queued — no event is lost to an
        exception, only (eventually) to the bounded queue."""
        for w in self._watches:
            if not w.pending:
                continue
            if w.batch:
                events = list(w.pending)
                try:
                    w.cb(events)
                except Exception:            # noqa: BLE001
                    self.stats["watch_errors"] += 1
                    continue
                w.pending.clear()
                self.stats["watch_callbacks"] += 1
                self.stats["watch_events"] += len(events)
            else:
                while w.pending:
                    event, key, value, rev = w.pending[0]
                    try:
                        w.cb(event, key, value, rev)
                    except Exception:        # noqa: BLE001
                        self.stats["watch_errors"] += 1
                        break
                    w.pending.popleft()
                    self.stats["watch_callbacks"] += 1
                    self.stats["watch_events"] += 1

    # ------------------------------------------------------------ feed intake
    def apply_ship(self, batch: dict) -> int:
        """Apply one shipped delta envelope; returns the applied revision
        (the cumulative ack the shipper records), then drives the local
        watch plane.

        Exactly-once notify: events at or below the previous horizon are
        cumulative redelivery (the ack for an applied ship was lost) — they
        re-apply harmlessly to the snapshot but are NOT re-delivered to
        watchers. A ``reset`` batch (crash recovery re-seeded this feed from
        a state the replica's horizon predates) drops the local snapshot
        first — keys deleted between the horizon and the crash have no
        tombstone anywhere to ship — and watcher delivery becomes the DIFF
        against the pre-reset snapshot: synthesized ``delete`` events for
        keys that vanished, puts only for keys whose value actually changed,
        silence for state the watcher already holds."""
        prior_rev = self.applied_rev
        events = batch["events"]
        if batch.get("reset"):
            old = dict(self._kv)
            self._kv.clear()
            self._keys = []
            self._added.clear()
            self._removed.clear()
            self.applied_rev = 0
            self.apply_events(events)
            fresh = []
            explicit_deletes = set()
            for event, key, value, rev in events:
                if event == "delete":
                    explicit_deletes.add(key)
                    if key in old:
                        fresh.append((event, key, None, rev))
                elif key not in old or old[key] != value:
                    fresh.append((event, key, value, rev))
            top = max(batch["rev"], self.applied_rev)
            for key in sorted(old):
                if key not in self._kv and key not in explicit_deletes:
                    fresh.append(("delete", key, None, top))
            self.stats["resets"] += 1
        else:
            self.apply_events(events)
            fresh = [ev for ev in events if ev[3] > prior_rev]
        if batch["rev"] > self.applied_rev:
            self.applied_rev = batch["rev"]
        self.synced_at = batch["clock"]
        self.stats["batches"] += 1
        self.stats["events"] += len(events)
        if fresh and self._watches:
            self._enqueue(fresh)
        # drain unconditionally: a watcher whose callback raised last ship
        # gets its retained queue retried even by an empty freshness beacon
        self._drain_watches()
        return self.applied_rev


class ReplicaView:
    """A watch-materialized dict over one shipped prefix: the cluster-local
    analogue of the dispatcher's master-side materialized views. Seeded from
    the replica snapshot at construction, then maintained purely from the
    local watch plane — reads never touch the fabric; freshness is the
    replica's own ship lag."""

    def __init__(self, replica: LocalReplica, prefix: str):
        self.replica = replica
        self.prefix = prefix
        self._items: Dict[str, object] = dict(replica.range_items(prefix))
        replica.watch_batch(prefix, self._ingest)

    def _ingest(self, events: List[tuple]) -> None:
        items = self._items
        for event, key, value, _rev in events:
            if event == "delete":
                items.pop(key, None)
            else:
                items[key] = value

    def fresh(self, now: float, max_lag: float) -> bool:
        return self.replica.lag(now) <= max_lag

    def get(self, key: str, default=None):
        return self._items.get(key, default)

    def items(self) -> Dict[str, object]:
        return dict(self._items)

    def __len__(self) -> int:
        return len(self._items)


class _Feed:
    """One cluster's feed state: the cumulative-ack horizon (every log entry
    above it is owed to this cluster) plus, until the first confirmed ship,
    the bootstrap snapshot of the shipped prefixes."""

    __slots__ = ("acked_rev", "seed", "reset")

    def __init__(self, acked_rev: int, seed: Dict[str, tuple],
                 reset: bool = False):
        self.acked_rev = acked_rev
        self.seed = seed                      # key -> (event, value, rev)
        # crash recovery re-seeded this feed from scratch: the first ship
        # carries a reset marker so the replica drops state the seed cannot
        # tombstone (cleared once a ship is confirmed)
        self.reset = reset


class ReplicaShipper:
    """Master-side fan-out publisher: one coalesced envelope per cluster per
    sweep, cumulative-ack resume across channel death and partition."""

    def __init__(self, overwatch: OverwatchService,
                 send_fn: Callable[[str, dict], dict],
                 prefixes: Tuple[str, ...] = REPLICA_PREFIXES):
        self.ow = overwatch
        self.send_fn = send_fn               # (cluster, msg) -> agent response
        self.prefixes = tuple(prefixes)
        self._feeds: Dict[str, _Feed] = {}
        # the shared delta log: latest state per key + a rev-ordered index so
        # each ship walks only the entries above that cluster's horizon.
        # Index entries whose key has since re-coalesced are skipped lazily.
        self._log: Dict[str, tuple] = {}     # key -> (event, value, rev)
        self._order: List[Tuple[int, str]] = []        # (rev, key), appended
        # highest revision the shipper has actually INGESTED — the ack
        # horizon may never pass it, or events still pending in a coalesced
        # watch queue would be skipped by every later ship
        self._seen_rev = 0
        self.stats: Counter = Counter()
        overwatch.watch_batch("", self._on_events)

    # ------------------------------------------------------------- membership
    def register(self, cluster: str, reset: bool = False) -> None:
        """Start feeding a cluster: snapshot the shipped prefixes at the
        current revision — the first successful ship bootstraps the replica
        from empty, everything after rides the shared log.

        Idempotent for a live feed: a duplicate registration (an agent
        retrying after a timed-out ack, a racing re-add) leaves the existing
        horizon and pending seed untouched — re-seeding here would re-ship
        the full bootstrap snapshot AND reset the cumulative-ack horizon,
        re-delivering everything the replica already applied. ``reset=True``
        (crash recovery with an unreachable replica whose horizon is
        unknowable) marks the first ship so the replica drops state the
        fresh seed cannot tombstone."""
        if cluster in self._feeds:
            self.stats["duplicate_registers"] += 1
            return
        rev = self.ow._rev
        seed: Dict[str, tuple] = {}
        for p in self.prefixes:
            items = self.ow.handle({"op": "range", "prefix": p})["items"]
            for k, v in items.items():
                seed[k] = ("put", v, rev)
        self._feeds[cluster] = _Feed(acked_rev=rev, seed=seed, reset=reset)

    def unregister(self, cluster: str) -> None:
        """Stop feeding (cluster tombstoned): the next compaction is free to
        drop whatever only this cluster still owed."""
        self._feeds.pop(cluster, None)

    def register_resume(self, cluster: str, applied_rev: int,
                        tail: List[tuple], tail_base: int) -> bool:
        """Crash-recovery feed resume. ``tail`` is the recovered overwatch's
        replayed-event list (revision-ordered) and ``tail_base`` the highest
        shard-snapshot revision — everything at or below ``tail_base`` exists
        only as folded snapshot state, not as replayable events.

        If the cluster's replica horizon (``applied_rev``) is at or above
        ``tail_base``, every event it missed is in the tail: seed exactly the
        tail entries above its horizon and resume cumulatively — the replica
        never re-downloads state it already holds. A horizon below
        ``tail_base`` cannot be caught up by deltas (deletions between the
        horizon and the snapshot left no replayable tombstone), and a horizon
        ABOVE the recovered store's revision means the replica applied ships
        the store then lost (should be impossible — ships run after the
        durability commit — but an anomaly must not poison the notify path's
        revision dedupe): both fall back to a full bootstrap seed with a
        reset marker. Returns True when the feed resumed from the horizon,
        False on full reseed."""
        if applied_rev < tail_base or applied_rev > self.ow._rev:
            self.register(cluster, reset=True)
            return False
        seed: Dict[str, tuple] = {}
        for event, key, value, rev in tail:
            if rev > applied_rev and any(key.startswith(p)
                                         for p in self.prefixes):
                seed[key] = (event, value, rev)
        self._feeds[cluster] = _Feed(acked_rev=applied_rev, seed=seed)
        # the recovered primary's revision is fully covered by (replica state
        # up to applied_rev) + this seed: let ship revs advance to it even
        # before the first post-recovery mutation lands in the watch log
        self._seen_rev = max(self._seen_rev, self.ow._rev)
        return True

    # ----------------------------------------------------------- event intake
    def _on_events(self, events: List[tuple]) -> None:
        """O(matching events), independent of the cluster count."""
        prefixes = self.prefixes
        log, order = self._log, self._order
        for event, key, value, rev in events:
            if rev > self._seen_rev:
                self._seen_rev = rev
            if any(key.startswith(p) for p in prefixes):
                log[key] = (event, value, rev)
                order.append((rev, key))

    # --------------------------------------------------------------- shipping
    def _build_msg(self, feed: _Feed) -> Envelope:
        """One cluster's envelope: its bootstrap seed (if unconfirmed) plus
        every log delta above its horizon, revision-ordered."""
        merged: Dict[str, tuple] = dict(feed.seed) if feed.seed else {}
        log, order = self._log, self._order
        lo = bisect.bisect_right(order, (feed.acked_rev, "\U0010ffff"))
        for rev, key in order[lo:]:
            ent = log.get(key)
            if ent is not None and ent[2] == rev:    # else: re-coalesced later
                merged[key] = ent
        events = sorted(((event, key, value, rev)
                         for key, (event, value, rev) in merged.items()),
                        key=lambda ev: ev[3])
        # the ack horizon advances only to what this shipper has INGESTED
        # (or the seed's snapshot revision): stamping the primary's current
        # rev here would leap past events still pending in a coalesced
        # watch queue, and later ships would skip them forever
        batch = {"events": events,
                 "rev": max(feed.acked_rev, self._seen_rev),
                 "clock": self.ow.fabric.clock}
        if feed.reset:
            batch["reset"] = True
        return Envelope({"kind": "replica_batch", "batch": batch})

    def _ship_msg(self, cluster: str, feed: _Feed, msg: Envelope) -> bool:
        """Deliver one (possibly shared) envelope. On failure nothing moves —
        the horizon only advances on a confirmed apply (cumulative ack)."""
        batch = msg["batch"]
        try:
            resp = self.send_fn(cluster, msg)
        except (DeliveryError, KeyError):
            # channel dead / cluster partitioned or already forgotten:
            # nothing applied, nothing to restore — the horizon stands still
            self.stats["ship_failures"] += 1
            return False
        if not resp.get("ok"):
            self.stats["ship_rejected"] += 1
            return False
        feed.acked_rev = resp.get("applied_rev", batch["rev"])
        feed.seed = {}
        feed.reset = False
        self.stats["ships"] += 1
        self.stats["shipped_events"] += len(batch["events"])
        self.stats["shipped_bytes"] += msg.nbytes
        return True

    def ship(self, cluster: str) -> bool:
        """One envelope to one cluster (the single-cluster entry point)."""
        feed = self._feeds.get(cluster)
        if feed is None:
            return False
        return self._ship_msg(cluster, feed, self._build_msg(feed))

    def ship_all(self) -> int:
        """The sweep-cadence fan-out: one envelope per registered cluster,
        then compact the shared log below the laggiest confirmed horizon.
        Returns how many ships landed. Takes the watch barrier first so a
        direct caller (tests, an out-of-band flush) ships the log as of the
        primary's current state, not as of the last flush.

        Feeds sharing an ack horizon (the steady-state fleet: everyone
        confirmed last sweep's ship) share ONE built-and-sized envelope —
        the per-sweep build cost is O(distinct horizons x churn), not
        O(clusters x churn), and the envelope's byte walk happens once."""
        self.ow.flush_watches()
        shared: Dict[int, Envelope] = {}
        landed = 0
        for cluster in sorted(self._feeds):
            feed = self._feeds[cluster]
            if feed.seed or feed.reset:      # bootstrap: unique by definition
                msg = self._build_msg(feed)
            else:
                msg = shared.get(feed.acked_rev)
                if msg is None:
                    msg = shared[feed.acked_rev] = self._build_msg(feed)
            if self._ship_msg(cluster, feed, msg):
                landed += 1
        self._compact()
        return landed

    def _compact(self) -> None:
        """Drop log entries every feed has confirmed. With no feeds the log
        empties outright; with one partitioned cluster it grows only until
        the lease sweep tombstones (and unregisters) it."""
        if not self._feeds:
            if self._order:
                self._log.clear()
                self._order.clear()
            return
        min_acked = min(f.acked_rev for f in self._feeds.values())
        order = self._order
        hi = bisect.bisect_right(order, (min_acked, "\U0010ffff"))
        if not hi:
            return
        log = self._log
        for rev, key in order[:hi]:
            ent = log.get(key)
            if ent is not None and ent[2] == rev:
                del log[key]
        del order[:hi]
