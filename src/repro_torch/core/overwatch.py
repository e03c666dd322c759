"""Copy of ``repro.core.overwatch`` under ``repro_torch``.

Strongly-consistent overwatch service (paper §2.iii) — sharded edition.

A linearizable, versioned KV store with CAS, prefix ranges, leases and watches —
the in-process stand-in for the cloud-managed RDBMS the paper assumes (Spanner/
CloudSQL behind the same interface). Every mutation gets a monotonically
increasing revision and lands on an op-log, so reads are trivially serializable
and tests can assert linearizability.

It is HOSTED on the master cluster: remote control agents reach it through the
fabric (gateway channels), so overwatch traffic is part of the measured
cross-boundary byte budget and cluster partitions make it unreachable — exactly
the failure mode the lease-based failure detector exists for.

Leases: registration keys attach to a lease; heartbeats are keepalives. A lease
that misses its TTL expires, its keys are deleted, and watchers (the dispatcher's
failure detector) see the tombstones.

Architecture (the sharding overhaul):

  * ``OverwatchShard`` — one slice of the keyspace: a ``_kv`` dict, a sorted
    ``_keys`` index (``range(prefix)`` is O(log n + |result|) after a lazy
    compaction step — mutations record index edits in O(1) sets and the next
    ``range`` folds them in, so put-heavy workloads never pay the O(n) sorted
    insert), per-shard op counters and first-segment watch buckets. This is
    the old single-store logic, extracted.
  * ``ShardRouter`` — a consistent-hash ring (crc32 over routing segments,
    ``vnodes`` virtual nodes per shard), so each shard owns a contiguous slice
    of the ring and adding shards moves only ~1/N of the segments. The routing
    segment is the first path segment (``/clusters/a`` -> ``clusters``),
    extended to two segments for per-entity namespaces (``/jobs/job-7/status``
    -> ``jobs/job-7``) so the dominant ``/jobs`` keyspace spreads across
    shards instead of hotspotting one. A prefix that pins a complete routing
    segment (``/clusters/...``, ``/jobs/job-7/...``) is served by exactly one
    shard; anything shorter (``/jobs/``) fans out and merges.
  * ``OverwatchService`` — the front-end. It preserves the exact
    ``handle()``/``watch()`` API of the unsharded store (``num_shards=1`` is
    behavior-compatible with the pre-shard implementation), owns the shared
    revision clock, op-log, and lease table, and registers one fabric endpoint
    per shard at ``(ip, port + 1 + shard)`` so clients can route around the
    front-end hop.
  * ``OverwatchReplica`` — a bounded-staleness read replica for telemetry
    consumers: a revision-tagged snapshot maintained from the watch event
    stream. ``range_stale(prefix, max_lag)`` serves from it whenever the
    replica lags the primary by at most ``max_lag`` fabric-clock units and
    catches up (one flush) otherwise; linearizable reads stay on the primary.
    The snapshot machinery lives in ``ReplicaState``, shared with the
    per-cluster ``repro_torch.core.replica.LocalReplica`` (the fan-out overhaul):
    the master ships each cluster one coalesced delta envelope per sweep and
    ``OverwatchClient.range_stale`` serves in-bound reads from the local
    snapshot with ZERO fabric traffic, falling back to this primary-side
    replica only when the local one is out of bound or absent.

Coalesced watch delivery (``coalesce_watches=True``): mutations enqueue
``(event, key, value, rev)`` into per-shard batches instead of firing callbacks
synchronously. Batches flush once per fabric tick (``sweep()``), and on the
dispatcher's read barriers, so a 5k-job recovery storm delivers O(watchers)
batched callbacks instead of O(mutations) synchronous ones. ``watch_batch``
subscribers receive the whole revision-ordered event list in one call;
legacy ``watch`` subscribers still get per-event callbacks (deferred to the
flush). With coalescing off (the default) both kinds fire synchronously per
mutation, exactly like the pre-batching implementation.

Choosing shard counts: shards only pay off once a single store object is both
hot and large — each shard adds one fabric endpoint and (for remote clusters)
one gateway tunnel. 1 shard up to ~100 clusters, 4 shards for the
1024-cluster/50k-job regime benchmarked in ``benchmarks/control_plane.py``;
more than 8 is wasted until multiple masters serve shards from separate
processes (the ROADMAP's multi-master step this refactor enables).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import zlib
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.transport import (Address, Envelope, Fabric, RingLog,
                                  StaleEpochError)

OVERWATCH_PORT = 7000
OVERWATCH_IP = "10.0.0.2"

# key ops route by req["key"]; everything else is front-end logic
_KEY_OPS = ("put", "get", "delete", "cas")


@dataclasses.dataclass
class Lease:
    lease_id: int
    ttl: float
    expires_at: float
    keys: set


def _first_segment(path: str) -> Optional[str]:
    """``/clusters/onprem-a`` -> ``clusters``; None when there is no full
    leading segment (e.g. ``""`` or ``"/clu"``) and the watcher must stay in
    the catch-all bucket."""
    if not path.startswith("/"):
        return None
    end = path.find("/", 1)
    if end < 0:
        return None
    return path[1:end]


def _sorted_insert(keys: List[str], key: str) -> None:
    i = bisect.bisect_left(keys, key)
    if i == len(keys) or keys[i] != key:
        keys.insert(i, key)


def _sorted_discard(keys: List[str], key: str) -> None:
    i = bisect.bisect_left(keys, key)
    if i < len(keys) and keys[i] == key:
        del keys[i]


# below this many pending index edits, patch the sorted list in place
# (O(t log n + t·n) memmove); above it, one re-sort is cheaper
_COMPACT_THRESHOLD = 32


def _fold_index_edits(keys: List[str], added: set, removed: set) -> List[str]:
    """Fold deferred index edits into a sorted key list (shared by the shard
    and the replica: mutations stay O(1), readers pay amortized compaction).
    Returns the compacted list and clears the edit sets."""
    if added or removed:
        if len(added) + len(removed) <= _COMPACT_THRESHOLD:
            for k in removed:
                _sorted_discard(keys, k)
            for k in added:
                _sorted_insert(keys, k)
        else:
            live = set(keys)
            live -= removed
            live |= added
            keys = sorted(live)
        added.clear()
        removed.clear()
    return keys


def _prefix_slice(keys: List[str], prefix: str) -> Tuple[int, int]:
    """[lo, hi) slice of a sorted key list covered by ``prefix`` (the
    successor-prefix upper bound; empty prefix spans everything)."""
    lo = bisect.bisect_left(keys, prefix)
    if prefix:
        hi = bisect.bisect_left(keys, prefix[:-1] + chr(ord(prefix[-1]) + 1),
                                lo)
    else:
        hi = len(keys)
    return lo, hi


# Namespaces whose second segment joins the routing key: /jobs/<id> is the
# dominant, per-entity keyspace (a placement + status row per job), so routing
# it as one unit would hotspot a single shard with ~98% of the keys. Routing
# /jobs/<id>/... by "jobs/<id>" spreads jobs across shards while keeping each
# job's keys (and any /jobs/<id>/ prefix range or watch) on one shard.
# Part of the client/server wire contract, like the ring parameters.
_DEEP_NAMESPACES = frozenset({"jobs"})


def _route_segment(key: str) -> str:
    """Total routing function: the first path segment — extended to the second
    for ``_DEEP_NAMESPACES`` — or the whole key when it has no internal
    structure (``/cfg`` -> ``cfg``, ``cfg`` -> ``cfg``)."""
    if not key.startswith("/"):
        return key
    end = key.find("/", 1)
    if end < 0:
        return key[1:]
    seg = key[1:end]
    if seg in _DEEP_NAMESPACES:
        end2 = key.find("/", end + 1)
        return key[1:end2] if end2 > 0 else key[1:]
    return seg


class ShardRouter:
    """Consistent-hash ring over first path segments.

    Each shard contributes ``vnodes`` virtual nodes; a segment hashes to the
    next vnode clockwise, so every shard owns a set of contiguous hash-ring
    slices and resizing moves only ~1/N of the segments. crc32 keeps placement
    deterministic across processes (clients compute the same routing without
    asking the server). ``seed`` namespaces the ring so other sharded planes
    (the per-family broker router) reuse the same discipline without their
    placements being correlated with the overwatch's.
    """

    def __init__(self, num_shards: int, vnodes: int = 32,
                 seed: str = "overwatch-shard"):
        # ring parameters are part of the wire contract: OverwatchClient
        # rebuilds this ring from the shard COUNT alone (no topology
        # exchange), so the vnode count and seed-string format below must
        # change in lockstep on both sides — see OverwatchClient.__init__
        self.num_shards = num_shards
        ring: List[Tuple[int, int]] = []
        for s in range(num_shards):
            for v in range(vnodes):
                h = zlib.crc32(f"{seed}-{s}/vnode-{v}".encode())
                ring.append((h & 0xFFFFFFFF, s))
        ring.sort()
        self._ring = ring
        self._hashes = [h for h, _ in ring]
        self._seg_cache: Dict[str, int] = {}

    def shard_for_segment(self, seg: str) -> int:
        s = self._seg_cache.get(seg)
        if s is None:
            if self.num_shards == 1:
                s = 0
            else:
                h = zlib.crc32(seg.encode()) & 0xFFFFFFFF
                i = bisect.bisect_right(self._hashes, h)
                s = self._ring[i % len(self._ring)][1]
            if len(self._seg_cache) < 65536:
                self._seg_cache[seg] = s
        return s

    def shard_for_key(self, key: str) -> int:
        return self.shard_for_segment(_route_segment(key))

    def shard_for_prefix(self, prefix: str) -> Optional[int]:
        """Owning shard when the prefix pins a complete routing segment
        (``/clusters/...``, or ``/jobs/<id>/...`` for deep namespaces); None
        when it straddles shards and must fan out (e.g. ``/jobs/``)."""
        seg = _first_segment(prefix)
        if seg is None:
            return None
        if seg in _DEEP_NAMESPACES:
            end = prefix.find("/", 1)
            end2 = prefix.find("/", end + 1)
            if end2 < 0:
                return None              # e.g. "/jobs/" spans every job shard
            return self.shard_for_segment(prefix[1:end2])
        return self.shard_for_segment(seg)


class OverwatchShard:
    """One slice of the keyspace: kv + sorted index + watch buckets.

    Mutations ``emit`` watch events through the host: synchronously when
    coalescing is off, into ``_pending`` batches when it is on. Watch entries
    are ``(seq, prefix, cb, is_batch)`` — ``seq`` is the host-global
    registration counter, preserving callback order across shards within each
    subscriber kind (see ``OverwatchService.flush_watches`` for the coalesced
    cross-kind ordering).
    """

    def __init__(self, host: "OverwatchService", shard_id: int):
        self.host = host
        self.shard_id = shard_id
        self._kv: Dict[str, Tuple[Any, int]] = {}
        self._keys: List[str] = []           # sorted index over _kv (compacted)
        self._added: set = set()             # index edits since last compaction
        self._removed: set = set()
        self.op_counts: Counter = Counter()  # ops executed on this shard
        self._watch_buckets: Dict[str, List[tuple]] = {}
        self._watch_catchall: List[tuple] = []
        self._pending: List[tuple] = []      # (rev, event, key, value)
        # bound-method table: the hot path skips per-call getattr/concat
        self._ops: Dict[str, Callable[[dict], dict]] = {
            "put": self._op_put, "get": self._op_get,
            "delete": self._op_delete, "cas": self._op_cas,
            "range": self._op_range,
        }

    # ----------------------------------------------------------------- plumbing
    def apply(self, op: str, req: dict) -> dict:
        self.op_counts[op] += 1
        return self._ops[op](req)

    def _index_add(self, key: str) -> None:
        """O(1): mutations never touch the sorted list; ``range`` compacts."""
        self._added.add(key)
        self._removed.discard(key)

    def _index_discard(self, key: str) -> None:
        self._removed.add(key)
        self._added.discard(key)

    def _compact_index(self) -> None:
        self._keys = _fold_index_edits(self._keys, self._added, self._removed)

    # ------------------------------------------------------------------ watches
    def add_watch(self, entry: tuple) -> None:
        seg = _first_segment(entry[1])
        if seg is not None:
            # any key matching this prefix must start with "/<seg>/", so the
            # bucket lookup is exhaustive for it
            self._watch_buckets.setdefault(seg, []).append(entry)
        else:
            self._watch_catchall.append(entry)

    def matched_watchers(self, key: str) -> List[tuple]:
        seg = _first_segment(key)
        matched = [w for w in self._watch_catchall if key.startswith(w[1])]
        if seg is not None:
            matched += [w for w in self._watch_buckets.get(seg, ())
                        if key.startswith(w[1])]
        matched.sort(key=lambda w: w[0])     # registration order, as before
        return matched

    def emit(self, event: str, key: str, value: Any, rev: int) -> None:
        host = self.host
        if host.coalesce_watches:
            self._pending.append((rev, event, key, value))
            host._note_pending()
            return
        stats = host.watch_stats
        for _, _, cb, is_batch in self.matched_watchers(key):
            stats["callbacks"] += 1
            stats["events"] += 1
            if is_batch:
                cb([(event, key, value, rev)])
            else:
                cb(event, key, value, rev)

    def expire_key(self, key: str) -> None:
        """Lease-expiry tombstone: delete + emit, bumped on the shared clock."""
        if key in self._kv:
            del self._kv[key]
            self._index_discard(key)
            rev = self.host._bump("expire", key)
            if self.host._dur is not None:
                self.host._dur.append(self.host._shard_names[self.shard_id],
                                      ("del", key, rev))
            self.emit("delete", key, None, rev)

    # --------------------------------------------------------------------- ops
    def _op_put(self, req: dict) -> dict:
        key, value = req["key"], req["value"]
        lease = None
        if req.get("lease"):
            # validate BEFORE mutating: a rejected put must leave no trace in
            # the kv/revision clock, or the store and the watch-derived views
            # would diverge forever (the error path emits no event)
            lease = self.host._leases.get(req["lease"])
            if lease is None:
                return {"ok": False, "error": "lease expired or unknown"}
        rev = self.host._bump("put", key, value)
        if key not in self._kv:
            self._index_add(key)
        self._kv[key] = (value, rev)
        if lease is not None:
            lease.keys.add(key)
        if self.host._dur is not None:
            self.host._dur.append(self.host._shard_names[self.shard_id],
                                  ("put", key, value, rev, req.get("lease")))
        self.emit("put", key, value, rev)
        return {"ok": True, "revision": rev}

    def _op_get(self, req: dict) -> dict:
        ent = self._kv.get(req["key"])
        if ent is None:
            return {"ok": True, "value": None, "revision": None}
        return {"ok": True, "value": ent[0], "revision": ent[1]}

    def _op_delete(self, req: dict) -> dict:
        key = req["key"]
        if key in self._kv:
            del self._kv[key]
            self._index_discard(key)
            rev = self.host._bump("delete", key)
            if self.host._dur is not None:
                self.host._dur.append(self.host._shard_names[self.shard_id],
                                      ("del", key, rev))
            self.emit("delete", key, None, rev)
            return {"ok": True, "revision": rev}
        return {"ok": True, "revision": None}

    def _op_cas(self, req: dict) -> dict:
        """Compare-and-swap on revision (None => create-if-absent)."""
        key, expect = req["key"], req["expect_revision"]
        ent = self._kv.get(key)
        cur = ent[1] if ent else None
        if cur != expect:
            return {"ok": True, "swapped": False, "revision": cur}
        rev = self.host._bump("cas", key, req["value"])
        if key not in self._kv:
            self._index_add(key)
        self._kv[key] = (req["value"], rev)
        if self.host._dur is not None:
            self.host._dur.append(self.host._shard_names[self.shard_id],
                                  ("put", key, req["value"], rev, None))
        self.emit("put", key, req["value"], rev)
        return {"ok": True, "swapped": True, "revision": rev}

    def _op_range(self, req: dict) -> dict:
        items = self.range_items(req["prefix"])
        return {"ok": True, "items": items}

    def range_items(self, prefix: str) -> Dict[str, Any]:
        self._compact_index()
        lo, hi = _prefix_slice(self._keys, prefix)
        return {k: self._kv[k][0] for k in self._keys[lo:hi]}


class ReplicaState:
    """A revision-tagged snapshot maintained from a watch event stream — the
    shared substrate of the master-side ``OverwatchReplica`` and the
    per-cluster ``repro_torch.core.replica.LocalReplica``. Applying events is O(1)
    per event (the sorted read index folds lazily, like the shard's); applying
    an already-applied event is idempotent, so cumulative re-delivery after a
    channel heal converges without deduplication."""

    def __init__(self):
        self._kv: Dict[str, Any] = {}
        self._keys: List[str] = []
        self._added: set = set()             # lazy index edits, like the shard
        self._removed: set = set()
        self.applied_rev = 0

    def apply_events(self, events: List[tuple]) -> None:
        # O(1) per event: a 100k-event catch-up batch must not pay a sorted
        # insert (O(n) memmove) per key inside the read barrier
        for event, key, value, rev in events:
            if event == "delete":
                if key in self._kv:
                    del self._kv[key]
                    self._removed.add(key)
                    self._added.discard(key)
            else:
                if key not in self._kv:
                    self._added.add(key)
                    self._removed.discard(key)
                self._kv[key] = value
            if rev > self.applied_rev:
                self.applied_rev = rev

    def get(self, key: str) -> Any:
        """Point read off the snapshot (the worker depth-gate path)."""
        return self._kv.get(key)

    def range_items(self, prefix: str) -> Dict[str, Any]:
        self._keys = _fold_index_edits(self._keys, self._added, self._removed)
        lo, hi = _prefix_slice(self._keys, prefix)
        return {k: self._kv[k] for k in self._keys[lo:hi]}


class OverwatchReplica(ReplicaState):
    """Master-side bounded-staleness read replica: kept current by subscribing
    a batch watcher to every shard. With coalescing on it lags the primary by
    at most one flush interval; ``range_stale`` decides whether that lag is
    acceptable or forces a catch-up."""

    def __init__(self, host: "OverwatchService"):
        super().__init__()
        for shard in host.shards:            # host flushed pending beforehand
            for k, (v, rev) in shard._kv.items():
                self._kv[k] = v
        self._keys = sorted(self._kv)
        self.applied_rev = host._rev
        host._register(("", self.apply_events), batch=True)


class OverwatchService:
    """The sharded store's front-end (runs on the master cluster).

    Owns the shared revision clock, op-log, lease table, and watch delivery;
    routes key ops to shards. ``num_shards=1`` with ``coalesce_watches=False``
    (the defaults) reproduces the unsharded, synchronous-notify store exactly.
    """

    def __init__(self, fabric: Fabric, cluster: str,
                 addr: Address = (OVERWATCH_IP, OVERWATCH_PORT),
                 op_log_limit: Optional[int] = None,
                 num_shards: int = 1,
                 coalesce_watches: bool = False,
                 durability=None, snapshot_every: int = 4096):
        self.fabric = fabric
        self.cluster = cluster
        self.addr = addr
        self.coalesce_watches = coalesce_watches
        self._rev = 0
        self.op_log: RingLog = RingLog(op_log_limit)
        self.op_counts: Counter = Counter()  # every handled op, reads included
        self._leases: Dict[int, Lease] = {}
        self._lease_n = 0                    # last granted lease id
        self._expiry_heap: List[Tuple[float, int]] = []
        self._sweeping = False
        # durability (repro_torch.core.durability.LogStore): one WAL shard per kv
        # shard (kv mutations, rev-stamped) plus a meta shard (lease table,
        # lease-id clock). Group commit rides sweep(); snapshot+truncate when
        # a shard's log passes snapshot_every records. None => byte-identical
        # to the in-memory-only store.
        self._dur = durability
        self.snapshot_every = snapshot_every
        self._shard_names = [f"ow-shard-{i}" for i in range(max(1, num_shards))]
        self._meta_name = "ow-meta"
        self.recovery_tail: List[tuple] = []   # replayed events, rev-ordered
        self.recovery_base_rev = 0             # max shard-snapshot rev
        self.recovery_stats: Dict[str, Any] = {}
        # watch registrations: seq preserves global callback ordering across
        # shards and buckets; per-shard buckets bound how many registrations a
        # mutation consults
        self._watch_seq = itertools.count()
        self.watch_stats: Counter = Counter()   # callbacks + events delivered
        self.router = ShardRouter(max(1, num_shards))
        self.shards: List[OverwatchShard] = [
            OverwatchShard(self, i) for i in range(self.router.num_shards)]
        self._pending_since: Optional[float] = None
        self._delivering = False
        self._replica: Optional[OverwatchReplica] = None
        # multi-master fencing: when armed (set_fence), writes to a frozen /
        # failed-over shard bounce with a stale-epoch hint and epoch-stamped
        # requests are checked against the shard map. None (single-master)
        # keeps every path byte-identical to the seed plane.
        self._fence = None
        fabric.register_handler(cluster, addr, self.handle)
        # one endpoint per shard, so shard-aware clients skip the front-end hop
        for i in range(len(self.shards)):
            fabric.register_handler(
                cluster, (addr[0], addr[1] + 1 + i),
                lambda req, _i=i: self._dispatch(req, self.shards[_i]))
        if self._dur is not None and (
                self._dur.has_data(self._meta_name)
                or any(self._dur.has_data(n) for n in self._shard_names)):
            self.recover()

    # ----------------------------------------------------------------- plumbing
    def handle(self, req: dict) -> dict:
        return self._dispatch(req, None)

    def _dispatch(self, req: dict, shard: Optional[OverwatchShard]) -> dict:
        self._sweep_leases()
        op = req["op"]
        self.op_counts[op] += 1
        try:
            if op in _KEY_OPS:
                target = shard if shard is not None else \
                    self.shards[self.router.shard_for_key(req["key"])]
                if self._fence is not None and op != "get":
                    bounce = self._fence_check(req, target)
                    if bounce is not None:
                        return bounce
                return target.apply(op, req)
            if op == "range":
                if shard is None:
                    sid = self.router.shard_for_prefix(req["prefix"])
                    shard = self.shards[sid] if sid is not None else None
                if shard is not None:
                    return shard.apply("range", req)
                return self._range_fanout(req)
            fn = getattr(self, "_op_" + op, None)
            if fn is None:
                return {"ok": False, "error": f"unknown op {op}"}
            return fn(req)
        except Exception as e:              # noqa: BLE001 - surfaced to caller
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _bump(self, op: str, key: str, value: Any = None) -> int:
        self._rev += 1
        self.op_log.append((self._rev, op, key, value))
        return self._rev

    def _range_fanout(self, req: dict) -> dict:
        """Prefix straddles shards: merge each shard's slice, re-sorted."""
        merged: Dict[str, Any] = {}
        for shard in self.shards:
            merged.update(shard.apply("range", req)["items"])
        return {"ok": True, "items": {k: merged[k] for k in sorted(merged)}}

    # ---------------------------------------------------------- epoch fencing
    def set_fence(self, coordinator) -> None:
        """Arm multi-master fencing (a ``repro_torch.core.shardmap``
        ``ShardMapCoordinator``): writes consult the shard map before
        applying. Reads always serve — a frozen or failing-over shard acts
        as a replica of itself until the flip lands."""
        self._fence = coordinator

    def _fence_check(self, req, shard: "OverwatchShard") -> Optional[dict]:
        """None to proceed, or the bounce response: the shard is frozen
        (mid-migration / owner dead), or the request carries a stale map
        epoch. The bounce piggybacks the CURRENT epoch — the client's map
        refresh costs zero extra round-trips."""
        fence = self._fence
        name = self._shard_names[shard.shard_id]
        cur = fence.map.epoch
        if fence.frozen(name):
            fence.note_stale(name)
            return {"ok": False, "error": "shard frozen (migrating)",
                    "stale_epoch": True, "frozen": True, "epoch": cur}
        e = req.get("epoch")
        if e is not None and e != cur:
            fence.note_stale(name)
            return {"ok": False,
                    "error": f"stale epoch {e} (current {cur})",
                    "stale_epoch": True, "frozen": False, "epoch": cur}
        return None

    # -------------------------------------------------------------------- leases
    def _sweep_leases(self) -> None:
        # watch callbacks can re-enter handle() -> _sweep_leases(); pop each
        # expired lease BEFORE notifying so reentrant sweeps never double-free.
        if self._sweeping:
            return
        now = self.fabric.clock
        heap = self._expiry_heap
        if not heap or heap[0][0] > now:
            return
        self._sweeping = True
        try:
            while heap and heap[0][0] <= now:
                expires_at, lid = heapq.heappop(heap)
                lease = self._leases.get(lid)
                if lease is None or lease.expires_at != expires_at:
                    continue                 # stale entry (keepalive or gone)
                if self._fence is not None and any(
                        self._fence.frozen(self._shard_names[
                            self.router.shard_for_key(k)])
                        for k in lease.keys):
                    # a key's shard is mid-migration: expiring now would
                    # mutate state behind its transferred snapshot. Defer the
                    # WHOLE lease one clock unit (a short grace) — expiry is
                    # delayed past the flip, never lost or half-applied.
                    lease.expires_at = now + 1.0
                    heapq.heappush(heap, (lease.expires_at, lid))
                    continue
                del self._leases[lid]
                if self._dur is not None:
                    self._dur.append(self._meta_name, ("lx", lid))
                for key in sorted(lease.keys):
                    self.shards[self.router.shard_for_key(key)].expire_key(key)
        finally:
            self._sweeping = False

    def _op_lease_grant(self, req: dict) -> dict:
        self._lease_n += 1
        lid = self._lease_n
        ttl = float(req["ttl"])
        expires = self.fabric.clock + ttl
        self._leases[lid] = Lease(lid, ttl, expires, set())
        heapq.heappush(self._expiry_heap, (expires, lid))
        if self._dur is not None:
            self._dur.append(self._meta_name, ("lg", lid, ttl, expires))
        return {"ok": True, "lease": lid}

    def _op_lease_keepalive(self, req: dict) -> dict:
        lease = self._leases.get(req["lease"])
        if lease is None:
            return {"ok": False, "error": "lease expired or unknown"}
        lease.expires_at = self.fabric.clock + lease.ttl
        heapq.heappush(self._expiry_heap, (lease.expires_at, lease.lease_id))
        if self._dur is not None:
            self._dur.append(self._meta_name,
                             ("lk", lease.lease_id, lease.expires_at))
        return {"ok": True}

    # ----------------------------------------------------- topology / replica ops
    def _op_shard_map(self, req: dict) -> dict:
        resp = {"ok": True, "num_shards": len(self.shards),
                "ports": [self.addr[1] + 1 + i
                          for i in range(len(self.shards))]}
        if self._fence is not None:
            resp["epoch"] = self._fence.map.epoch
            resp["assignment"] = dict(self._fence.map.assignment)
            resp["frozen"] = self._fence.frozen_names()
        return resp

    def _op_range_stale(self, req: dict) -> dict:
        """Bounded-staleness range off the replica snapshot. Serves the current
        replica state when its lag is within ``max_lag`` fabric-clock units;
        otherwise catches up (one flush) first. The bound is never silently
        violated: if the catch-up flush cannot run (the caller sits inside an
        active flush, where nested barriers are no-ops) the read falls back to
        the linearizable primary — fresher than asked, never staler."""
        max_lag = float(req.get("max_lag", 0.0))
        prefix = req["prefix"]
        if self._replica is None:
            self.flush_watches()             # snapshot from a quiesced stream
            self._replica = OverwatchReplica(self)
        lag = self._replica_lag()
        if lag > max_lag:
            self.flush_watches()
            lag = self._replica_lag()
        if lag > max_lag:
            sid = self.router.shard_for_prefix(prefix)
            shards = self.shards if sid is None else [self.shards[sid]]
            merged: Dict[str, Any] = {}
            for shard in shards:
                merged.update(shard.range_items(prefix))
            return {"ok": True,
                    "items": {k: merged[k] for k in sorted(merged)},
                    "lag": 0.0, "replica_rev": self._rev}
        items = self._replica.range_items(prefix)
        return {"ok": True, "items": items, "lag": lag,
                "replica_rev": self._replica.applied_rev}

    def _replica_lag(self) -> float:
        if self._pending_since is None:
            return 0.0
        return self.fabric.clock - self._pending_since

    # ------------------------------------------------------------- local watches
    def watch(self, prefix: str, cb: Callable[[str, str, Any, int], None]) -> None:
        """Master-side components subscribe to per-event key callbacks."""
        self._register((prefix, cb), batch=False)

    def watch_batch(self, prefix: str,
                    cb: Callable[[List[tuple]], None]) -> None:
        """Batch subscription: one callback per flush with the revision-ordered
        ``[(event, key, value, rev), ...]`` list (singleton lists when
        coalescing is off)."""
        self._register((prefix, cb), batch=True)

    def _register(self, prefix_cb: tuple, batch: bool) -> None:
        prefix, cb = prefix_cb
        entry = (next(self._watch_seq), prefix, cb, batch)
        sid = self.router.shard_for_prefix(prefix)
        targets = [self.shards[sid]] if sid is not None else self.shards
        for shard in targets:
            shard.add_watch(entry)

    # --------------------------------------------------------- coalesced delivery
    def _note_pending(self) -> None:
        if self._pending_since is None:
            self._pending_since = self.fabric.clock

    def flush_watches(self) -> None:
        """Deliver coalesced batches; the read barrier for view consumers.

        Loops until quiescent: callbacks that mutate (the dispatcher's recovery
        storm) enqueue fresh events that flush in the next round — so a storm
        costs O(watchers x rounds) invocations, not O(mutations). No-op when
        coalescing is off, nothing is pending, or a flush is already running
        (nested barriers fold into the outer loop).

        Delivery order within a round: per-event (legacy ``watch``) subscribers
        fire during the revision-ordered walk, in (rev, seq) order; batch
        subscribers then fire once each, in registration (seq) order, with
        their full event lists. A raising callback does NOT lose events — the
        round finishes delivering to everyone else and the first exception
        re-raises at the barrier (synchronous notify lost at most the
        remaining watchers of one event; losing a whole round would leave the
        watch-derived views divergent forever).
        """
        if not self.coalesce_watches or self._delivering:
            return
        if self._pending_since is None:
            return
        self._delivering = True
        stats = self.watch_stats
        errors: List[BaseException] = []
        try:
            while True:
                merged: List[tuple] = []
                for shard in self.shards:
                    if shard._pending:
                        pend, shard._pending = shard._pending, []
                        for ev in pend:
                            merged.append((ev[0], shard, ev))
                if not merged:
                    self._pending_since = None
                    break
                merged.sort(key=lambda x: x[0])      # global revision order
                batches: Dict[int, Tuple[Callable, list]] = {}
                for rev, shard, (_, event, key, value) in merged:
                    for seq, _, cb, is_batch in shard.matched_watchers(key):
                        if is_batch:
                            if seq not in batches:
                                batches[seq] = (cb, [])
                            batches[seq][1].append((event, key, value, rev))
                        else:
                            stats["callbacks"] += 1
                            stats["events"] += 1
                            try:
                                cb(event, key, value, rev)
                            except Exception as e:   # noqa: BLE001
                                errors.append(e)
                for seq in sorted(batches):
                    cb, events = batches[seq]
                    stats["callbacks"] += 1
                    stats["events"] += len(events)
                    try:
                        cb(events)
                    except Exception as e:           # noqa: BLE001
                        errors.append(e)
        finally:
            self._delivering = False
        if errors:
            if len(errors) > 1:
                raise RuntimeError(
                    f"{len(errors)} watch subscribers failed during flush; "
                    f"first: {errors[0]!r}, also: "
                    f"{[repr(e) for e in errors[1:]]}") from errors[0]
            raise errors[0]

    def sweep(self) -> None:
        self._sweep_leases()
        self.flush_watches()
        if self._dur is not None:
            self._commit_durability()

    # ------------------------------------------------------------- durability
    def _commit_durability(self) -> None:
        """Group commit (once per sweep) + snapshot/truncate compaction when a
        shard's replay tail passes ``snapshot_every`` records."""
        dur = self._dur
        for i, name in enumerate(self._shard_names):
            dur.commit(name)
            if dur.records_since_snapshot(name) >= self.snapshot_every:
                dur.snapshot(name, self._shard_snapshot(i))
        dur.commit(self._meta_name)
        if dur.records_since_snapshot(self._meta_name) >= self.snapshot_every:
            dur.snapshot(self._meta_name, self._meta_snapshot())

    def _shard_snapshot(self, i: int) -> dict:
        """Full shard state: kv with revs, plus this shard's slice of the
        lease->key attachments (kept here, not in the meta snapshot, so a
        fresher shard snapshot never loses attachments recorded only in kv
        records the truncation just dropped)."""
        shard = self.shards[i]
        lease_of = {}
        for lid, lease in self._leases.items():
            for k in lease.keys:
                if k in shard._kv:
                    lease_of[k] = lid
        return {"rev": self._rev,
                "kv": {k: [v, rev] for k, (v, rev) in shard._kv.items()},
                "lease_of": lease_of}

    def _meta_snapshot(self) -> dict:
        return {"rev": self._rev, "next_lease": self._lease_n,
                "leases": {str(lid): [l.ttl, l.expires_at]
                           for lid, l in self._leases.items()}}

    # ------------------------------------------------------- shard migration
    def _carry_over(self, i: int, fresh: "OverwatchShard") -> None:
        """Swap ``shards[i]`` for a rebuilt shard object, carrying the parts
        that belong to the FRONT-END's contract rather than the shard's
        state: watch registrations, undelivered coalesced events, and op
        counters (metrics continuity). The per-shard fabric endpoint closes
        over ``self.shards[i]``, so the swap re-points it automatically."""
        old = self.shards[i]
        fresh._watch_buckets = old._watch_buckets
        fresh._watch_catchall = old._watch_catchall
        fresh._pending = old._pending
        fresh.op_counts = old.op_counts
        self.shards[i] = fresh

    def install_shard(self, i: int, payload: dict) -> None:
        """Live-migration import: a fresh shard built from the transferred
        snapshot payload (``_shard_snapshot`` format). The shard was frozen
        between export and install, so the payload IS the current state —
        watchers see nothing, revisions are unchanged, and lease->key
        attachments are restored from the payload."""
        shard = OverwatchShard(self, i)
        for k, ent in payload["kv"].items():
            shard._kv[k] = (ent[0], ent[1])
        shard._keys = sorted(shard._kv)
        for k, lid in payload["lease_of"].items():
            lease = self._leases.get(int(lid))
            if lease is not None:
                lease.keys.add(k)
        self._carry_over(i, shard)

    def rebuild_shard(self, i: int) -> int:
        """Failover rebuild: the owning master died and its uncommitted WAL
        tail is gone. Rebuild the shard from committed snapshot + records,
        then diff the dying shard's in-memory kv — everything watchers were
        already told — against the durable truth and emit repair events at
        FRESH revisions: a lost put becomes a delete tombstone, a lost
        delete (or lost overwrite) becomes a re-put of the durable value.
        Fresh revs are load-bearing — the replica fan-out dedupes on
        ``rev > applied_rev``, so repairs at reused revisions would be
        silently dropped and cluster replicas would diverge forever. The
        repairs are WAL-appended and committed immediately, so a SECOND
        failover replays a state that already includes them. Returns the
        number of repaired keys."""
        old = self.shards[i]
        name = self._shard_names[i]
        shard = OverwatchShard(self, i)
        kv: Dict[str, Tuple[Any, int]] = {}
        payload, recs = self._dur.load(name)
        if payload:
            for k, ent in payload["kv"].items():
                kv[k] = (ent[0], ent[1])
            for k, lid in payload["lease_of"].items():
                lease = self._leases.get(int(lid))
                if lease is not None:
                    lease.keys.add(k)
        for rec in recs:
            if rec[0] == "put":
                kv[rec[1]] = (rec[2], rec[3])
                if rec[4] is not None:
                    lease = self._leases.get(rec[4])
                    if lease is not None:
                        lease.keys.add(rec[1])
            elif rec[0] == "del":
                kv.pop(rec[1], None)
        shard._kv = kv
        shard._keys = sorted(kv)
        self._carry_over(i, shard)
        repaired = 0
        for key in sorted(set(old._kv) | set(kv)):
            durable = kv.get(key)
            seen = old._kv.get(key)
            if durable is None:
                if seen is None:
                    continue
                # watchers saw a put whose record died with the master
                rev = self._bump("expire", key)
                shard.emit("delete", key, None, rev)
                repaired += 1
            elif seen is None or seen[0] != durable[0]:
                # watchers saw a delete/overwrite the WAL never captured:
                # re-assert the durable value at a fresh revision
                rev = self._bump("put", key, durable[0])
                shard._kv[key] = (durable[0], rev)
                self._dur.append(name, ("put", key, durable[0], rev, None))
                shard.emit("put", key, durable[0], rev)
                repaired += 1
        self._dur.commit(name)
        return repaired

    def recover(self) -> None:
        """Rebuild kv, key indexes, lease table, and the revision clock as
        snapshot + WAL replay. LSN filtering in the LogStore guarantees replay
        starts exactly after each shard's snapshot. Recovered leases get a
        grace extension to ``now + ttl`` so surviving agents (whose heartbeat
        timers never stopped) can keep alive before any expiry sweep runs.
        ``recovery_tail`` keeps the replayed events in revision order — the
        replica shipper's resume feed for clusters whose cumulative-ack
        horizon is at or above ``recovery_base_rev``."""
        dur = self._dur
        replayed = 0
        snapshots = 0
        max_rev = 0
        lease_n = 0
        leases: Dict[int, Lease] = {}
        meta_p, meta_recs = dur.load(self._meta_name)
        if meta_p:
            snapshots += 1
            max_rev = meta_p["rev"]
            lease_n = meta_p["next_lease"]
            for lid, (ttl, exp) in meta_p["leases"].items():
                lid = int(lid)
                leases[lid] = Lease(lid, ttl, exp, set())
        for rec in meta_recs:
            replayed += 1
            tag = rec[0]
            if tag == "lg":
                lid = rec[1]
                leases[lid] = Lease(lid, rec[2], rec[3], set())
                lease_n = max(lease_n, lid)
            elif tag == "lk":
                lease = leases.get(rec[1])
                if lease is not None:
                    lease.expires_at = rec[2]
            elif tag == "lx":
                leases.pop(rec[1], None)
        tail: List[tuple] = []
        base_rev = 0
        for i, name in enumerate(self._shard_names):
            shard = self.shards[i]
            payload, recs = dur.load(name)
            if payload:
                snapshots += 1
                base_rev = max(base_rev, payload["rev"])
                max_rev = max(max_rev, payload["rev"])
                for k, ent in payload["kv"].items():
                    shard._kv[k] = (ent[0], ent[1])
                for k, lid in payload["lease_of"].items():
                    lease = leases.get(int(lid))
                    if lease is not None:
                        lease.keys.add(k)
            for rec in recs:
                replayed += 1
                if rec[0] == "put":
                    _, key, value, rev, lid = rec
                    shard._kv[key] = (value, rev)
                    if lid is not None:
                        lease = leases.get(lid)
                        if lease is not None:
                            lease.keys.add(key)
                    tail.append(("put", key, value, rev))
                    max_rev = max(max_rev, rev)
                elif rec[0] == "del":
                    _, key, rev = rec
                    shard._kv.pop(key, None)
                    tail.append(("delete", key, None, rev))
                    max_rev = max(max_rev, rev)
            shard._keys = sorted(shard._kv)
            shard._added.clear()
            shard._removed.clear()
        self._rev = max(self._rev, max_rev)
        self._lease_n = max(self._lease_n, lease_n)
        now = self.fabric.clock
        for lease in leases.values():
            lease.expires_at = max(lease.expires_at, now + lease.ttl)
            heapq.heappush(self._expiry_heap, (lease.expires_at,
                                               lease.lease_id))
        self._leases = leases
        tail.sort(key=lambda ev: ev[3])
        self.recovery_tail = tail
        self.recovery_base_rev = base_rev
        self.recovery_stats = {"replayed": replayed, "snapshots": snapshots,
                               "leases": len(leases), "rev": self._rev}


class OverwatchClient:
    """RPC stub: every call crosses the fabric from ``src_cluster`` to master.

    Shard-aware when given per-shard targets: key ops and single-segment prefix
    ranges go straight to the owning shard's endpoint (``shard_addrs``, for
    master-local clients) or tunnel (``shard_vias``, for remote clusters);
    lease ops and fan-out ranges use the front-end. Without shard targets the
    client behaves exactly like the unsharded original.

    Replica-aware when given a per-cluster ``replica`` (the fan-out overhaul):
    ``range_stale`` is served straight from the local snapshot — zero fabric
    traffic — whenever the replica covers the prefix and its shipped-batch lag
    is within the caller's ``max_lag``; otherwise the read falls back to the
    primary round-trip exactly as before. All other ops (linearizable reads,
    every mutation, leases) always cross to the primary.
    """

    def __init__(self, fabric: Fabric, src_cluster: str, src_id: str,
                 master_cluster: str,
                 addr: Address = (OVERWATCH_IP, OVERWATCH_PORT),
                 via: Optional[Address] = None,
                 shard_addrs: Optional[List[Address]] = None,
                 shard_vias: Optional[List[Address]] = None,
                 replica=None):
        self.fabric = fabric
        self.src_cluster = src_cluster
        self.src_id = src_id
        self.master_cluster = master_cluster
        self.addr = addr
        # remote agents reach the overwatch through their egress gateway mapping
        self.via = via
        self.shard_addrs = shard_addrs
        self.shard_vias = shard_vias
        self.replica = replica          # repro_torch.core.replica.LocalReplica
        # default ring parameters MUST match the service's (wire contract —
        # the client derives placement from the shard count alone)
        n = len(shard_addrs or shard_vias or ())
        self._router = ShardRouter(n) if n > 1 else None
        # multi-master epoch fencing (armed by the plane when a shard-map
        # coordinator exists): writes carry the client's map epoch; a bounce
        # piggybacks the current epoch (the "map refresh") and the write
        # retries once — unless the shard is FROZEN, where an in-instant
        # retry cannot succeed (the simulation is synchronous) and the
        # caller gets a StaleEpochError to retry next tick.
        self.fenced = False
        self._epoch = 0
        self.stats: Counter = Counter()

    def _route(self, req: dict) -> Tuple[str, Address]:
        """(dest_cluster, dest_addr) for this request — shard endpoint for key
        ops when shard routing is configured, front-end otherwise."""
        local = self.src_cluster == self.master_cluster
        if self._router is not None:
            op = req["op"]
            sid: Optional[int] = None
            if op in _KEY_OPS:
                sid = self._router.shard_for_key(req["key"])
            elif op == "range":
                sid = self._router.shard_for_prefix(req["prefix"])
            if sid is not None:
                if local and self.shard_addrs:
                    return self.master_cluster, self.shard_addrs[sid]
                if not local and self.shard_vias:
                    return self.src_cluster, self.shard_vias[sid]
        if local:
            return self.master_cluster, self.addr
        if self.via is None:
            raise RuntimeError(
                "remote overwatch access requires a gateway route (via=)")
        return self.src_cluster, self.via

    # bounded fence retries: stamp -> bounce -> refresh -> restamp -> retry.
    # Two refreshes cover a flip landing between the retry's send and apply.
    _FENCE_ATTEMPTS = 3

    def _call(self, req: dict) -> dict:
        if not self.fenced:
            dst_cluster, dst_addr = self._route(req)
            resp = self.fabric.send(self.src_cluster, self.src_id,
                                    dst_cluster, dst_addr, req)
            if not resp.get("ok", False):
                raise RuntimeError(f"overwatch: {resp.get('error')}")
            return resp
        # epoch-stamp plain-dict writes only: prebuilt Envelopes cache their
        # byte size and must not be mutated (they rely on the server-side
        # frozen check alone — a bounce surfaces as StaleEpochError and the
        # caller's next-tick retry rebuilds the request)
        stamped = (not isinstance(req, Envelope)
                   and req.get("op") in ("put", "delete", "cas"))
        if stamped:
            req["epoch"] = self._epoch
        for _ in range(self._FENCE_ATTEMPTS):
            dst_cluster, dst_addr = self._route(req)
            resp = self.fabric.send(self.src_cluster, self.src_id,
                                    dst_cluster, dst_addr, req)
            if resp.get("ok", False):
                return resp
            if not resp.get("stale_epoch"):
                raise RuntimeError(f"overwatch: {resp.get('error')}")
            self.stats["stale_epoch_bounces"] += 1
            self._epoch = int(resp.get("epoch", self._epoch))
            if resp.get("frozen") or not stamped:
                break            # frozen shards only thaw on a later tick
            req["epoch"] = self._epoch
            self.stats["stale_epoch_retries"] += 1
        raise StaleEpochError(
            f"overwatch {req.get('op')}: fenced at epoch {self._epoch} "
            f"(shard frozen or map moved); retry next tick")

    def request(self, req: dict) -> dict:
        """Send a pre-built request — the hook for hot callers that reuse a
        precomputed ``Envelope`` size (e.g. the agent's fixed-shape telemetry
        heartbeat) so the fabric never re-walks the value dict."""
        return self._call(req)

    def put(self, key: str, value: Any, lease: Optional[int] = None) -> int:
        return self._call({"op": "put", "key": key, "value": value,
                           "lease": lease})["revision"]

    def get(self, key: str) -> Any:
        return self._call({"op": "get", "key": key})["value"]

    def get_with_revision(self, key: str):
        r = self._call({"op": "get", "key": key})
        return r["value"], r["revision"]

    def delete(self, key: str) -> None:
        self._call({"op": "delete", "key": key})

    def cas(self, key: str, value: Any, expect_revision) -> bool:
        return self._call({"op": "cas", "key": key, "value": value,
                           "expect_revision": expect_revision})["swapped"]

    def range(self, prefix: str) -> Dict[str, Any]:
        return self._call({"op": "range", "prefix": prefix})["items"]

    def range_stale(self, prefix: str, max_lag: float) -> Dict[str, Any]:
        """Bounded-staleness range (telemetry path): the local per-cluster
        replica when it covers the prefix within ``max_lag``, else the
        primary's read replica over the fabric. A read that had a covering
        replica but found it out of bound (ships stopped) is counted in
        ``fabric.stats["fallback_reads"]`` — the locality benchmark asserts
        these stay rare instead of letting them hide in total cross-bytes."""
        rep = self.replica
        if rep is not None and rep.covers(prefix):
            if rep.lag(self.fabric.clock) <= max_lag:
                return rep.range_items(prefix)
            self.fabric.stats["fallback_reads"] += 1
        return self._call({"op": "range_stale", "prefix": prefix,
                           "max_lag": max_lag})["items"]

    def lease_grant(self, ttl: float) -> int:
        return self._call({"op": "lease_grant", "ttl": ttl})["lease"]

    def lease_keepalive(self, lease: int) -> None:
        self._call({"op": "lease_keepalive", "lease": lease})
