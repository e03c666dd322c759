"""Copy of ``repro.core.transport`` under ``repro_torch``.

Simulated inter-cluster fabric (the paper's network substrate, §4.1).

Models exactly the connectivity regime the paper assumes:

  * Within a cluster: any endpoint can reach any (ip, port) — fast local network
    (the ICI/intra-cluster path).
  * Across clusters: NO direct reachability. The only cross-cluster transport is a
    ``Channel`` (the SSH/port-forwarding tunnel of Algorithm 4), pinned to gateway
    endpoints. Traffic that is not routed through a configured gateway chain simply
    does not arrive — mirroring real firewalled private clouds.
  * Access control: default-deny pod->service tables (Algorithm 3) enforced at
    send time.

Delivery is synchronous and deterministic; a simulated clock (``tick``) drives
lease expiry and heartbeat scheduling in the layers above. Per-edge byte counters
make the paper's "thin cross-boundary traffic" claim measurable
(``cross_cluster_bytes`` vs ``local_bytes``), and fault injection (partition a
cluster, kill a channel) drives the fault-tolerance tests.

Byte accounting covers the full round trip wherever it matters: the request
payload is charged on every hop it traverses, and on any path that crosses a
gateway channel the handler's RESPONSE is charged back along the same path
(sized exactly once at the terminal handler and propagated up the hop stack —
never re-walked per hop). A fat range response crossing a channel is
cross-boundary traffic exactly like a fat request, which is what makes
"serve remote reads from a local replica" a measurable byte win rather than a
free-response illusion. Purely intra-cluster round trips skip the response
walk entirely — the cross-boundary ledger is the paper's claim, and sizing
every local data-plane response would tax the hottest path for a number
nothing gates.

The send fast path is deliberately lean (this is the hottest function in the
repo): ACL exemption checks are memoized per source id instead of re-scanning
the exempt prefixes per message, the per-string/per-envelope byte caches evict
one entry at a time instead of wholesale (no re-encode storms at the limit),
``message_log_limit=0`` skips message-tuple construction entirely, and the
dominant no-forwarding-rule delivery case skips the loop-detection machinery.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import Counter, deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

Address = Tuple[str, int]            # (ip, port)


class DeliveryError(Exception):
    """Raised when the fabric cannot deliver a message (no route / denied / down)."""


class StaleEpochError(RuntimeError):
    """A request was fenced by the shard map: it carried an epoch older than
    the current map (or hit a frozen, mid-migration shard) and the bounded
    refresh+retry in the client could not land it. Subclassing RuntimeError
    keeps every existing best-effort caller (agent heartbeats, depth
    publication) on its normal retry-next-tick path."""


class RingLog:
    """Bounded append-only log (list-compatible for the common read patterns).

    ``limit=None`` keeps everything (test/debug); a finite limit turns it into
    a ring buffer so long-running planes do not grow without bound.
    ``total_appended`` keeps counting even after old entries are evicted.
    """

    def __init__(self, limit: Optional[int] = None):
        self.limit = limit
        self._buf: deque = deque(maxlen=limit)
        self.total_appended = 0

    def append(self, item: Any) -> None:
        self._buf.append(item)
        self.total_appended += 1

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator:
        return iter(self._buf)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._buf)[idx]
        return self._buf[idx]

    def __bool__(self) -> bool:
        return bool(self._buf)

    def clear(self) -> None:
        self._buf.clear()


@dataclasses.dataclass
class Channel:
    """A cross-cluster tunnel between two gateway endpoints (Algorithm 4)."""
    channel_id: int
    cluster_a: str
    addr_a: Address
    cluster_b: str
    addr_b: Address
    alive: bool = True
    bytes_ab: int = 0
    bytes_ba: int = 0

    def other_end(self, cluster: str, addr: Address):
        if (cluster, addr) == (self.cluster_a, self.addr_a):
            return self.cluster_b, self.addr_b
        if (cluster, addr) == (self.cluster_b, self.addr_b):
            return self.cluster_a, self.addr_a
        return None


class Envelope(dict):
    """A dict payload with a cached byte size (zero-copy accounting).

    Hot envelope types — overwatch ops, telemetry heartbeats, job dispatches —
    are built once and then traverse several fabric hops (gateway forwards,
    channel crossings), each of which used to re-walk every nested value dict
    in ``_payload_bytes``. An ``Envelope`` is sized exactly once: at
    construction when the sender already knows the size (``nbytes=``), or
    lazily on the first ``send`` — subsequent hops read the cached number.
    The computed size is identical to the plain-dict walk, so byte ledgers are
    unchanged; only the walking stops.
    """

    __slots__ = ("_nbytes",)

    def __init__(self, *args, nbytes: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._nbytes = nbytes

    @property
    def nbytes(self) -> int:
        if self._nbytes is None:
            self._nbytes = _dict_bytes(self)
        return self._nbytes


# Control-plane traffic is dominated by a small vocabulary of repeated strings
# (op names, key prefixes, field names) and fixed dict envelopes, so byte
# accounting memoizes per-string encoded sizes and per-envelope key overhead.
_STR_BYTES_CACHE: Dict[str, int] = {}
_DICT_KEYS_CACHE: Dict[Tuple[str, ...], int] = {}
_CACHE_LIMIT = 65536


def _evict_one(cache: dict) -> None:
    """Drop the oldest entry (dict insertion order — FIFO, not LRU: tracking
    recency would cost a dict move on every HIT of the hottest path to avoid
    an occasional ~100ns re-encode; an evicted hot entry simply re-inserts on
    its next use). Wholesale ``clear()`` at the limit used to force the
    entire hot vocabulary to re-encode in one thrash storm; one-at-a-time
    eviction keeps the steady-state hit rate."""
    cache.pop(next(iter(cache)))


def _str_bytes(s: str) -> int:
    n = _STR_BYTES_CACHE.get(s)
    if n is None:
        n = len(s.encode())
        if len(_STR_BYTES_CACHE) >= _CACHE_LIMIT:
            _evict_one(_STR_BYTES_CACHE)
        _STR_BYTES_CACHE[s] = n
    return n


def _dict_bytes(payload: dict) -> int:
    try:
        sig = tuple(payload.keys())
        key_bytes = _DICT_KEYS_CACHE.get(sig)
        if key_bytes is None:
            key_bytes = sum(_payload_bytes(k) for k in sig)
            if len(_DICT_KEYS_CACHE) >= _CACHE_LIMIT:
                _evict_one(_DICT_KEYS_CACHE)
            _DICT_KEYS_CACHE[sig] = key_bytes
    except TypeError:                 # unhashable keys: no memoization
        key_bytes = sum(_payload_bytes(k) for k in payload)
    return key_bytes + sum(_payload_bytes(v) for v in payload.values())


def _payload_bytes(payload: Any) -> int:
    if isinstance(payload, Envelope):
        return payload.nbytes          # precomputed / cached — no value walk
    if isinstance(payload, (bytes, bytearray)):
        return len(payload)
    if isinstance(payload, str):
        return _str_bytes(payload)
    if isinstance(payload, dict):
        return _dict_bytes(payload)
    if isinstance(payload, (list, tuple)):
        return sum(_payload_bytes(v) for v in payload)
    if isinstance(payload, (int, float, bool)) or payload is None:
        return 8
    return 64  # opaque object envelope


class Fabric:
    """The hybrid-cloud network: clusters, gateways, channels, ACLs, a clock."""

    def __init__(self, message_log_limit: Optional[int] = 100_000):
        self.clock: float = 0.0
        self._handlers: Dict[Tuple[str, Address], Callable] = {}
        self._forwards: Dict[Tuple[str, Address], Address] = {}
        self._channels: Dict[Tuple[str, Address], Channel] = {}
        self._channel_ids = itertools.count(1)
        self.channels: Dict[int, Channel] = {}
        self._partitioned: set = set()           # clusters cut off from everything
        self._acl: Dict[str, "AclTable"] = {}
        self.local_bytes: Counter = Counter()    # per-cluster intra bytes
        self.cross_bytes: Counter = Counter()    # per (src, dst) cluster pair
        # named operational counters the byte ledgers can't express — e.g.
        # ``fallback_reads``: bounded-staleness reads that had to abandon an
        # out-of-bound local replica for a primary round trip
        self.stats: Counter = Counter()
        self.message_log: RingLog = RingLog(message_log_limit)
        self._timers: List[Tuple[float, int, Callable]] = []   # real min-heap
        self._timer_seq = itertools.count()      # FIFO tie-break at one deadline
        # fault-injection seam: invoked as (cluster, addr, payload) right
        # before every handler call. First-class on the fabric (not a handler
        # wrapper) so it keeps observing through service rebuilds and counts
        # recovery traffic too (repro_torch.core.faults arms it).
        self.on_deliver: Optional[Callable[[str, Address, Any], None]] = None
        # trace-context stack: while a handler runs, the "trace" field of the
        # payload being delivered (repro_torch.observability.trace.TRACE_KEY) is on
        # top, so a handler many hops from the sender — gateway relays
        # included — can parent its spans via current_trace() without every
        # intermediate service threading the context through its own API.
        self._trace_ctx: List[Any] = []

    # ------------------------------------------------------------------- topology
    def register_handler(self, cluster: str, addr: Address,
                         handler: Callable[[Any], Any]) -> None:
        self._handlers[(cluster, addr)] = handler

    def add_forward(self, cluster: str, src: Address, dst: Address) -> None:
        """Istio-style in-cluster forwarding rule src -> dst (Algorithm 2)."""
        self._forwards[(cluster, src)] = dst

    def remove_forward(self, cluster: str, src: Address) -> None:
        self._forwards.pop((cluster, src), None)

    def create_channel(self, cluster_a: str, addr_a: Address, cluster_b: str,
                       addr_b: Address) -> Channel:
        ch = Channel(next(self._channel_ids), cluster_a, addr_a, cluster_b,
                     addr_b)
        self._channels[(cluster_a, addr_a)] = ch
        self._channels[(cluster_b, addr_b)] = ch
        self.channels[ch.channel_id] = ch
        return ch

    def channel_at(self, cluster: str, addr: Address) -> Optional[Channel]:
        """The channel terminating at (cluster, addr), if any — lets a
        re-run of Algorithm 4 (AppSpec re-broadcast for an elastic fleet)
        skip tunnels that already exist instead of stacking duplicates."""
        return self._channels.get((cluster, addr))

    def set_acl(self, cluster: str, table: "AclTable") -> None:
        self._acl[cluster] = table

    # ------------------------------------------------------------- fault injection
    def partition_cluster(self, cluster: str) -> None:
        self._partitioned.add(cluster)

    def heal_cluster(self, cluster: str) -> None:
        self._partitioned.discard(cluster)

    def kill_channel(self, channel_id: int) -> None:
        self.channels[channel_id].alive = False

    def revive_channel(self, channel_id: int) -> None:
        self.channels[channel_id].alive = True

    # ------------------------------------------------------------------------ time
    def tick(self, dt: float = 1.0) -> None:
        self.clock += dt
        # snapshot the due set BEFORE running callbacks: timers scheduled while
        # firing (heartbeat re-arm) wait for the next tick, as they always did
        due = []
        while self._timers and self._timers[0][0] <= self.clock:
            due.append(heapq.heappop(self._timers))
        for _, _, cb in due:
            cb()

    def call_later(self, delay: float, cb: Callable[[], None]) -> None:
        heapq.heappush(self._timers,
                       (self.clock + delay, next(self._timer_seq), cb))

    # -------------------------------------------------------------------- delivery
    def current_trace(self) -> Optional[str]:
        """The trace context of the message currently being delivered (the
        ``"trace_id|span_id"`` string riding its payload), or ``None``.
        Valid only inside a handler call; nested deliveries stack."""
        return self._trace_ctx[-1] if self._trace_ctx else None

    def send(self, src_cluster: str, src_id: str, cluster: str, addr: Address,
             payload: Any, _hops: int = 0) -> Any:
        """Send from a component (pod/agent) to an in-cluster (ip, port).

        Cross-cluster reachability exists ONLY through channels installed on the
        path via forwarding rules. Returns the handler's response. The request
        is byte-accounted on every hop; the response is accounted too on any
        path that crossed a channel.
        """
        return self._send(src_cluster, src_id, cluster, addr, payload,
                          _hops, False)[0]

    def _send(self, src_cluster: str, src_id: str, cluster: str,
              addr: Address, payload: Any, _hops: int,
              need_rbytes: bool) -> Tuple[Any, int]:
        """Internal send returning ``(response, response_bytes)`` so that the
        response is sized exactly once (at the terminal handler) and every
        hop on the way back charges the propagated number. ``need_rbytes``
        tells the terminal whether anything upstream will charge the
        response — entering a channel forces it, a purely-local path skips
        the walk and returns 0."""
        if _hops > 16:
            raise DeliveryError(f"routing loop at {cluster}:{addr}")
        if src_cluster in self._partitioned or cluster in self._partitioned:
            raise DeliveryError(f"cluster partitioned: {src_cluster}->{cluster}")
        if src_cluster != cluster:
            raise DeliveryError(
                f"no direct cross-cluster route {src_cluster}->{cluster}; "
                "flows must traverse gateway channels (Algorithm 4)")

        acl = self._acl.get(cluster)
        if acl is not None and _hops == 0 and not acl.allowed(src_id, addr):
            raise DeliveryError(
                f"ACL deny: {src_id} -> {cluster}:{addr} (Algorithm 3)")

        nbytes = _payload_bytes(payload)
        self.local_bytes[cluster] += nbytes
        if self.message_log.limit != 0:   # limit 0: skip tuple construction
            self.message_log.append(
                (self.clock, src_cluster, src_id, cluster, addr))

        # channel endpoint? hop across the boundary
        ch = self._channels.get((cluster, addr))
        if ch is not None:
            if not ch.alive:
                raise DeliveryError(f"channel {ch.channel_id} down")
            other = ch.other_end(cluster, addr)
            assert other is not None
            o_cluster, o_addr = other
            if o_cluster in self._partitioned:
                raise DeliveryError(f"cluster partitioned: {o_cluster}")
            a_to_b = (cluster, addr) == (ch.cluster_a, ch.addr_a)
            if a_to_b:
                ch.bytes_ab += nbytes
            else:
                ch.bytes_ba += nbytes
            self.cross_bytes[(cluster, o_cluster)] += nbytes
            resp, rbytes = self._deliver_local(o_cluster, o_addr, src_id,
                                               payload, _hops + 1, True)
            # the response re-crosses the channel in the other direction
            if a_to_b:
                ch.bytes_ba += rbytes
            else:
                ch.bytes_ab += rbytes
            self.cross_bytes[(o_cluster, cluster)] += rbytes
            self.local_bytes[cluster] += rbytes
            return resp, rbytes

        return self._deliver_local(cluster, addr, src_id, payload, _hops,
                                   need_rbytes)

    def _deliver_local(self, cluster: str, addr: Address, src_id: str,
                       payload: Any, hops: int,
                       need_rbytes: bool) -> Tuple[Any, int]:
        # hot path: no forwarding rule at the dialed address — straight to the
        # handler, no loop-detection set, no rule walk
        fwd = self._forwards.get((cluster, addr))
        if fwd is None:
            handler = self._handlers.get((cluster, addr))
            if handler is None:
                raise DeliveryError(f"no endpoint at {cluster}:{addr}")
            if self.on_deliver is not None:
                self.on_deliver(cluster, addr, payload)
            ctx = payload.get("trace") if isinstance(payload, dict) else None
            if ctx is None:              # untraced message: zero extra work
                resp = handler(payload)
            else:
                self._trace_ctx.append(ctx)
                try:                     # finally: CrashError must still pop
                    resp = handler(payload)
                finally:
                    self._trace_ctx.pop()
            if not need_rbytes:          # purely-local round trip: no walk
                return resp, 0
            rbytes = _payload_bytes(resp)
            self.local_bytes[cluster] += rbytes
            return resp, rbytes
        # follow in-cluster forwarding rules (gateway port maps)
        seen = {(cluster, addr)}
        addr = fwd
        while True:
            ch = self._channels.get((cluster, addr))
            if ch is not None:
                return self._send(cluster, f"gw@{cluster}", cluster, addr,
                                  payload, hops + 1, need_rbytes)
            fwd = self._forwards.get((cluster, addr))
            if fwd is None:
                break
            if (cluster, addr) in seen:
                raise DeliveryError(f"forward loop in {cluster} at {addr}")
            seen.add((cluster, addr))
            addr = fwd
        handler = self._handlers.get((cluster, addr))
        if handler is None:
            raise DeliveryError(f"no endpoint at {cluster}:{addr}")
        if self.on_deliver is not None:
            self.on_deliver(cluster, addr, payload)
        ctx = payload.get("trace") if isinstance(payload, dict) else None
        if ctx is None:
            resp = handler(payload)
        else:
            self._trace_ctx.append(ctx)
            try:
                resp = handler(payload)
            finally:
                self._trace_ctx.pop()
        if not need_rbytes:
            return resp, 0
        rbytes = _payload_bytes(resp)
        self.local_bytes[cluster] += rbytes
        return resp, rbytes

    # ------------------------------------------------------------------ accounting
    def cross_cluster_bytes(self) -> int:
        return sum(self.cross_bytes.values())

    def locality_ratio(self) -> float:
        """Fraction of all bytes that stayed inside a cluster (paper's claim: ~1)."""
        local = sum(self.local_bytes.values())
        cross = self.cross_cluster_bytes()
        return local / max(local + cross, 1)


class AclTable:
    """Default-deny pod->(ip, port) table (Algorithm 3).

    The exempt-prefix test (infra components: gateways, agents, system pods)
    used to run ``any(startswith)`` on every ``Fabric.send`` — the single
    hottest string scan in the plane. It is now resolved once per source id:
    precomputed at ``allow`` time for ids the table learns about, memoized on
    first sight for everything else. ``stats['prefix_scans']`` counts actual
    prefix walks so tests can pin the scan-once property; exemption is a pure
    function of the id (the prefix tuple is fixed at construction), so the
    cache never needs invalidation — ``block_all`` only touches the allow set.
    """

    def __init__(self):
        self._allowed: set = set()
        self._exempt_prefixes = ("gw@", "agent@", "system@")
        self._exempt_cache: Dict[str, bool] = {}
        self.stats: Counter = Counter()

    def _is_exempt(self, src_id: str) -> bool:
        e = self._exempt_cache.get(src_id)
        if e is None:
            self.stats["prefix_scans"] += 1
            e = any(src_id.startswith(p) for p in self._exempt_prefixes)
            if len(self._exempt_cache) >= _CACHE_LIMIT:
                _evict_one(self._exempt_cache)
            self._exempt_cache[src_id] = e
        return e

    def allow(self, src_id: str, addr: Address) -> None:
        self._allowed.add((src_id, addr))
        self._is_exempt(src_id)             # precompute at allow time

    def block_all(self, addr: Address) -> None:
        self._allowed = {(s, a) for (s, a) in self._allowed if a != addr}

    def allowed(self, src_id: str, addr: Address) -> bool:
        if self._is_exempt(src_id):
            return True                     # infra components, not app pods
        return (src_id, addr) in self._allowed

    def entries(self) -> set:
        return set(self._allowed)
