"""Copy of ``repro.core.durability`` under ``repro_torch``.

Durability layer: append-only per-shard write-ahead log + snapshots.

The global plane's stores (overwatch shards, lease table, broker shards,
taskdb) are in-process state — a master crash without this layer loses the
world. ``LogStore`` gives every store the same crash-survival contract:

  WAL record format
    A *record* is any JSON-able value (the stores append small tuples such as
    ``("put", key, value, rev, lease)`` or ``("pushN", queue, msgs, flag)``).
    The LogStore assigns each committed record a per-shard, monotonically
    increasing **LSN** starting at 1; the backend persists ``(lsn, record)``
    pairs. Records buffered by ``append()`` are NOT durable until
    ``commit(shard)`` runs — group commit: the overwatch commits on
    ``sweep()``, the composer commits once per tick (taskdb before brokers,
    so effects are always at least as durable as the acknowledgments that
    reference them). A crash loses exactly the uncommitted tail
    (``lose_uncommitted()`` models this in the chaos harness).

  Snapshot + truncate compaction
    ``snapshot(shard, payload)`` persists a full-state payload stamped with
    ``base_lsn`` = the shard's last committed LSN, then truncates every WAL
    record with ``lsn <= base_lsn``. ``load(shard)`` returns
    ``(payload | None, records)`` where *records* are exactly the committed
    records **after** the snapshot — replay is therefore never double-applied
    over snapshotted state, which keeps recovery correct even for stores
    whose replay is not idempotent (the broker's pull/ack stream).

  Recovery invariants
    1. Everything committed before the crash is visible after ``load()``.
    2. Nothing uncommitted survives: the loss window is exactly one group
       commit (one sweep / one composer tick).
    3. ``snapshot ∘ load`` is the identity on committed state: compaction
       never changes what recovery rebuilds, only how many records replay.

  Backends
    ``MemoryBackend`` (default) keeps everything in process — it survives a
    *simulated* crash (the chaos harness kills the services, not the Python
    process) and is what the deterministic tests/benchmarks use. Records are
    held by reference; the plane treats values as immutable after append,
    matching the overwatch's own value convention. ``DirBackend`` persists
    for real: one ``<shard>.wal`` JSONL file (fsync'd per group commit, torn
    trailing lines tolerated on load) plus one ``<shard>.snap.json`` written
    temp-then-atomic-rename. JSON round-trips tuples as lists, so recovery
    code treats record fields positionally and never by tuple identity.

  Fault injection
    ``fault_hook(site, shard)`` — when set (see ``repro_torch.core.faults``) it is
    invoked at ``("commit", shard)`` / ``("snapshot", shard)`` boundaries
    *before* the persistence happens, so a scripted ``FaultPlan`` can crash
    the plane mid-sweep with that commit's tail still volatile.
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple


class MemoryBackend:
    """In-process backend: per-shard committed records + latest snapshot."""

    def __init__(self):
        self._shards: Dict[str, dict] = {}

    def _state(self, shard: str) -> dict:
        return self._shards.setdefault(
            shard, {"base_lsn": 0, "snapshot": None, "records": []})

    def persist(self, shard: str, lsn_records: List[Tuple[int, Any]]) -> None:
        self._state(shard)["records"].extend(lsn_records)

    def write_snapshot(self, shard: str, base_lsn: int, payload: Any) -> None:
        st = self._state(shard)
        st["snapshot"] = payload
        st["base_lsn"] = base_lsn
        st["records"] = [(l, r) for (l, r) in st["records"] if l > base_lsn]

    def load(self, shard: str) -> Tuple[int, Any, List[Tuple[int, Any]]]:
        st = self._state(shard)
        return st["base_lsn"], st["snapshot"], list(st["records"])

    def last_lsn(self, shard: str) -> int:
        st = self._state(shard)
        return st["records"][-1][0] if st["records"] else st["base_lsn"]

    def has_data(self, shard: str) -> bool:
        st = self._shards.get(shard)
        return bool(st and (st["snapshot"] is not None or st["records"]))


class DirBackend:
    """On-disk backend: ``<dir>/<shard>.wal`` (JSONL of ``[lsn, record]``,
    appended + fsync'd per group commit) and ``<dir>/<shard>.snap.json``
    (``{"base_lsn", "payload"}``, written temp-then-atomic-rename). A torn
    trailing WAL line (crash mid-write) is dropped on load; everything before
    it is intact because appends happen in commit order."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _wal_path(self, shard: str) -> str:
        return os.path.join(self.root, f"{shard}.wal")

    def _snap_path(self, shard: str) -> str:
        return os.path.join(self.root, f"{shard}.snap.json")

    def persist(self, shard: str, lsn_records: List[Tuple[int, Any]]) -> None:
        with open(self._wal_path(shard), "a", encoding="utf-8") as f:
            for lsn, rec in lsn_records:
                f.write(json.dumps([lsn, rec], separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def write_snapshot(self, shard: str, base_lsn: int, payload: Any) -> None:
        snap = self._snap_path(shard)
        tmp = snap + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"base_lsn": base_lsn, "payload": payload}, f,
                      separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, snap)                      # commit point
        # truncate: rewrite the WAL keeping only post-snapshot records
        keep = [(l, r) for (l, r) in self._read_wal(shard) if l > base_lsn]
        wal, wtmp = self._wal_path(shard), self._wal_path(shard) + ".tmp"
        with open(wtmp, "w", encoding="utf-8") as f:
            for lsn, rec in keep:
                f.write(json.dumps([lsn, rec], separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.rename(wtmp, wal)

    def _read_wal(self, shard: str) -> List[Tuple[int, Any]]:
        path = self._wal_path(shard)
        if not os.path.exists(path):
            return []
        out: List[Tuple[int, Any]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    lsn, rec = json.loads(line)
                except (json.JSONDecodeError, ValueError):
                    break                         # torn tail: stop, keep prefix
                out.append((lsn, rec))
        return out

    def _read_snap(self, shard: str) -> Tuple[int, Any]:
        path = self._snap_path(shard)
        if not os.path.exists(path):
            return 0, None
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        return doc["base_lsn"], doc["payload"]

    def load(self, shard: str) -> Tuple[int, Any, List[Tuple[int, Any]]]:
        base, payload = self._read_snap(shard)
        records = [(l, r) for (l, r) in self._read_wal(shard) if l > base]
        return base, payload, records

    def last_lsn(self, shard: str) -> int:
        recs = self._read_wal(shard)
        if recs:
            return recs[-1][0]
        return self._read_snap(shard)[0]

    def has_data(self, shard: str) -> bool:
        return (os.path.exists(self._snap_path(shard))
                or os.path.exists(self._wal_path(shard)))


class LogStore:
    """Group-committed WAL + snapshot front-end shared by every durable store.

    One LogStore instance typically backs the whole plane (overwatch shards,
    meta/lease shard, broker shards, taskdb) — shard names are disjoint, and
    commit ordering across shards stays under the callers' control (the
    composer commits ``taskdb`` before broker shards every tick).
    """

    def __init__(self, backend=None,
                 fault_hook: Optional[Callable[[str, str], None]] = None):
        self.backend = backend if backend is not None else MemoryBackend()
        self.fault_hook = fault_hook
        self._buf: Dict[str, List[Any]] = {}      # shard -> uncommitted tail
        self._lsn: Dict[str, int] = {}            # shard -> last committed LSN
        self._snap_base: Dict[str, int] = {}      # shard -> snapshot base LSN
        self.stats: Counter = Counter()

    # ------------------------------------------------------------------ write
    def append(self, shard: str, record: Any) -> None:
        """Buffer a record; volatile until ``commit(shard)``."""
        self._buf.setdefault(shard, []).append(record)
        self.stats["appended"] += 1

    def commit(self, shard: str) -> int:
        """Persist the shard's buffered tail (group commit). Returns the
        number of records made durable."""
        if self.fault_hook is not None:
            self.fault_hook("commit", shard)
        buf = self._buf.pop(shard, None)
        if not buf:
            return 0
        start = self._last(shard)
        lsn_records = [(start + i + 1, rec) for i, rec in enumerate(buf)]
        self.backend.persist(shard, lsn_records)
        self._lsn[shard] = start + len(buf)
        self.stats["committed"] += len(buf)
        self.stats["commits"] += 1
        return len(buf)

    def commit_all(self) -> int:
        return sum(self.commit(s) for s in sorted(self._buf))

    def lose_uncommitted(self) -> int:
        """Crash model: drop every shard's uncommitted tail. Returns how many
        records were lost (the chaos harness records this per crash)."""
        lost = sum(len(b) for b in self._buf.values())
        self._buf.clear()
        self.stats["lost_records"] += lost
        return lost

    def lose_shards(self, shards) -> int:
        """Crash model for a single master fault domain: drop only the named
        shards' uncommitted tails (the dying master's stores), leaving the
        survivors' buffered records intact."""
        lost = 0
        for shard in shards:
            buf = self._buf.pop(shard, None)
            if buf:
                lost += len(buf)
        self.stats["lost_records"] += lost
        return lost

    # -------------------------------------------------------------- snapshot
    def snapshot(self, shard: str, payload: Any) -> None:
        """Persist a full-state payload at the current committed LSN and
        truncate the WAL behind it (snapshot+truncate compaction)."""
        if self.fault_hook is not None:
            self.fault_hook("snapshot", shard)
        base = self._last(shard)
        self.backend.write_snapshot(shard, base, payload)
        self._snap_base[shard] = base
        self.stats["snapshots"] += 1

    def records_since_snapshot(self, shard: str) -> int:
        """Committed WAL length past the last snapshot — the replay bound a
        caller compares against its ``snapshot_every`` policy."""
        return self._last(shard) - self._snap_base.get(shard, 0)

    # ------------------------------------------------------------------- read
    def load(self, shard: str) -> Tuple[Any, List[Any]]:
        """(snapshot payload | None, committed records after it) — the replay
        input for ``recover()``. Uncommitted appends are never returned."""
        base, payload, lsn_records = self.backend.load(shard)
        top = lsn_records[-1][0] if lsn_records else base
        self._lsn[shard] = max(self._lsn.get(shard, 0), top)
        self._snap_base[shard] = max(self._snap_base.get(shard, 0), base)
        self.stats["replayed"] += len(lsn_records)
        return payload, [rec for (_, rec) in lsn_records]

    def has_data(self, shard: str) -> bool:
        return self.backend.has_data(shard)

    # -------------------------------------------------------------- internals
    def _last(self, shard: str) -> int:
        if shard not in self._lsn:
            self._lsn[shard] = self.backend.last_lsn(shard)
        return self._lsn[shard]
