"""Copy of ``repro.pipelines.taskdb`` under ``repro_torch``.

Task-instance database (the Airflow metadata SQL DB, paper §5).

Hosted on the master partition; workers commit every finished task here (the
paper: "commit each finished task to an SQL database"). Rows are keyed
(dag_id, task, try_number) with status transitions
queued -> running -> success | failed.

Hot path (the scaling overhaul): the DB maintains a per-DAG latest-try view
and a per-DAG change log, so

  * ``dag_state`` / ``latest`` no longer scan every row in the table;
  * the ``dag_delta`` op gives the scheduler incremental dirty-task
    deltas — rows changed since a cursor — so a quiescent DAG costs O(1)
    per scheduler tick instead of a full state dump;
  * ``dag_delta_many`` multiplexes the deltas of every registered DAG into
    one call — the scheduler pays a single taskdb round-trip per tick no
    matter how many DAGs it owns;
  * ``upsert_many`` applies a whole batch of rows (in order) in one
    round-trip — a worker commits an executed pull batch (running + terminal
    row per task) and the scheduler commits a whole ready frontier with a
    single RPC instead of one per row.

Durability: with a ``LogStore`` attached, every upsert batch appends one
``("upN", rows)`` WAL record; the snapshot is simply the row table. Replay
re-runs ``_upsert`` (idempotent per key — the last write for a (dag, task,
try) wins, exactly like live traffic) and marks every replayed row dirty, so
a recovering scheduler probing from cursor 0 sees the complete state.
``status_many`` is the workers' post-crash dedup probe: the status of each
(dag, task, try) key, None for unknown rows.
"""
from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, Tuple


class TaskDB:
    """In-memory table behind a service handler (swap for CloudSQL in prod)."""

    def __init__(self, durability=None, shard_name: str = "taskdb"):
        self.rows: Dict[tuple, dict] = {}
        # dag -> task -> latest-try row (same row objects as self.rows)
        self._latest: Dict[str, Dict[str, dict]] = {}
        self._seq = 0
        # dag -> append-only [(seq, task)] change log, compacted when it
        # outgrows the task count (bounded memory, cursor-stable)
        self._changes: Dict[str, List[Tuple[int, str]]] = {}
        self.op_counts: Counter = Counter()          # per-op RPC accounting
        self._dur = durability
        self._shard = shard_name
        self.recovery_replayed = 0
        if durability is not None and durability.has_data(shard_name):
            self.recover()

    def _mark_dirty(self, dag: str, task: str) -> None:
        self._seq += 1
        log = self._changes.setdefault(dag, [])
        log.append((self._seq, task))
        tasks = self._latest.get(dag, {})
        if len(log) > 4 * max(len(tasks), 8):
            last: Dict[str, int] = {}
            for seq, t in log:
                last[t] = seq
            log[:] = sorted((s, t) for t, s in last.items())

    def _upsert(self, msg: dict) -> None:
        key = (msg["dag"], msg["task"], int(msg.get("try", 1)))
        row = self.rows.setdefault(key, {"dag": msg["dag"],
                                         "task": msg["task"],
                                         "try": key[2]})
        for k in ("status", "worker", "result", "clock", "error"):
            if k in msg:
                row[k] = msg[k]
        latest = self._latest.setdefault(msg["dag"], {})
        cur = latest.get(msg["task"])
        if cur is None or key[2] >= cur["try"]:
            latest[msg["task"]] = row
        self._mark_dirty(msg["dag"], msg["task"])

    # ---------------------------------------------------------------- service API
    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        self.op_counts[op] += 1
        if op == "upsert":
            self._upsert(msg)
            if self._dur is not None:
                self._dur.append(self._shard, ("upN", [msg]))
            return {"ok": True}
        if op == "upsert_many":
            # one batched commit: rows apply in list order, so a worker's
            # running->terminal pair lands as the same transition sequence the
            # per-row protocol produced
            for row in msg["rows"]:
                self._upsert(row)
            if self._dur is not None:
                self._dur.append(self._shard, ("upN", msg["rows"]))
            return {"ok": True, "n": len(msg["rows"])}
        if op == "status_many":
            # post-crash dedup probe: status per (dag, task, try), None if the
            # row is unknown (a read — creates nothing, logs nothing)
            statuses = [
                (self.rows.get((k[0], k[1], int(k[2]))) or {}).get("status")
                for k in msg["keys"]]
            return {"ok": True, "statuses": statuses}
        if op == "get":
            key = (msg["dag"], msg["task"], int(msg.get("try", 1)))
            return {"ok": True, "row": self.rows.get(key)}
        if op == "latest":
            row = self._latest.get(msg["dag"], {}).get(msg["task"])
            return {"ok": True, "row": row}
        if op == "dag_state":
            return {"ok": True,
                    "tasks": dict(self._latest.get(msg["dag"], {}))}
        if op == "dag_delta":
            return self._dag_delta(msg["dag"], int(msg.get("since", 0)))
        if op == "dag_delta_many":
            deltas = {}
            for dag, since in msg["dags"].items():
                tasks = self._dag_delta(dag, int(since))["tasks"]
                if tasks:
                    deltas[dag] = tasks
            return {"ok": True, "deltas": deltas, "cursor": self._seq}
        return {"ok": False, "error": f"unknown op {op}"}

    # ------------------------------------------------------------- durability
    def snapshot_payload(self) -> dict:
        return {"rows": [dict(r) for r in self.rows.values()]}

    def recover(self) -> None:
        """Snapshot rows + replayed WAL batches through the normal ``_upsert``
        path: the latest-try view and change log rebuild as a side effect, and
        every recovered row is dirty from cursor 0 — a fresh scheduler's first
        probe sees the full surviving state."""
        dur = self._dur
        self._dur = None
        try:
            payload, records = dur.load(self._shard)
            if payload:
                for row in payload["rows"]:
                    self._upsert(row)
            for rec in records:
                for row in rec[1]:
                    self._upsert(row)
            self.recovery_replayed = len(records)
        finally:
            self._dur = dur

    def _dag_delta(self, dag: str, since: int) -> dict:
        """Latest rows for tasks changed after cursor ``since``."""
        log = self._changes.get(dag, [])
        i = bisect.bisect_left(log, (since + 1,))
        latest = self._latest.get(dag, {})
        tasks = {}
        for _, t in log[i:]:
            if t not in tasks and t in latest:
                tasks[t] = latest[t]
        return {"ok": True, "tasks": tasks, "cursor": self._seq}
