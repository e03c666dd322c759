"""Copy of ``repro.pipelines.scheduler`` under ``repro_torch``.

DAG scheduler (the Airflow scheduler, paper §5).

Runs as a pod on the master partition: every tick it reads task states from the
taskdb, computes the ready frontier of each registered DAG, and places ready
task instances onto the broker — one queue per ``requires`` capability set, so
compliance-constrained tasks (e.g. "onprem-only ETL") are only visible to
workers inside the right partition. Failed tasks are retried up to
``Task.retries`` times; tasks downstream of a permanently failed task are
marked upstream_failed.

Hot path (the data-plane throughput overhaul): the scheduler is fully
delta-driven.

  * One ``dag_delta_many`` probe per tick covers every registered DAG (a
    quiescent DAG costs nothing beyond its slice of that probe).
  * The per-DAG done/running/failed sets are maintained INCREMENTALLY from
    those deltas — never rebuilt from the full cached state — and the ready
    frontier comes from an indegree counter per task (``_undone_up``): when a
    task succeeds, each direct downstream's counter drops, and a counter
    hitting zero promotes the task into the candidate set. Scheduling work is
    O(changed tasks) per tick, not O(DAG size).
  * Placement is coalesced: each tick flushes ONE taskdb ``upsert_many``
    carrying every queued/retry/upstream_failed row plus ONE broker
    ``push_many`` per target queue — 2 RPCs per tick per active DAG instead
    of 2 per task (``batched=False`` keeps the per-task protocol for
    equivalence tests and the benchmark baseline).
  * ``dag_status``/``dag_done``/``dag_success`` read the cached ``_state``,
    refreshed by the same delta probe — no full ``dag_state`` dump per call.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Set, Tuple

from repro_torch.core.transport import DeliveryError
from repro_torch.pipelines.dag import DAG, Task
from repro_torch.pipelines.services import ServiceClient

TERMINAL = ("success", "failed", "upstream_failed")


def queue_for(task: Task, cost_aware: bool = False) -> str:
    """Queue name = sorted capability set. With ``cost_aware`` the task's
    roofline steering tag (``repro_torch.roofline.cost``) joins the set, so the
    existing capability-set routing — broker queues, dispatcher depth-aware
    placement, autoscaler families — steers by cost class with no new wire
    protocol. An unpriced task (no cost signal) routes exactly as before."""
    tags = set(task.requires)
    if cost_aware:
        from repro_torch.roofline.cost import steering_tag   # lazy: off-path import
        tag = steering_tag(task)
        if tag:
            tags.add(tag)
    return ",".join(sorted(tags)) or "default"


class Scheduler:
    # a broker push that bounces (shard frozen / migrating) or dies
    # (unreachable master) is retried once per tick up to this bound, then
    # its tasks are marked failed — surfaced, never hung
    PUSH_MAX_ATTEMPTS = 8

    def __init__(self, client: ServiceClient, clock_fn=None,
                 batched: bool = True, broker_for=None,
                 cost_aware: bool = False, tracer=None):
        self.client = client
        self.stats: Counter = Counter()
        # (queue, redelivered) -> msgs awaiting re-push / attempt count
        self._push_retry: Dict[Tuple[str, bool], List[dict]] = {}
        self._push_attempts: Dict[Tuple[str, bool], int] = {}
        self.dags: Dict[str, DAG] = {}
        self.clock_fn = clock_fn or (lambda: 0.0)
        self.batched = batched
        # flight recorder: when set (and the task samples), _stage opens the
        # task's ROOT span plus a "schedule" child and rides the context on
        # the broker message; the root closes when _apply_rows observes the
        # terminal taskdb row — the scheduler is the one component that sees
        # both birth and death of every task instance
        self.tracer = tracer
        self._staged_spans: List = []
        # partial sampling: every round(1/sample)-th staged task traces
        self._stage_n = 0
        self._stride = (max(1, round(1.0 / tracer.sample))
                        if tracer is not None and 0.0 < tracer.sample < 1.0
                        else 0)
        # roofline-cost-aware queue routing; False is byte-identical to the
        # depth-aware-only plane (asserted by test_workloads equivalence)
        self.cost_aware = cost_aware
        # queue -> broker service name (per-family sharding); the default is
        # the single unsharded "broker" service
        self.broker_for = broker_for or (lambda queue: "broker")
        self._state: Dict[str, Dict[str, dict]] = {}   # cached latest rows
        self._cursor: Dict[str, int] = {}
        self._quiescent: Set[str] = set()
        # ---------------- incrementally maintained per-DAG scheduling state
        self._done: Dict[str, Set[str]] = {}
        self._running: Dict[str, Set[str]] = {}        # queued or running
        self._failed: Dict[str, Set[str]] = {}         # permanent (incl. upstream)
        self._retry_pending: Dict[str, Dict[str, int]] = {}  # task -> next try
        self._fail_new: Dict[str, Set[str]] = {}       # to propagate downstream
        self._undone_up: Dict[str, Dict[str, int]] = {}  # not-yet-done upstreams
        self._candidates: Dict[str, Set[str]] = {}     # all upstreams done

    def add_dag(self, dag: DAG) -> None:
        did = dag.dag_id
        self.dags[did] = dag
        self._state.setdefault(did, {})
        self._cursor.setdefault(did, 0)
        self._quiescent.discard(did)
        self._done.setdefault(did, set())
        self._running.setdefault(did, set())
        self._failed.setdefault(did, set())
        self._retry_pending.setdefault(did, {})
        self._fail_new.setdefault(did, set())
        undone = {n: len(t.upstream) for n, t in dag.tasks.items()}
        self._undone_up.setdefault(did, undone)
        self._candidates.setdefault(
            did, {n for n, d in undone.items() if d == 0})

    # ------------------------------------------------------------ delta intake
    def _apply_rows(self, dag: DAG, changed: Dict[str, dict]) -> None:
        """Fold a taskdb delta into the incremental scheduling sets.

        Pure state tracking — no RPCs. Scheduling side effects (enqueueing
        retries, propagating failures) are staged in ``_retry_pending`` /
        ``_fail_new`` and drained by ``_schedule_dag`` so that an observation
        probe (``dag_status``) can consume deltas without scheduling.
        """
        did = dag.dag_id
        self._state[did].update(changed)
        done = self._done[did]
        running = self._running[did]
        failed = self._failed[did]
        candidates = self._candidates[did]
        undone = self._undone_up[did]
        retry = self._retry_pending[did]
        tr = self.tracer
        # root spans close at terminal rows — collected here, closed in two
        # batch calls (one clock read) after the fold
        closed_ok: List[tuple] = []
        closed_failed: List[tuple] = []
        for t, r in changed.items():
            if t not in dag.tasks:
                continue
            s = r.get("status")
            if s == "success":
                if t in done:
                    continue
                done.add(t)
                running.discard(t)
                candidates.discard(t)
                retry.pop(t, None)
                # a retry can outrace a same-tick upstream_failed mark; the
                # success row wins (it is the higher try), so the sets agree
                failed.discard(t)
                if tr is not None:
                    closed_ok.append(("task", did, t))
                for d in dag.children[t]:
                    undone[d] -= 1
                    if undone[d] == 0 and d not in done and d not in failed:
                        candidates.add(d)
            elif s in ("queued", "running"):
                if t not in done and t not in failed:
                    running.add(t)
                    candidates.discard(t)
            elif s == "failed":
                running.discard(t)
                if t in done or t in failed:
                    continue
                if r["try"] < dag.tasks[t].retries + 1:
                    retry[t] = r["try"] + 1
                else:
                    failed.add(t)
                    candidates.discard(t)
                    retry.pop(t, None)
                    self._fail_new[did].add(t)
                    if tr is not None:
                        closed_failed.append(("task", did, t))
            elif s == "upstream_failed":
                running.discard(t)
                candidates.discard(t)
                retry.pop(t, None)
                if t not in done:
                    failed.add(t)
                    if tr is not None:
                        closed_failed.append(("task", did, t))
        if closed_ok or closed_failed:
            tnow = tr.clock()
            if closed_ok:
                tr.close_keyed_many(closed_ok, tnow)
            if closed_failed:
                tr.close_keyed_many(closed_failed, tnow, status="failed")

    def _probe(self) -> Dict[str, Dict[str, dict]]:
        """One multiplexed delta round-trip for every registered DAG."""
        resp = self.client.call("taskdb", {
            "op": "dag_delta_many",
            "dags": {d: self._cursor.get(d, 0) for d in self.dags}})
        deltas = resp["deltas"]
        cursor = resp["cursor"]
        for dag in self.dags.values():
            self._cursor[dag.dag_id] = cursor
            changed = deltas.get(dag.dag_id, {})
            if changed:
                self._apply_rows(dag, changed)
                # state moved: the next tick must re-examine this DAG even
                # though its delta was consumed here (observation probes and
                # scheduling ticks share one cursor)
                self._quiescent.discard(dag.dag_id)
        return deltas

    # -------------------------------------------------------------------- one tick
    def tick(self) -> List[str]:
        scheduled: List[str] = []
        if self._push_retry:
            self._drain_push_retry()
        if not self.dags:
            return scheduled
        deltas = self._probe()
        for dag in self.dags.values():
            did = dag.dag_id
            if (did in self._quiescent and not deltas.get(did)
                    and not self._retry_pending[did]
                    and not self._fail_new[did]):
                continue                  # nothing moved, frontier unchanged
            n_before = len(scheduled)
            self._schedule_dag(dag, scheduled)
            if len(scheduled) == n_before:
                self._quiescent.add(did)
            else:
                self._quiescent.discard(did)
        return scheduled

    def _schedule_dag(self, dag: DAG, scheduled: List[str]) -> None:
        did = dag.dag_id
        clock = self.clock_fn()
        rows: List[dict] = []
        pushes: Dict[str, List[dict]] = {}
        done, running = self._done[did], self._running[did]
        failed, candidates = self._failed[did], self._candidates[did]
        # retries first, so a retrying task is marked running before the
        # frontier below could mistake it for never-scheduled
        retries, self._retry_pending[did] = self._retry_pending[did], {}
        for t in sorted(retries):
            self._stage(did, dag.tasks[t], retries[t], clock, rows, pushes)
            running.add(t)
            scheduled.append(f"{did}.{t}#retry{retries[t]}")
        # propagate permanent failure downstream (transitively, so only the
        # originally failed task needs walking)
        fail_new, self._fail_new[did] = self._fail_new[did], set()
        for t in sorted(fail_new):
            for d in sorted(dag.downstream_of(t)):
                if d in done or d in failed:
                    continue
                # d can never hold a pending retry here: a task downstream of
                # a newly permanently-failed task was never schedulable, and
                # _apply_rows refuses retries for tasks already in ``failed``
                failed.add(d)
                candidates.discard(d)
                rows.append({"dag": did, "task": d, "try": 1,
                             "status": "upstream_failed", "clock": clock})
        # ready frontier: candidates are maintained by the indegree counters;
        # running/failed membership is already kept out of the set, the
        # difference below only guards same-tick transitions
        for t in sorted(candidates - running - failed - done):
            self._stage(did, dag.tasks[t], 1, clock, rows, pushes)
            running.add(t)
            candidates.discard(t)
            scheduled.append(f"{did}.{t}")
        self._flush(rows, pushes)

    def _stage(self, did: str, task: Task, try_n: int, clock: float,
               rows: List[dict], pushes: Dict[str, List[dict]]) -> None:
        rows.append({"dag": did, "task": task.name, "try": try_n,
                     "status": "queued", "clock": clock})
        msg = self.build_message(did, task, try_n)
        tr = self.tracer
        if tr is not None:
            s = tr.sample
            if s >= 1.0:
                tid = f"{did}/{task.name}"
            elif s <= 0.0:
                tid = None
            else:
                # deterministic stride sampling: the sim stages tasks in a
                # deterministic order, so the same workload traces the same
                # tasks on every run — and the unsampled hot path pays one
                # int op instead of an f-string + checksum per task
                n = self._stage_n = self._stage_n + 1
                tid = f"{did}/{task.name}" if n % self._stride == 0 else None
            if tid:
                # keyed root: a retry re-stage reuses the surviving root span
                ctx = tr.open_keyed(("task", did, task.name), "task", "task",
                                    trace_id=tid, t0=clock)
                self._staged_spans.append((ctx, clock))
                msg["trace"] = ctx      # downstream spans parent under root
        pushes.setdefault(queue_for(task, self.cost_aware), []).append(msg)

    @staticmethod
    def build_message(did: str, task: Task, try_n: int) -> dict:
        """The broker message for a task instance — also what crash recovery
        re-pushes, so a reseeded message is byte-identical to a staged one."""
        return {"dag": did, "task": task.name, "kind": task.kind,
                "payload": task.payload, "try": try_n}

    def note_inflight(self, dag_id: str, task: str) -> None:
        """Crash recovery: the broker still holds a message for this task but
        its taskdb row was lost with the uncommitted tail. Mark it running so
        the frontier does not stage a duplicate; the broker's (flagged) copy
        carries the execution, and its committed rows restore the real state."""
        if dag_id not in self.dags or task not in self.dags[dag_id].tasks:
            return
        if task in self._done[dag_id] or task in self._failed[dag_id]:
            return
        self._running[dag_id].add(task)
        self._candidates[dag_id].discard(task)
        self._quiescent.discard(dag_id)

    def _flush(self, rows: List[dict],
               pushes: Dict[str, List[dict]]) -> None:
        """Commit the tick's staged work: rows before pushes, so no worker can
        pull a task instance whose queued row is not yet visible."""
        if self.batched:
            if rows:
                self.client.call("taskdb", {"op": "upsert_many", "rows": rows})
            for queue in sorted(pushes):
                self._push(queue, pushes[queue])
        else:
            for row in rows:
                self.client.call("taskdb", {"op": "upsert", **row})
            for queue in sorted(pushes):
                for m in pushes[queue]:
                    self.client.call(self.broker_for(queue),
                                     {"op": "push", "queue": queue, "msg": m})
        # schedule spans are recorded once the placement RPCs land; a crash
        # mid-flush drops the staged tuples with the dead scheduler — the
        # aborted attempt never hits the tracer, and the post-recovery
        # re-stage records the one schedule span that actually committed
        if self._staged_spans:
            tr = self.tracer
            t1 = tr.clock()              # one read for the whole batch
            rec = tr.rec                 # raw event appends, one bound check
            for ctx, t0 in self._staged_spans:
                rec((None, ctx, "schedule", "scheduler", t0, t1, "ok", None))
            tr.bound()
            self._staged_spans = []

    def _push(self, queue: str, msgs: List[dict],
              redelivered: bool = False) -> None:
        """Push a batch to its owning broker shard, surviving epoch fences
        and dead masters. The sim is synchronous, so a bounce means the batch
        was NOT applied (responses cannot be lost): stash it and re-push at
        the next tick — the migration freeze window and the failover repair
        both span a bounded number of ticks. Past ``PUSH_MAX_ATTEMPTS`` the
        batch's tasks are marked failed (their retry budget decides what
        happens next); the scheduler never hangs and never silently drops.

        The taskdb row for each message is already durable (rows flush before
        pushes), so a stashed batch that dies with a scheduler crash is
        re-seeded by recovery — the stash is an optimization, not the source
        of truth."""
        try:
            req = {"op": "push_many", "queue": queue, "msgs": msgs}
            if redelivered:
                req["redelivered"] = True
            resp = self.client.call(self.broker_for(queue), req)
        except DeliveryError:
            resp = None
        key = (queue, redelivered)
        if resp is not None and resp.get("ok", True):
            self._push_attempts.pop(key, None)
            return
        attempts = self._push_attempts.get(key, 0) + 1
        self._push_attempts[key] = attempts
        if attempts <= self.PUSH_MAX_ATTEMPTS:
            self._push_retry.setdefault(key, []).extend(msgs)
            self.stats["push_retries"] += 1
            return
        # bound exhausted: surface as task failures, never a hang
        clock = self.clock_fn()
        rows = [{"dag": m["dag"], "task": m["task"], "try": m["try"],
                 "status": "failed", "clock": clock} for m in msgs]
        try:
            self.client.call("taskdb", {"op": "upsert_many", "rows": rows})
            self._push_attempts.pop(key, None)
            self.stats["push_gave_up"] += len(msgs)
        except DeliveryError:
            # even the failure report could not land: keep the batch, the
            # attempt counter stays saturated so the report retries next tick
            self._push_retry.setdefault(key, []).extend(msgs)

    def _drain_push_retry(self) -> None:
        """Re-push every stashed batch (tick start, before new staging so a
        retried batch keeps its place ahead of this tick's frontier)."""
        for key in sorted(self._push_retry):
            msgs = self._push_retry.pop(key)
            self._push(key[0], msgs, redelivered=key[1])

    # ------------------------------------------------------------------ observation
    def dag_status(self, dag_id: str) -> Dict[str, str]:
        """Cached-state read: one shared delta probe, never a ``dag_state``
        round-trip — the cache is exactly as fresh as the probe's cursor."""
        self._probe()
        state = self._state.get(dag_id, {})
        return {t: state.get(t, {}).get("status", "pending")
                for t in self.dags[dag_id].tasks}

    def dag_done(self, dag_id: str, probe: bool = True) -> bool:
        """O(1) after the probe: the incremental done/failed sets partition
        the terminal tasks (``failed`` includes upstream_failed).

        ``probe=False`` skips the delta round-trip and answers from the sets
        as of the last probe — right for a driver loop that just ticked
        (doneness then lags commits by at most one tick, and terminal states
        never regress), wrong for a caller needing read-your-writes."""
        if probe:
            self._probe()
        dag = self.dags[dag_id]
        return (len(self._done[dag_id]) + len(self._failed[dag_id])
                == len(dag.tasks))

    def dag_success(self, dag_id: str, probe: bool = True) -> bool:
        if probe:
            self._probe()
        return len(self._done[dag_id]) == len(self.dags[dag_id].tasks)
