"""Copy of ``repro.pipelines.worker`` under ``repro_torch``.

Pipeline worker (the privately-hosted Airflow worker of paper §5/Figure 3).

A worker is an application POD: it lives on some partition, pulls task
instances from the broker, executes them, and commits results to the taskdb —
both services resolved by name through the hybrid platform (the worker has no
idea they live on the master cluster; cross-cloud traffic flows gateway ->
channel -> gateway exactly as in Figure 2 of the paper).

Built-in task kinds run the port's substrate; they are the port's
``DEFAULT_HANDLERS`` (``repro_torch.pipelines.handlers``):
  etl    — deterministic shard statistics over the synthetic pipeline
  train  — a Trainer run (payload: arch/steps/...); resumes
           from its own checkpoint_dir and runs only the remaining steps
  eval   — forward loss on held-out batches; a ``restore_from`` manifest is
           restored STRICTLY (missing/torn checkpoint fails the task)
  serve  — synthetic prompts through the continuous-batching Server
  export — parameter manifest (count + tree paths)
Custom kinds register via ``register(kind, fn)``.

Warm workers (the step cache): ``step_cache > 0`` binds train/eval/serve to
the worker's ``WarmHandlers``, whose LRU caches of built Trainer/Server
objects are keyed by family (``repro_torch.runtime.step_cache``) — a
same-family task skips the model build and pays only its actual steps.
``step_cache=0`` keeps the seed's cold build-per-task behavior.

Commit pipelining (the data-plane throughput overhaul): a pipelined worker
drains up to ``batch`` task instances per queue per tick with ONE broker
``pull_many``, executes them, then commits the whole batch with ONE taskdb
``upsert_many`` (a running + terminal row pair per task, applied in order)
and ONE broker ``ack_many`` — 3 RPCs per batch instead of 4 per task. A task
that is pulled but never committed (worker death) is simply redelivered when
its broker lease expires, exactly as in the per-task protocol; the terminal
taskdb states of both protocols are identical (``pipelined=False`` keeps the
seed's per-task path for equivalence tests and the benchmark baseline).

Cross-boundary locality (the traffic overhaul): ``broker_for`` routes each
queue's ops to its owning broker shard's service (``BrokerRouter`` — one
``ack_many`` per shard that leased work, still one RPC total when unsharded),
and an optional ``depth_hint`` (the cluster-local, watch-materialized
``/queues/<name>`` view — maintained by the replica-fed notify plane, so any
number of workers share one shipped envelope per sweep) skips the
``pull_many`` round-trip entirely for queues the local view shows empty — a
remote worker polling idle queues stops paying a cross-boundary RPC per
queue per tick. A stale-zero hint only
delays the pull by the replica's staleness bound; a stale-positive hint costs
one empty pull — both degrade to the ungated protocol.

Drain protocol (the autoscaling plane): a worker being retired must hand its
slot back WITHOUT losing or re-running any leased task. The tick is split
into two explicit phases around an in-flight buffer —

  ``pull_phase``   lease up to ``batch`` messages per queue into the buffer;
  ``commit_phase`` execute the buffer, ONE ``upsert_many`` with every
                   (running, terminal) row pair, then ONE final ``ack_many``;

and ``drain()`` runs the graceful exit: stop pulling (state -> ``draining``),
execute + commit whatever is in flight, final-ack it, then flip to
``drained`` and fire ``on_drained`` (the autoscaler's hook that retires the
pod's job and publishes the drained state). Because every leased tag is
acked exactly after its terminal row is durable, the broker is left with no
lease to expire — nothing is redelivered, nothing runs twice. A drained
worker's ``tick()`` is a no-op forever after.

Crash survival (the durable control plane): workers live on their own
clusters and SURVIVE a master crash — the recovery contract has three parts.
(1) An executed-but-uncommitted batch is stashed in ``_pending_commit``
before any RPC, so a commit interrupted by master death retries verbatim
(same rows, same tags) instead of re-running handlers. (2) Messages the
broker redelivers arrive flagged; before executing a flagged message the
worker probes the taskdb (``status_many``) and skips anything already
terminal — the cross-restart dedup that makes redelivery safe. (3)
``reset_after_master_restart()`` drops unexecuted leases (the recovered
broker already requeued them) and re-arms the worker; its small ring of
recently executed terminal rows (``recent_rows``) is re-upserted by the
composer's recovery barrier, closing the window where an execution's row was
still volatile when the master died.
"""
from __future__ import annotations

import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.pipelines.handlers import DEFAULT_HANDLERS, WarmHandlers
from repro_torch.pipelines.services import ServiceClient


class PipelineWorker:
    def __init__(self, client: ServiceClient, pod: str,
                 queues: Tuple[str, ...] = ("default",), clock_fn=None,
                 batch: int = 16, pipelined: bool = True,
                 on_drained: Optional[Callable[["PipelineWorker"], None]]
                 = None,
                 broker_for: Optional[Callable[[str], str]] = None,
                 depth_hint: Optional[Callable[[str], int]] = None,
                 step_cache: int = 4, tracer=None, metrics=None):
        self.client = client
        self.pod = pod
        # flight recorder: traced messages get an "execute" span around the
        # handler and a "commit" span that stays open until the batch's acks
        # land (a master-crash-interrupted commit retries verbatim, and its
        # spans close when the retry commits — worker spans never truncate);
        # ``metrics`` records per-queue-family service-time histograms at ack
        # time (the predictive autoscaler's future input), sampled or not
        self.tracer = tracer
        self.metrics = metrics
        self._pending_trace: List[tuple] = []   # (queue, wall_s, commit_span)
        self.queues = tuple(queues)
        self.handlers = dict(DEFAULT_HANDLERS)
        # warm-worker step cache: train/eval/serve handlers reuse a built
        # Trainer/Server across tasks of the same family instead of
        # rebuilding per task. 0 disables (cold per-task builds — the
        # benchmark baseline). The WarmHandlers and their caches are created
        # lazily on first use so a control-plane-only worker never imports
        # the models.
        self.step_cache = max(int(step_cache), 0)
        self._warm: Optional[WarmHandlers] = None
        if self.step_cache:
            self.handlers["train"] = self._cached_train
            self.handlers["eval"] = self._cached_eval
            self.handlers["serve"] = self._cached_serve
        self.clock_fn = clock_fn or (lambda: 0.0)
        self.batch = max(int(batch), 1)
        self.pipelined = pipelined
        # queue -> broker service (per-family sharding); default: the single
        # unsharded "broker" service, exactly the pre-sharding wire protocol
        self.broker_for = broker_for or (lambda queue: "broker")
        # queue -> believed ready depth, served from the cluster-local
        # overwatch replica (fan-out mode). 0 skips the pull round-trip for
        # that queue this tick — an empty remote queue no longer costs a
        # cross-boundary pull_many per tick. None (default): always pull.
        self.depth_hint = depth_hint
        self.skipped_pulls = 0
        self.executed = 0
        self.deduped = 0                # flagged redeliveries skipped as done
        self.state = "running"          # running | draining | drained
        self.on_drained = on_drained
        # leased, uncommitted: (msg, tag, broker service, redelivered flag,
        # queue name)
        self._inflight: List[Tuple[dict, int, str, bool, str]] = []
        # executed but not yet successfully committed: (rows, acks, executed)
        self._pending_commit: Optional[tuple] = None
        # resync ring: terminal rows this worker produced, re-upserted at the
        # composer's recovery barrier in case their commit was still volatile
        # when the master died (maxlen >> one tick's commit window)
        self.recent_rows: deque = deque(maxlen=1024)

    def register(self, kind: str, fn: Callable[[dict], dict]) -> None:
        self.handlers[kind] = fn

    # ------------------------------------------------------ warm task handlers
    def warm_handlers(self) -> WarmHandlers:
        if self._warm is None:
            self._warm = WarmHandlers(self.step_cache)
        return self._warm

    def trainer_cache(self):
        return self.warm_handlers().trainer_cache()

    def server_cache(self):
        return self.warm_handlers().server_cache()

    def _cached_train(self, payload: dict) -> dict:
        return self.warm_handlers().handlers["train"](payload)

    def _cached_eval(self, payload: dict) -> dict:
        return self.warm_handlers().handlers["eval"](payload)

    def _cached_serve(self, payload: dict) -> dict:
        return self.warm_handlers().handlers["serve"](payload)

    # --------------------------------------------------------------------- one tick
    def tick(self) -> List[str]:
        """Drain up to ``batch`` tasks per queue; returns the executed ids."""
        if self.state == "drained":
            return []
        if not self.pipelined:
            if self.state == "draining":
                self._finish_drain()
                return []
            one = self._tick_sync()
            return [one] if one else []
        if self.state == "running":
            self.pull_phase()
        executed = self.commit_phase()
        if self.state == "draining":
            self._finish_drain()
        return executed

    # ------------------------------------------------------------ batch phases
    def pull_phase(self) -> int:
        """Phase 1: lease up to ``batch`` task instances per queue into the
        in-flight buffer (one ``pull_many`` per queue). A draining worker
        never pulls — the first step of the drain protocol."""
        if self.state != "running":
            return 0
        if self._pending_commit is not None:
            return 0                 # commit backlog first: no new leases
        pulled = 0
        for queue in self.queues:
            if self.depth_hint is not None and not self.depth_hint(queue):
                self.skipped_pulls += 1      # local view says empty: no RPC
                continue
            svc = self.broker_for(queue)
            resp = self.client.call(svc, {"op": "pull_many",
                                          "queue": queue,
                                          "max_n": self.batch})
            msgs = resp.get("msgs") or []
            tags = resp.get("tags") or []
            flags = resp.get("redelivered") or [False] * len(msgs)
            self._inflight.extend(
                (m, t, svc, f, queue) for m, t, f in zip(msgs, tags, flags))
            pulled += len(msgs)
        return pulled

    def commit_phase(self) -> List[str]:
        """Phase 2: execute the in-flight buffer, then commit it with ONE
        taskdb ``upsert_many`` and ONE broker ``ack_many`` per broker shard
        that leased work this batch (exactly one with an unsharded broker).
        Rows are durable before any broker forgets its leases, so a crash
        between the two at worst re-runs already-committed tasks (same-try
        upserts are idempotent), never loses one.

        The executed batch is stashed in ``_pending_commit`` BEFORE the
        commit RPCs: if the master dies mid-commit the stash retries verbatim
        on the recovery barrier (or the next tick after a heal) — handlers
        never re-run for a batch that already executed. Flagged (redelivered)
        messages are dedup-probed against the taskdb first; the probe costs
        nothing on the clean path, where no flags arrive."""
        if self._pending_commit is None:
            if not self._inflight:
                return []
            batch, self._inflight = self._inflight, []
            # dedup BEFORE executing: probing raises (master down) with
            # nothing run yet, so dropping the batch back to lease expiry is
            # always duplicate-free
            done = self._probe_terminal(batch)
            rows: List[dict] = []
            acks: Dict[str, List[int]] = {}  # broker service -> leased tags
            executed: List[str] = []
            seen: set = set()
            # one clock read covers the batch: execution is instantaneous in
            # simulated time (the clock only advances between ticks)
            tnow = self.tracer.clock() if self.tracer is not None else 0.0
            for msg, tag, svc, redel, queue in batch:
                key = (msg["dag"], msg["task"], msg["try"])
                if (redel and key in done) or key in seen:
                    self.deduped += 1        # already ran (here or elsewhere)
                else:
                    seen.add(key)
                    pair = self._run_traced(msg, queue, tnow)
                    rows.extend(pair)
                    self.recent_rows.append(pair[-1])
                    executed.append(f"{msg['dag']}.{msg['task']}")
                acks.setdefault(svc, []).append(tag)
            self._pending_commit = (rows, acks, executed)
        rows, acks, executed = self._pending_commit
        if rows:
            self.client.call("taskdb", {"op": "upsert_many", "rows": rows})
        for svc in sorted(acks):
            self.client.call(svc, {"op": "ack_many", "tags": acks[svc]})
        self._pending_commit = None
        self._finish_commit_trace()
        return executed

    def _run_traced(self, msg: dict, queue: str, tnow: float) -> List[dict]:
        """``_run`` plus flight-recorder bookkeeping: the outcome of the
        "execute" span (with the task's step EMA when the runtime reports
        one) and the start of the "commit" span are STASHED, not recorded —
        ``_finish_commit_trace`` appends both once this batch's acks land,
        so after a master crash the stashed batch retries verbatim and its
        spans are recorded exactly once, by the attempt that commits. The
        execution wall time is stashed alongside for the service-time
        histogram, traced or not. ``tnow`` is the batch's single clock read
        — execution is instantaneous in simulated time (the clock only
        advances between ticks); its real cost rides in the ``wall_s``
        attr."""
        w0 = time.perf_counter()
        pair = self._run(msg)
        wall = time.perf_counter() - w0
        ctx = msg.get("trace") if self.tracer is not None else None
        if ctx is not None:
            terminal = pair[-1]
            res = terminal.get("result")
            ema = (res.get("step_ema_s")
                   if isinstance(res, dict) else None)    # StepTimer's EMA
            st = "ok" if terminal["status"] == "success" else "failed"
        else:
            ema, st = None, "ok"
        self._pending_trace.append((queue, wall, ctx, tnow, st, ema))
        return pair

    def _finish_commit_trace(self) -> None:
        """The batch's acks landed: record each task's service time into the
        per-queue-family histogram and its execute/commit span pair — raw
        event appends, one clock read and one bound check per batch."""
        if not self._pending_trace:
            return
        pt, self._pending_trace = self._pending_trace, []
        tr = self.tracer
        metrics = self.metrics
        if tr is None:
            if metrics is not None:
                for queue, wall, _ctx, _t0, _st, _ema in pt:
                    metrics.observe(f"pipeline.service_time.{queue}", wall)
            return
        t1 = tr.clock()                  # one read per batch
        rec = tr.rec
        for queue, wall, ctx, t0, st, ema in pt:
            if metrics is not None:
                metrics.observe(f"pipeline.service_time.{queue}", wall)
            if ctx is not None:
                a = ({"wall_s": wall} if ema is None
                     else {"wall_s": wall, "step_ema_s": ema})
                rec((None, ctx, "execute", "worker", t0, t0, st, a))
                rec((None, ctx, "commit", "worker", t0, t1, "ok", None))
        tr.bound()

    def _probe_terminal(self, batch) -> set:
        """(dag, task, try) keys among the batch's FLAGGED messages that the
        taskdb already shows terminal — one ``status_many`` RPC, only issued
        when at least one message carries the redelivered flag."""
        flagged = [(m["dag"], m["task"], m["try"])
                   for m, _, _, redel, _ in batch if redel]
        if not flagged:
            return set()
        resp = self.client.call("taskdb", {
            "op": "status_many", "keys": [list(k) for k in flagged]})
        return {tuple(k) for k, st in zip(flagged, resp.get("statuses", ()))
                if st in ("success", "failed")}

    # -------------------------------------------------------- crash recovery
    def retry_pending(self) -> List[str]:
        """Re-issue a commit interrupted by master death (no-op otherwise)."""
        if self._pending_commit is None:
            return []
        return self.commit_phase()

    def reset_after_master_restart(self) -> int:
        """Recovery barrier: drop unexecuted leases (the recovered broker
        requeued them under fresh flags — holding them here would double-run),
        keep ``_pending_commit`` for retry, and clear any ``on_drained``
        closure wired to dead pre-crash services (the rebuilt autoscaler
        re-arms draining pods). Returns the number of dropped leases."""
        dropped = len(self._inflight)
        self._inflight = []
        self.on_drained = None
        return dropped

    # ------------------------------------------------------------------- drain
    def drain(self) -> List[str]:
        """Graceful exit: stop pulling, execute + commit the in-flight batch,
        final ack, then publish the drained state through ``on_drained``.
        Loss-free by construction — every lease this worker holds is acked
        after its terminal row commits, so the broker redelivers nothing."""
        if self.state == "drained":
            return []
        self.state = "draining"
        executed = self.commit_phase() if self.pipelined else []
        if self.pipelined and self._inflight:
            # a retried pending commit went first; flush the live buffer too
            executed += self.commit_phase()
        self._finish_drain()
        return executed

    def _finish_drain(self) -> None:
        if (self.state == "drained" or self._inflight
                or self._pending_commit is not None):
            return
        self.state = "drained"
        if self.on_drained is not None:
            self.on_drained(self)

    def _run(self, msg: dict) -> List[dict]:
        """Execute one task; return its (running, terminal) row pair."""
        key = {"dag": msg["dag"], "task": msg["task"], "try": msg["try"]}
        rows = [{**key, "status": "running", "worker": self.pod,
                 "clock": self.clock_fn()}]
        fn = self.handlers.get(msg["kind"])
        try:
            if fn is None:
                raise KeyError(f"no handler for kind {msg['kind']!r}")
            result = fn(dict(msg.get("payload") or {}))
            rows.append({**key, "status": "success", "result": result,
                         "worker": self.pod, "clock": self.clock_fn()})
        except Exception as e:                               # noqa: BLE001
            rows.append({**key, "status": "failed",
                         "error": f"{type(e).__name__}: {e}",
                         "worker": self.pod, "clock": self.clock_fn()})
            traceback.print_exc()
        self.executed += 1
        return rows

    # ------------------------------------------------------- per-task protocol
    def _tick_sync(self):
        """The seed's one-task path: pull, upsert(running), execute,
        upsert(terminal), ack — 4 RPCs per task."""
        for queue in self.queues:
            svc = self.broker_for(queue)
            resp = self.client.call(svc, {"op": "pull", "queue": queue})
            msg = resp.get("msg")
            if msg is None:
                continue
            self._execute(msg, resp.get("tag"), svc, queue)
            return f"{msg['dag']}.{msg['task']}"
        return None

    def _execute(self, msg: dict, tag, svc: str = "broker",
                 queue: Optional[str] = None) -> None:
        key = {"dag": msg["dag"], "task": msg["task"], "try": msg["try"]}
        self.client.call("taskdb", {"op": "upsert", **key, "status": "running",
                                    "worker": self.pod,
                                    "clock": self.clock_fn()})
        fn = self.handlers.get(msg["kind"])
        tr = self.tracer
        ctx = msg.get("trace") if tr is not None else None
        ts0 = tr.clock() if ctx is not None else 0.0
        t0 = time.perf_counter()
        ok = True
        try:
            if fn is None:
                raise KeyError(f"no handler for kind {msg['kind']!r}")
            result = fn(dict(msg.get("payload") or {}))
            if ctx is not None:
                tr.span_complete(ctx, "execute", "worker", ts0)
            self.client.call("taskdb", {"op": "upsert", **key,
                                        "status": "success", "result": result,
                                        "worker": self.pod,
                                        "clock": self.clock_fn()})
        except Exception as e:                               # noqa: BLE001
            ok = False
            if ctx is not None:
                tr.span_complete(ctx, "execute", "worker", ts0, "failed")
            self.client.call("taskdb", {
                "op": "upsert", **key, "status": "failed",
                "error": f"{type(e).__name__}: {e}",
                "worker": self.pod, "clock": self.clock_fn()})
            traceback.print_exc()
        finally:
            self.executed += 1
            tc0 = tr.clock() if ctx is not None else 0.0
            self.client.call(svc, {"op": "ack", "tag": tag})
            if self.metrics is not None and queue is not None:
                self.metrics.observe(f"pipeline.service_time.{queue}",
                                     time.perf_counter() - t0)
            if ctx is not None:
                tr.span_complete(ctx, "commit", "worker", tc0,
                                 "ok" if ok else "failed")
