"""Copy of ``repro.pipelines.dag`` under ``repro_torch``.

Workflow DAGs of data-processing tasks (the Airflow model, paper §5).

A ``Task`` is a named unit with upstream dependencies, a kind (etl / train /
eval / export / custom python), a payload, and optional placement constraints
(``requires`` capability tags — the paper's compliance routing). A ``DAG``
validates acyclicity and yields ready sets; scheduling/execution live in
scheduler.py / worker.py.
``DAG`` precomputes the downstream adjacency (``children``) once at
construction, so validation, topological order and failure propagation are
O(V + E) — the seed rescanned every task per visited node, which is quadratic
and unusable at the 50k-task scale the pipeline benchmarks run at.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Task:
    name: str
    kind: str = "python"                 # etl | train | eval | export | python
    upstream: Tuple[str, ...] = ()
    payload: dict = dataclasses.field(default_factory=dict)
    requires: Tuple[str, ...] = ()       # capability tags (compliance routing)
    retries: int = 1
    fn: Optional[Callable[[dict], dict]] = None   # python tasks (tests/examples)
    # explicit roofline cost vector (flops/hbm_bytes/collective_bytes/io_bytes
    # — e.g. a committed hlo_stats dry-run artifact); None defers to
    # ``repro_torch.roofline.cost.task_cost``'s payload/analytic fallbacks
    cost: Optional[dict] = None


class DAG:
    def __init__(self, dag_id: str, tasks: Sequence[Task]):
        self.dag_id = dag_id
        self.tasks: Dict[str, Task] = {}
        for t in tasks:
            if t.name in self.tasks:
                raise ValueError(f"duplicate task {t.name}")
            self.tasks[t.name] = t
        # downstream adjacency, one entry per upstream edge occurrence so the
        # indegree arithmetic matches the declared tuples exactly
        self.children: Dict[str, List[str]] = {n: [] for n in self.tasks}
        self._validate()

    def _validate(self) -> None:
        for t in self.tasks.values():
            for u in t.upstream:
                if u not in self.tasks:
                    raise ValueError(f"{t.name} depends on unknown task {u}")
                self.children[u].append(t.name)
        order = self.topological_order()
        if len(order) != len(self.tasks):
            raise ValueError(f"cycle in DAG {self.dag_id}")

    def topological_order(self) -> List[str]:
        indeg = {n: len(t.upstream) for n, t in self.tasks.items()}
        ready = [n for n, d in indeg.items() if d == 0]
        heapq.heapify(ready)                 # name order among the ready set
        out: List[str] = []
        while ready:
            n = heapq.heappop(ready)
            out.append(n)
            for m in self.children[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    heapq.heappush(ready, m)
        return out

    def ready_tasks(self, done: set, running: set, failed: set) -> List[Task]:
        """Tasks whose upstreams are all done and which are not yet scheduled."""
        out = []
        for n, t in self.tasks.items():
            if n in done or n in running or n in failed:
                continue
            if all(u in done for u in t.upstream):
                out.append(t)
        return sorted(out, key=lambda t: t.name)

    def downstream_of(self, name: str) -> set:
        out: set = set()
        stack = [name]
        while stack:
            for m in self.children[stack.pop()]:
                if m not in out:
                    out.add(m)
                    stack.append(m)
        return out
