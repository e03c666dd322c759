"""Copy of ``repro.autoscale`` under ``repro_torch``.

Elastic autoscaling plane: queue-depth-driven worker fleets.

The paper splits management between a GLOBAL plane (the master cluster's
overwatch + dispatcher, deciding *where* work runs across the hybrid fleet)
and LOCAL planes (each cluster's control agent + its own scheduler, deciding
*how* pods run inside one partition). This subsystem closes the loop between
them for pipeline worker fleets:

  * the data plane publishes per-queue backlog under ``/queues/<name>``
    (broker ``changed_depths`` -> composer sweep-cadence publisher) — a
    LOCAL-plane fact surfaced into the GLOBAL plane's watch-materialized
    views;
  * a :class:`~repro_torch.autoscale.policy.ScalingPolicy` per queue family turns
    that backlog into a desired replica count (target ready-depth per worker,
    min/max bounds, step limits, hysteresis bands, cooldowns);
  * the :class:`~repro_torch.autoscale.reconciler.Reconciler` — a GLOBAL-plane
    control loop beside the dispatcher — diffs desired vs. actual worker-pod
    inventory (reconciled against the overwatch ``/jobs/<id>/placement``
    records, published under ``/autoscale/<family>`` for observability) and
    submits or retires worker-pod jobs through the dispatcher's existing
    depth-aware placement (``tags={"queues": [...]}``);
  * scale-down is loss-free: each victim runs the worker drain protocol
    (stop pulling, execute + commit the in-flight batch, final ack, publish
    drained state), so no broker lease is left to expire and no task is
    redelivered or double-executed;
  * per-cluster capacity quotas with preferred-first placement make the
    paper's hybrid story mechanical: bursts fill the preferred (on-prem)
    clusters to quota, then SPILL OVER into eligible public-cloud clusters,
    and scale-down retreats from the spillover clusters first.

The LOCAL plane still executes: a spawned worker-pod job lands on some
cluster's control agent exactly like any dispatched job, and the pipeline
composer materializes the corresponding :class:`PipelineWorker` there — the
reconciler never talks to a cluster directly, only through the dispatcher
and the overwatch, preserving the paper's thin-boundary discipline.
"""
from repro_torch.autoscale.policy import ScalingPolicy
from repro_torch.autoscale.reconciler import PodRecord, Reconciler

__all__ = ["ScalingPolicy", "Reconciler", "PodRecord"]
