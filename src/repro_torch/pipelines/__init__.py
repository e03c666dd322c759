"""Copy of ``repro.pipelines`` under ``repro_torch``: hybrid workflow orchestration
(paper §5: Cloud Composer / Apache Airflow).

Scheduler + broker + task DB live on the master partition; workers live on any
partition and reach them exclusively through the hybrid platform's gateway
routes — the exact pod-service dependency graph of Figure 3. The task kinds a
worker runs on the port are ``handlers``' ``DEFAULT_HANDLERS``; ``WarmHandlers``
is one worker's warm set of them.
"""
from repro_torch.pipelines.dag import DAG, Task
from repro_torch.pipelines.composer import HybridComposer
from repro_torch.pipelines.handlers import DEFAULT_HANDLERS, WarmHandlers

__all__ = ["DAG", "Task", "HybridComposer", "DEFAULT_HANDLERS", "WarmHandlers"]
