"""The worker side of the pipeline plane: the task kinds a pipeline worker runs on
the port (``handlers``). The scheduler, broker, task database and worker
themselves are framework-free and belong to the management plane."""
from repro_torch.pipelines.handlers import DEFAULT_HANDLERS, WarmHandlers

__all__ = ["DEFAULT_HANDLERS", "WarmHandlers"]
