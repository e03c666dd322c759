"""Copy of ``repro.core`` under ``repro_torch``."""
# Titchener management plane — the paper's primary contribution.
from repro_torch.core.plane import ManagementPlane, SimLocalPlane  # noqa: F401
from repro_torch.core.service_graph import AppSpec, Pod, Service  # noqa: F401
from repro_torch.core.transport import AclTable, DeliveryError, Fabric  # noqa: F401
