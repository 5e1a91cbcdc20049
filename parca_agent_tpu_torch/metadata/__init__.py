"""Per-PID metadata providers (reference pkg/metadata).

The port's copy of parca_agent_tpu's metadata/__init__.py.
"""

from parca_agent_tpu_torch.metadata.providers import (
    CgroupProvider,
    CompilerProvider,
    ProcessProvider,
    Provider,
    ServiceDiscoveryProvider,
    SystemProvider,
    TargetProvider,
)

__all__ = [
    "Provider", "ProcessProvider", "CgroupProvider", "SystemProvider",
    "CompilerProvider", "TargetProvider", "ServiceDiscoveryProvider",
]
