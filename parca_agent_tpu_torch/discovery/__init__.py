"""Target discovery (reference pkg/discovery): the port's copy of
parca_agent_tpu's discovery/."""

from parca_agent_tpu_torch.discovery.manager import DiscoveryManager, Group
from parca_agent_tpu_torch.discovery.systemd import SystemdDiscoverer
from parca_agent_tpu_torch.discovery.cgroup import CgroupContainerDiscoverer

__all__ = [
    "DiscoveryManager", "Group", "SystemdDiscoverer",
    "CgroupContainerDiscoverer",
]
