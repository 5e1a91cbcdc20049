"""Container discovery from cgroup names — API-server-free (the port's
copy of parca_agent_tpu's discovery/cgroup.py).

The reference discovers containers through the kube API + CRI sockets
(pkg/discovery/kubernetes.go, kubernetes/containerruntimes/*). Neither is
reachable from tests or most dev hosts, so the first-class discoverer here
derives the same `container id -> pids` mapping from /proc/*/cgroup
directly: container runtimes (docker, containerd, cri-o) all embed the
64-hex container id in the cgroup path (the id-extraction role of
containerruntimes.go:83-165). The kube-API discoverer (kubernetes.py)
layers pod metadata on top when a cluster is reachable.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Callable

from parca_agent_tpu_torch.discovery.manager import Group
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

_CONTAINER_ID = re.compile(r"([0-9a-f]{64})")
_POD_UID = re.compile(r"pod([0-9a-f]{8}[-_][0-9a-f]{4}[-_][0-9a-f]{4}"
                      r"[-_][0-9a-f]{4}[-_][0-9a-f]{12})")


def parse_container_cgroup(cgroup_text: str) -> dict[str, str]:
    """Extract container id / pod uid labels from one /proc/PID/cgroup."""
    out: dict[str, str] = {}
    for line in cgroup_text.splitlines():
        m = _CONTAINER_ID.search(line)
        if m and "containerid" not in out:
            out["containerid"] = m.group(1)
        p = _POD_UID.search(line)
        if p and "pod_uid" not in out:
            out["pod_uid"] = p.group(1).replace("_", "-")
    return out


@dataclasses.dataclass
class CgroupContainerDiscoverer:
    fs: VFS = dataclasses.field(default_factory=RealFS)
    poll_s: float = 5.0

    def scrape(self) -> list[Group]:
        by_container: dict[str, Group] = {}
        try:
            entries = self.fs.listdir("/proc")
        except OSError:
            return []
        for name in entries:
            if not name.isdigit():
                continue
            pid = int(name)
            try:
                text = self.fs.read_bytes(f"/proc/{pid}/cgroup").decode(
                    errors="replace")
            except OSError:
                continue
            labels = parse_container_cgroup(text)
            cid = labels.get("containerid")
            if not cid:
                continue
            g = by_container.get(cid)
            if g is None:
                g = Group(source=f"cgroup/{cid}", labels=labels, pids=[])
                by_container[cid] = g
            g.pids.append(pid)
            if g.entry_pid == 0 or pid < g.entry_pid:
                g.entry_pid = pid
        return list(by_container.values())

    def run(self, stop: threading.Event,
            up: Callable[[list[Group]], None]) -> None:
        while not stop.is_set():
            up(self.scrape())
            stop.wait(self.poll_s)
