"""Kubernetes pod discovery: node-filtered pod watch joined to local PIDs
(the port's copy of parca_agent_tpu's discovery/kubernetes.py).

Role of the reference's pkg/discovery/kubernetes.go:76-133 +
kubernetes/podinformer.go:47-96: watch the pods scheduled to THIS node,
resolve each running container to PIDs, and emit one Group per container
with node/namespace/pod/container/containerid labels.

Two deliberate departures from the reference, both TPU-era-host friendly:

  * PID resolution does not speak CRI sockets (the role of
    kubernetes/containerruntimes/containerruntimes.go:78-81). All runtimes
    embed the 64-hex container id in the cgroup path, so joining pod
    container ids against the /proc/*/cgroup scan (discovery/cgroup.py)
    covers docker/containerd/cri-o with one code path and no socket
    permissions.
  * The API client is a seam, not a dependency. `PodLister` is any
    callable returning plain `PodInfo` rows; production uses
    `InClusterPodLister` (stdlib HTTPS against the service-account
    credentials every in-cluster pod has — no client package needed);
    tests inject a fake (SURVEY.md §4 fs-injection pattern applied to the
    API boundary, which the reference never did — its discoverer is only
    testable against a live cluster).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Protocol

from parca_agent_tpu_torch.discovery.cgroup import CgroupContainerDiscoverer
from parca_agent_tpu_torch.discovery.manager import Group

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclasses.dataclass(frozen=True)
class ContainerInfo:
    """One running container of a pod (status.containerStatuses entry)."""

    name: str
    container_id: str  # bare 64-hex id, runtime prefix stripped
    running: bool = True
    raw_id: str = ""   # prefixed form ('containerd://<hex>') for CRI dispatch


@dataclasses.dataclass(frozen=True)
class PodInfo:
    """The slice of a Pod object discovery needs."""

    name: str
    namespace: str
    uid: str
    node: str
    containers: tuple[ContainerInfo, ...] = ()


class PodLister(Protocol):
    def __call__(self, node: str) -> list[PodInfo]: ...


def strip_runtime_prefix(container_id: str) -> str:
    """'containerd://<hex>' / 'docker://<hex>' -> '<hex>'
    (kubernetes.go containerIDFromPodStatus analog)."""
    return container_id.rsplit("//", 1)[-1]


def _field(d: dict, camel: str, snake: str):
    """API JSON uses camelCase; the official client's to_dict() emits
    snake_case. Accept either so both lister paths share this parser."""
    v = d.get(camel)
    return d.get(snake) if v is None else v


def parse_pod_list(doc: dict) -> list[PodInfo]:
    """Plain-data projection of a k8s PodList document."""
    pods = []
    for item in doc.get("items") or []:
        meta = item.get("metadata") or {}
        status = item.get("status") or {}
        containers = []
        for cs in _field(status, "containerStatuses",
                         "container_statuses") or []:
            raw = _field(cs, "containerID", "container_id") or ""
            cid = strip_runtime_prefix(raw)
            if not cid:
                continue  # not started yet
            containers.append(ContainerInfo(
                name=cs.get("name") or "",
                container_id=cid,
                running="running" in {k for k, v in
                                      (cs.get("state") or {}).items() if v},
                raw_id=raw,
            ))
        pods.append(PodInfo(
            name=meta.get("name") or "",
            namespace=meta.get("namespace") or "",
            uid=meta.get("uid") or "",
            node=_field(item.get("spec") or {}, "nodeName", "node_name") or "",
            containers=tuple(containers),
        ))
    return pods


class InClusterPodLister:
    """Node-filtered pod listing over the in-cluster API, stdlib-only.

    Uses the service-account token + CA certificate mounted into every
    pod and the KUBERNETES_SERVICE_{HOST,PORT} env vars — the same
    credentials client-go's rest.InClusterConfig() reads. The HTTP opener
    is injectable so the URL/headers contract is testable offline.
    """

    def __init__(self, sa_dir: str = _SA_DIR,
                 env: dict[str, str] | None = None,
                 opener: Callable[[str, dict[str, str]], bytes] | None = None):
        env = os.environ if env is None else env
        host = env.get("KUBERNETES_SERVICE_HOST")
        port = env.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "not running in a cluster (KUBERNETES_SERVICE_HOST unset)")
        self._base = f"https://{host}:{port}"
        self._sa_dir = sa_dir
        self._opener = opener or self._https_get

    def _https_get(self, url: str, headers: dict[str, str]) -> bytes:
        import ssl
        import urllib.request

        ctx = ssl.create_default_context(
            cafile=os.path.join(self._sa_dir, "ca.crt"))
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
            return resp.read()

    def __call__(self, node: str) -> list[PodInfo]:
        with open(os.path.join(self._sa_dir, "token")) as f:
            token = f.read().strip()
        url = (f"{self._base}/api/v1/pods"
               f"?fieldSelector=spec.nodeName%3D{node}")
        raw = self._opener(url, {"Authorization": f"Bearer {token}"})
        return parse_pod_list(json.loads(raw))


def default_pod_lister() -> PodLister:
    """Prefer the official client package when present (kubeconfig
    support for out-of-cluster runs), else the stdlib in-cluster path."""
    try:
        from kubernetes import client, config  # type: ignore

        try:
            config.load_incluster_config()
        except Exception:
            config.load_kube_config()
        core = client.CoreV1Api()

        def lister(node: str) -> list[PodInfo]:
            resp = core.list_pod_for_all_namespaces(
                field_selector=f"spec.nodeName={node}")
            return parse_pod_list(resp.to_dict() if hasattr(resp, "to_dict")
                                  else resp)

        return lister
    except ImportError:
        return InClusterPodLister()


@dataclasses.dataclass
class PodDiscoverer:
    """node=None resolves from KUBERNETES_NODE_NAME (the DaemonSet sets it
    from spec.nodeName) then the hostname; lister=None wires the default
    API client at first scrape so construction never needs a cluster."""

    node: str | None = None
    poll_s: float = 5.0
    lister: PodLister | None = None
    cgroups: CgroupContainerDiscoverer = dataclasses.field(
        default_factory=CgroupContainerDiscoverer
    )
    # Fallback pid resolver for containers the cgroup scan missed — the
    # scan/list race (container started between the two) and transient
    # /proc read failures: anything with pid_from_container_id(raw_id)
    # -> int, normally discovery.cri.CRIResolver. None disables the
    # fallback. The runtime answers with a HOST-namespace pid, so the
    # answer is adopted only after _validate_cri_pid confirms that pid's
    # cgroup names this container in this agent's /proc view (needs
    # hostPID, which deploy/daemonset.yaml mandates; an agent outside
    # the host pid namespace rejects the pid instead of mislabeling a
    # stranger, and a cgroup layout that hides the id entirely stays
    # unresolved by design).
    cri: object | None = None
    # Failed CRI resolutions are not retried for this long: each attempt
    # can block scrape() for the client's dial timeout, and container
    # churn makes "status says running, runtime says gone" routine.
    cri_negative_ttl_s: float = 30.0
    _cri_failed_until: dict = dataclasses.field(default_factory=dict,
                                                repr=False)

    def __post_init__(self):
        if not self.node:
            import socket

            self.node = (os.environ.get("KUBERNETES_NODE_NAME")
                         or socket.gethostname())

    def _validate_cri_pid(self, pid: int, container_id: str) -> bool:
        """The runtime reports the container's pid in the HOST pid
        namespace. Adopt it only if this agent's /proc agrees it is that
        container's process: /proc/<pid>/cgroup must mention the bare
        container id. An agent outside the host pid namespace (or a pid
        raced by reuse) fails this check and the pid is discarded rather
        than profiled under a stranger's labels."""
        try:
            cg = self.cgroups.fs.read_bytes(f"/proc/{pid}/cgroup")
        except OSError:
            return False
        return container_id.encode() in cg

    def _cri_fallback(self, cs: ContainerInfo) -> list[int]:
        """Ask the runtime itself (the reference's only path,
        containerruntimes.go:78-81) when the cgroup scan is blind, with a
        negative cache so a dead/slow runtime socket cannot stall every
        poll."""
        now = time.monotonic()
        if self._cri_failed_until.get(cs.container_id, 0) > now:
            return []
        try:
            pid = self.cri.pid_from_container_id(cs.raw_id)
            if self._validate_cri_pid(pid, cs.container_id):
                return [pid]
        except Exception:  # noqa: BLE001 - runtime may be absent
            pass
        self._cri_failed_until[cs.container_id] = (
            now + self.cri_negative_ttl_s)
        if len(self._cri_failed_until) > 4096:  # bound on churny nodes
            self._cri_failed_until = {
                k: v for k, v in self._cri_failed_until.items() if v > now}
        return []

    def scrape(self) -> list[Group]:
        if self.lister is None:
            self.lister = default_pod_lister()
        pods = self.lister(self.node)
        # container id -> pids from the local cgroup scan.
        pid_groups = {g.labels.get("containerid"): g.pids
                      for g in self.cgroups.scrape()}
        groups = []
        for pod in pods:
            for cs in pod.containers:
                pids = pid_groups.get(cs.container_id, [])
                if not pids and self.cri is not None and cs.running \
                        and cs.raw_id:
                    pids = self._cri_fallback(cs)
                if not pids:
                    continue  # not on this node / already exited
                groups.append(Group(
                    source=f"pod/{pod.namespace}/{pod.name}/{cs.name}",
                    labels={
                        "node": self.node,
                        "namespace": pod.namespace,
                        "pod": pod.name,
                        "container": cs.name,
                        "containerid": cs.container_id,
                        "pod_uid": pod.uid,
                    },
                    pids=list(pids),
                    entry_pid=min(pids),
                ))
        return groups

    def run(self, stop: threading.Event,
            up: Callable[[list[Group]], None]) -> None:
        while not stop.is_set():
            try:
                up(self.scrape())
            except Exception:
                pass  # API hiccup; retry next poll
            stop.wait(self.poll_s)
