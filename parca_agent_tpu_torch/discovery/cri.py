"""Per-runtime container-id -> PID resolution (CRI clients): the port's
copy of parca_agent_tpu's discovery/cri.py, over this package's
pprof/proto.py.

Role of the reference's kubernetes/containerruntimes tree
(containerruntimes.go:78-81 CRIClient interface; docker/docker.go:65-82,
containerd/containerd.go:73-101, crio/crio.go:79-107): ask the container
runtime itself for a container's main PID. The primary resolution path
here remains the /proc/*/cgroup scan (discovery/cgroup.py) — it needs no
socket permissions and returns EVERY pid in the container — and the
runtime socket is the fallback for containers the scan missed (the
scan/list race, transient /proc read failures). The pid a runtime
returns is in the HOST pid namespace, so the consumer
(kubernetes.PodDiscoverer) validates it against the agent's own /proc
before adopting it — the fallback therefore still requires hostPID; it
does not substitute for it.

Same no-generated-stubs stance as agent/grpc_client.py: the docker client
speaks the engine's HTTP API over its unix socket with stdlib http.client,
and the CRI client hand-encodes the two protobuf messages it needs
(ContainerStatusRequest/Response) with pprof/proto.py, trying
runtime.v1 first and falling back to runtime.v1alpha2 (the generation the
reference pins) for older runtimes.
"""

from __future__ import annotations

import http.client
import json
import socket

from parca_agent_tpu_torch.pprof.proto import Writer, iter_fields
from parca_agent_tpu_torch.utils.log import get_logger

log = get_logger("cri")

DOCKER_SOCKET = "/run/docker.sock"
CONTAINERD_SOCKET = "/run/containerd/containerd.sock"
CONTAINERD_K3S_SOCKET = "/run/k3s/containerd/containerd.sock"
CRIO_SOCKET = "/run/crio/crio.sock"
DEFAULT_TIMEOUT_S = 2.0


class CRIError(RuntimeError):
    pass


class CRITransportError(CRIError):
    """Socket/channel-level failure (runtime down, wrong socket, hang) —
    as opposed to a per-container lookup miss, which is routine churn.
    The distinction drives CRIResolver's client eviction and circuit
    breaker: transport failures heal by rebuilding, lookup misses must
    not tear down a healthy channel."""


def split_runtime_prefix(container_id: str) -> tuple[str, str]:
    """'containerd://<hex>' -> ('containerd', '<hex>'). The runtime name
    is how the reference's Kubernetes client picks which CRI client to
    ask (kubernetes/kubernetes.go PIDFromContainerID dispatch)."""
    runtime, sep, bare = container_id.partition("://")
    if not sep or not bare:
        raise CRIError(f"container id {container_id!r} has no runtime://"
                       " prefix")
    return runtime, bare


class _UnixHTTPConnection(http.client.HTTPConnection):
    """HTTPConnection whose transport is an AF_UNIX stream socket."""

    def __init__(self, path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._path = path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        self.sock.connect(self._path)


class DockerClient:
    """Engine-API ContainerInspect -> .State.Pid
    (docker/docker.go:65-82; GET /containers/{id}/json)."""

    runtime = "docker"

    def __init__(self, socket_path: str = DOCKER_SOCKET,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self._path = socket_path
        self._timeout = timeout_s

    def pid_from_container_id(self, container_id: str) -> int:
        runtime, bare = split_runtime_prefix(container_id)
        if runtime != self.runtime:
            raise CRIError(f"invalid CRI {container_id}, it should be docker")
        conn = _UnixHTTPConnection(self._path, self._timeout)
        try:
            try:
                conn.request("GET", f"/containers/{bare}/json")
                resp = conn.getresponse()
                body = resp.read()
            except OSError as e:  # connect/read failure: engine is down
                raise CRITransportError(
                    f"docker engine at {self._path}: {e}") from e
            if resp.status != 200:
                raise CRIError(
                    f"docker inspect {bare}: HTTP {resp.status} "
                    f"{body[:200]!r}")
        finally:
            conn.close()
        state = (json.loads(body).get("State") or {})
        pid = state.get("Pid")
        if not pid:
            raise CRIError(f"docker inspect {bare}: no running pid in State")
        return int(pid)

    def close(self) -> None:  # connection-per-request; nothing held
        pass


def encode_container_status_request(container_id: str) -> bytes:
    """ContainerStatusRequest{container_id=1, verbose=2}; verbose=true is
    what makes the runtime attach the 'info' JSON carrying the pid
    (containerd.go:80-83)."""
    w = Writer()
    w.message(1, container_id.encode())
    w.varint(2, 1)
    return w.getvalue()


def decode_container_status_info(data: bytes) -> dict[str, str]:
    """ContainerStatusResponse: field 2 is map<string,string> info; each
    map entry is a nested message {key=1, value=2}."""
    info: dict[str, str] = {}
    for field, _wt, val in iter_fields(data):
        if field != 2 or not isinstance(val, bytes):
            continue
        key = value = ""
        for efield, _ewt, eval_ in iter_fields(val):
            if efield == 1 and isinstance(eval_, bytes):
                key = eval_.decode(errors="replace")
            elif efield == 2 and isinstance(eval_, bytes):
                value = eval_.decode(errors="replace")
        info[key] = value
    return info


def encode_container_status_response(info: dict[str, str],
                                     ) -> bytes:
    """The inverse of decode_container_status_info — the fake-runtime test
    servers use this to speak the wire format back."""
    w = Writer()
    for key, value in info.items():
        entry = Writer()
        entry.message(1, key.encode())
        entry.message(2, value.encode())
        w.message(2, entry.getvalue())
    return w.getvalue()


class CRIRuntimeClient:
    """containerd + cri-o share one client: both are CRI gRPC servers and
    both return the pid inside the verbose info JSON
    (containerd.go:73-101, crio.go:79-107)."""

    runtime = "containerd"

    def __init__(self, socket_path: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                 target: str | None = None):
        try:
            import grpc
        except ImportError as e:  # pragma: no cover - grpc is in the image
            raise CRIError("grpc package unavailable") from e
        self._grpc = grpc
        self._timeout = timeout_s
        self._channel = grpc.insecure_channel(target or f"unix:{socket_path}")

    def _container_status(self, bare_id: str) -> dict[str, str]:
        request = encode_container_status_request(bare_id)
        last_err: Exception | None = None
        code = None
        for api in ("runtime.v1", "runtime.v1alpha2"):
            call = self._channel.unary_unary(
                f"/{api}.RuntimeService/ContainerStatus",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            try:
                return decode_container_status_info(
                    call(request, timeout=self._timeout))
            except self._grpc.RpcError as e:
                last_err = e
                code = getattr(e, "code", lambda: None)()
                if code != self._grpc.StatusCode.UNIMPLEMENTED:
                    break  # real failure; don't mask it with the fallback
        if code in (self._grpc.StatusCode.UNAVAILABLE,
                    self._grpc.StatusCode.DEADLINE_EXCEEDED):
            raise CRITransportError(
                f"ContainerStatus({bare_id}): runtime unreachable: "
                f"{last_err}")
        raise CRIError(f"ContainerStatus({bare_id}) failed: {last_err}")

    def pid_from_container_id(self, container_id: str) -> int:
        runtime, bare = split_runtime_prefix(container_id)
        if runtime != self.runtime:
            raise CRIError(
                f"invalid CRI {container_id}, it should be {self.runtime}")
        info = self._container_status(bare)
        if "info" not in info:
            raise CRIError(
                f"container status for {bare} has no 'info' entry")
        try:
            pid = int(json.loads(info["info"]).get("pid") or 0)
        except (ValueError, AttributeError) as e:
            raise CRIError(f"could not parse container info JSON: {e}") from e
        if pid <= 0:
            raise CRIError(f"container {bare} reports no running pid")
        return pid

    def close(self) -> None:
        self._channel.close()


class ContainerdClient(CRIRuntimeClient):
    runtime = "containerd"

    def __init__(self, socket_path: str = CONTAINERD_SOCKET, **kw):
        super().__init__(socket_path, **kw)


class CrioClient(CRIRuntimeClient):
    runtime = "cri-o"

    def __init__(self, socket_path: str = CRIO_SOCKET, **kw):
        super().__init__(socket_path, **kw)


class CRIResolver:
    """Prefix-dispatching resolver over lazily-constructed per-runtime
    clients (the role of kubernetes.go's runtime switch). Client factories
    are injectable for tests; by default a runtime's client is built on
    first use from whichever well-known socket exists."""

    def __init__(self, factories: dict[str, "callable"] | None = None,
                 socket_probe: "callable" = None,
                 breaker_ttl_s: float = 30.0,
                 socket_path: str | None = None):
        import os

        probe = socket_probe or os.path.exists
        if factories is None:
            if socket_path:
                # The reference's
                # --metadata-container-runtime-socket-path: one
                # operator-chosen socket for whichever runtime answers
                # (kubernetes.go passes the same path to every runtime
                # client it constructs).
                factories = {
                    "docker": lambda: DockerClient(socket_path),
                    "containerd": lambda: ContainerdClient(socket_path),
                    "cri-o": lambda: CrioClient(socket_path),
                }
            else:
                factories = {
                    "docker": lambda: DockerClient(),
                    "containerd": lambda: ContainerdClient(
                        CONTAINERD_SOCKET if probe(CONTAINERD_SOCKET)
                        else CONTAINERD_K3S_SOCKET),
                    "cri-o": lambda: CrioClient(),
                }
        self._factories = factories
        self._clients: dict[str, object] = {}
        # Per-RUNTIME circuit breaker: one hung socket costs one dial
        # timeout per TTL, not one per unresolved container (the caller's
        # per-container negative cache cannot give that bound).
        self._breaker_ttl_s = breaker_ttl_s
        self._broken_until: dict[str, float] = {}

    def pid_from_container_id(self, container_id: str) -> int:
        import time

        runtime, _ = split_runtime_prefix(container_id)
        if runtime not in self._factories:
            raise CRIError(f"unsupported container runtime {runtime!r}")
        if self._broken_until.get(runtime, 0) > time.monotonic():
            raise CRITransportError(
                f"{runtime} runtime circuit open (recent transport "
                "failure); not redialing yet")
        client = self._clients.get(runtime)
        if client is None:
            client = self._clients[runtime] = self._factories[runtime]()
        try:
            return client.pid_from_container_id(container_id)
        except Exception as e:
            if isinstance(e, CRIError) and \
                    not isinstance(e, CRITransportError):
                raise  # routine lookup miss: keep the healthy channel
            # Transport-level failure. Self-heal: a cached client can be
            # pinned to a socket chosen before the runtime was up (e.g.
            # the containerd probe fell through to the k3s path during
            # node boot) — evict so the next resolution re-probes and
            # rebuilds — and open the circuit so a hung socket is only
            # redialed once per TTL.
            self._broken_until[runtime] = (
                time.monotonic() + self._breaker_ttl_s)
            self._clients.pop(runtime, None)
            try:
                client.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
            raise

    def close(self) -> None:
        for client in self._clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        self._clients.clear()
