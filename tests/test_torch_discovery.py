"""The port's discovery (discovery/) held to parca_agent_tpu's.

The cases of tests/test_discovery.py and tests/test_cri.py, each run
through both packages on the same inputs (the same FakeFS trees, fake
systemctl runners, pod lists, fake CRI clients and the same fake docker
engine and CRI gRPC server): the groups, the labels they give through
each package's labels manager, the CRI wire bytes and the resolved pids
must be equal. Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import socketserver
import threading
import time

import pytest
import torch

from parca_agent_tpu.discovery import cgroup as jax_cgroup
from parca_agent_tpu.discovery import cri as jax_cri
from parca_agent_tpu.discovery import kubernetes as jax_k8s
from parca_agent_tpu.discovery import manager as jax_manager
from parca_agent_tpu.discovery import systemd as jax_systemd
from parca_agent_tpu.labels.manager import LabelsManager as JaxLabels
from parca_agent_tpu.metadata.providers import (
    ServiceDiscoveryProvider as JaxSD,
)
from parca_agent_tpu.pprof.proto import iter_fields as jax_iter_fields
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS
from parca_agent_tpu_torch.discovery import cgroup as port_cgroup
from parca_agent_tpu_torch.discovery import cri as port_cri
from parca_agent_tpu_torch.discovery import kubernetes as port_k8s
from parca_agent_tpu_torch.discovery import manager as port_manager
from parca_agent_tpu_torch.discovery import systemd as port_systemd
from parca_agent_tpu_torch.labels.manager import LabelsManager as PortLabels
from parca_agent_tpu_torch.metadata.providers import (
    ServiceDiscoveryProvider as PortSD,
)
from parca_agent_tpu_torch.utils.vfs import FakeFS as PortFS

torch.set_num_threads(1)

CID = "a" * 64
CID2 = "b" * 64

PKGS = {
    "jax": dict(cgroup=jax_cgroup, cri=jax_cri, k8s=jax_k8s,
                manager=jax_manager, systemd=jax_systemd, fs=JaxFS,
                labels=JaxLabels, sd=JaxSD),
    "port": dict(cgroup=port_cgroup, cri=port_cri, k8s=port_k8s,
                 manager=port_manager, systemd=port_systemd, fs=PortFS,
                 labels=PortLabels, sd=PortSD),
}


def _plain(groups) -> list[dict]:
    return [dataclasses.asdict(g) for g in groups]


def both(fn):
    """fn(pkg dict) through both packages; the two results must be equal.
    Returns the port's."""
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


CGROUP_TEXTS = [
    f"0::/kubepods.slice/kubepods-pod12345678_1234_1234_1234_"
    f"123456789012.slice/cri-containerd-{CID}.scope\n",
    "0::/user.slice\n",
    f"12:memory:/docker/{CID2}\n0::/docker/{CID2}\n",
    f"0::/kubepods/pod12345678-1234-1234-1234-123456789012/{CID}\n",
    "garbage without a newline",
    "",
]


@pytest.mark.parametrize("text", CGROUP_TEXTS)
def test_parse_container_cgroup(text):
    both(lambda p: p["cgroup"].parse_container_cgroup(text))


def test_parse_container_cgroup_finds_the_ids():
    labels = port_cgroup.parse_container_cgroup(CGROUP_TEXTS[0])
    assert labels["containerid"] == CID
    assert labels["pod_uid"] == "12345678-1234-1234-1234-123456789012"


CGROUP_TREE = {
    "/proc/10/cgroup": f"0::/docker/{CID}\n".encode(),
    "/proc/11/cgroup": f"0::/docker/{CID}\n".encode(),
    "/proc/12/cgroup": f"0::/docker/{CID2}\n".encode(),
    "/proc/13/cgroup": b"0::/user.slice\n",
    "/proc/self/cgroup": b"ignored\n",
}


def test_cgroup_discoverer_groups_by_container():
    groups = both(lambda p: _plain(p["cgroup"].CgroupContainerDiscoverer(
        fs=p["fs"](dict(CGROUP_TREE))).scrape()))
    by_cid = {g["labels"]["containerid"]: g for g in groups}
    assert sorted(by_cid[CID]["pids"]) == [10, 11]
    assert by_cid[CID]["entry_pid"] == 10 and by_cid[CID2]["pids"] == [12]


def test_cgroup_discoverer_without_proc():
    assert both(lambda p: _plain(p["cgroup"].CgroupContainerDiscoverer(
        fs=p["fs"]({})).scrape())) == []


SYSTEMD_CASES = {
    "all units": ((), "nginx.service loaded active running\n"
                      "sshd.service loaded active running\n", "101\n\n0\n"),
    "named units": (("a.service", "b.service"), "", "7\n\nnot-a-pid\n"),
    "none running": ((), "", ""),
    "three": ((), "x.service l a r\ny.service l a r\nz.service l a r\n",
              "1\n\n2\n\n3\n"),
}


@pytest.mark.parametrize("case", sorted(SYSTEMD_CASES))
def test_systemd_discoverer_with_fake_runner(case):
    units, listing, show = SYSTEMD_CASES[case]

    def scrape(p):
        calls = []

        def runner(args):
            calls.append(list(args))
            return listing if args[0] == "list-units" else show

        groups = p["systemd"].SystemdDiscoverer(units=units,
                                                runner=runner).scrape()
        return calls, _plain(groups)

    calls, groups = both(scrape)
    if case == "all units":
        assert len(calls) == 2  # one list + one batched show
        assert groups == [{"source": "systemd/nginx.service",
                           "labels": {"systemd_unit": "nginx.service"},
                           "pids": [101], "entry_pid": 101}]


def _one_shot(manager_mod, groups_by_provider):
    class OneShot:
        def __init__(self, groups):
            self._groups = groups

        def run(self, stop, up):
            up(self._groups)

    mgr = manager_mod.DiscoveryManager(debounce_s=0.0)
    mgr.apply_config({name: OneShot([manager_mod.Group(**g) for g in gs])
                      for name, gs in groups_by_provider.items()})
    return mgr


def test_manager_merges_and_versions():
    def run(p):
        mgr = _one_shot(p["manager"], {
            "a": [dict(source="a/1", labels={"x": "1"}, pids=[1])],
            "b": [dict(source="b/1", labels={"y": "2"}, pids=[2])]})
        v0 = mgr.version
        mgr.run()
        assert mgr.wait_for_update(v0, timeout=5) > v0
        deadline = time.monotonic() + 5
        while len(mgr.groups()) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        mgr.stop()
        return sorted(map(str, _plain(mgr.groups())))

    assert len(both(run)) == 2


def test_manager_group_update_replaces_source():
    def run(p):
        mgr = p["manager"].DiscoveryManager(debounce_s=0.0)
        mgr._update("p", [p["manager"].Group(source="s", pids=[1])])
        mgr._update("p", [p["manager"].Group(source="s", pids=[1, 2])])
        mgr.flush()
        return _plain(mgr.groups())

    assert both(run)[0]["pids"] == [1, 2]


def test_manager_debounce_defers_publish():
    def run(p):
        mgr = p["manager"].DiscoveryManager(debounce_s=3600.0)
        mgr._update("p", [p["manager"].Group(source="s", pids=[1])])
        versions = [mgr.version]
        mgr._update("p", [p["manager"].Group(source="s", pids=[1, 2])])
        versions.append(mgr.version)
        mgr.flush()
        versions.append(mgr.version)
        return versions, _plain(mgr.groups())

    versions, groups = both(run)
    assert versions[0] == versions[1] == versions[2] - 1
    assert groups[0]["pids"] == [1, 2]


def test_failed_provider_counted():
    def run(p):
        class Boom:
            def run(self, stop, up):
                raise RuntimeError("x")

        mgr = p["manager"].DiscoveryManager()
        mgr.apply_config({"boom": Boom()})
        mgr.run()
        deadline = time.monotonic() + 5
        while mgr.failed_updates == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        mgr.stop()
        return mgr.failed_updates

    assert both(run) == 1


def test_restart_dead_spawn_failure_keeps_probe_unhealthy():
    def run(p):
        class Once:
            def run(self, stop, up):
                return

        mgr = p["manager"].DiscoveryManager()
        mgr.apply_config({"once": Once()})
        mgr.run()
        deadline = time.monotonic() + 5
        while mgr.alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        out = [mgr.alive()]

        def boom_spawn(name, prov):
            raise RuntimeError("no threads left")

        real_spawn, mgr._spawn = mgr._spawn, boom_spawn
        out += [mgr.restart_dead(), mgr.failed_updates, mgr.alive()]
        mgr._spawn = real_spawn
        out += [mgr.restart_dead(), len(mgr._threads)]
        mgr.stop()
        return out

    assert both(run) == [False, 0, 1, False, 1, 1]


def _labels_for(p, groups, pids):
    mgr = p["manager"].DiscoveryManager(debounce_s=0.0)
    mgr._update("cgroup", [p["manager"].Group(**g) for g in groups])
    mgr.flush()
    sd = p["sd"]()
    sd.update(mgr.groups())
    labels = p["labels"]([sd], [])
    return [labels.label_set("cpu", pid) for pid in pids]


def test_end_to_end_discovery_to_labels():
    got = both(lambda p: _labels_for(
        p, [dict(source=f"cgroup/{CID}", labels={"containerid": CID},
                 pids=[44])], [44, 45]))
    assert got[0]["containerid"] == CID and "containerid" not in got[1]


POD_LIST_DOC = {
    "items": [
        {
            "metadata": {"name": "web-abc", "namespace": "prod",
                         "uid": "12345678-1234-1234-1234-123456789012"},
            "spec": {"nodeName": "node-1"},
            "status": {"containerStatuses": [
                {"name": "app", "containerID": f"containerd://{CID}",
                 "state": {"running": {"startedAt": "2026-01-01T00:00:00Z"}}},
                {"name": "sidecar", "containerID": f"containerd://{CID2}",
                 "state": {"running": {}}},
            ]},
        },
        {"metadata": {"name": "pending", "namespace": "prod", "uid": "u2"},
         "spec": {"nodeName": "node-1"}, "status": {}},
    ]
}
# The official client's to_dict() shape (snake_case), a runtime prefix
# to strip and a container not started yet.
SNAKE_DOC = {"items": [
    {"metadata": {"name": "p", "namespace": "d", "uid": "u"},
     "spec": {"node_name": "n"},
     "status": {"container_statuses": [
         {"name": "c1", "container_id": f"docker://{CID}",
          "state": {"running": {}}},
         {"name": "c2", "container_id": "", "state": {"waiting": {}}}]}}]}

K8S_FS = {
    "/proc/10/cgroup": f"0::/kubepods/cri-containerd-{CID}.scope\n".encode(),
    "/proc/11/cgroup": f"0::/kubepods/cri-containerd-{CID}.scope\n".encode(),
    "/proc/20/cgroup": b"0::/user.slice\n",
}


def _pod_discoverer(p, cri=None, fs=None, pods=None):
    doc_pods = p["k8s"].parse_pod_list(POD_LIST_DOC)
    return p["k8s"].PodDiscoverer(
        node="node-1", lister=lambda node: pods or doc_pods,
        cgroups=p["cgroup"].CgroupContainerDiscoverer(
            fs=fs or p["fs"](dict(K8S_FS))), cri=cri)


@pytest.mark.parametrize("doc", [POD_LIST_DOC, SNAKE_DOC, {}, {"items": []}])
def test_parse_pod_list(doc):
    pods = both(lambda p: [dataclasses.asdict(x) for x in
                           p["k8s"].parse_pod_list(doc)])
    if doc is SNAKE_DOC:
        assert [c["container_id"] for c in pods[0]["containers"]] == [CID]


@pytest.mark.parametrize("raw", [f"containerd://{CID}", f"docker://{CID}",
                                 CID, "cri-o://x//y", ""])
def test_strip_runtime_prefix(raw):
    both(lambda p: p["k8s"].strip_runtime_prefix(raw))


def test_pod_discoverer_joins_api_to_local_pids():
    groups = both(lambda p: _plain(_pod_discoverer(p).scrape()))
    assert len(groups) == 1
    g = groups[0]
    assert g["source"] == "pod/prod/web-abc/app"
    assert g["labels"]["node"] == "node-1" and g["labels"]["pod"] == "web-abc"
    assert sorted(g["pids"]) == [10, 11] and g["entry_pid"] == 10


def test_pod_discoverer_end_to_end_labels():
    def run(p):
        mgr = p["manager"].DiscoveryManager(debounce_s=0.0)
        mgr._update("kubernetes", _pod_discoverer(p).scrape())
        mgr.flush()
        sd = p["sd"]()
        sd.update(mgr.groups())
        return p["labels"]([sd], []).label_set("cpu", 11)

    labels = both(run)
    assert labels["pod"] == "web-abc" and labels["container"] == "app"


def test_in_cluster_lister_url_and_auth(tmp_path):
    (tmp_path / "token").write_text("sekrit\n")

    def run(p):
        seen = {}

        def opener(url, headers):
            seen["url"], seen["headers"] = url, headers
            return json.dumps(POD_LIST_DOC).encode()

        lister = p["k8s"].InClusterPodLister(
            sa_dir=str(tmp_path),
            env={"KUBERNETES_SERVICE_HOST": "10.0.0.1",
                 "KUBERNETES_SERVICE_PORT": "443"},
            opener=opener)
        pods = lister("node-1")
        return seen, [dataclasses.asdict(x) for x in pods]

    seen, pods = both(run)
    assert seen["url"] == ("https://10.0.0.1:443/api/v1/pods"
                           "?fieldSelector=spec.nodeName%3Dnode-1")
    assert seen["headers"]["Authorization"] == "Bearer sekrit"
    assert pods[0]["name"] == "web-abc"


def test_in_cluster_lister_requires_cluster_env():
    for p in PKGS.values():
        with pytest.raises(RuntimeError, match="KUBERNETES_SERVICE_HOST"):
            p["k8s"].InClusterPodLister(env={})


def test_default_pod_lister_without_the_kubernetes_package(monkeypatch):
    """No `kubernetes` package (this host, the card host): both fall back
    to the stdlib in-cluster lister, which needs the cluster's env."""
    import builtins

    real_import = builtins.__import__

    def no_kubernetes(name, *a, **k):
        if name == "kubernetes" or name.startswith("kubernetes."):
            raise ImportError("no kubernetes here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_kubernetes)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for p in PKGS.values():
        with pytest.raises(RuntimeError, match="KUBERNETES_SERVICE_HOST"):
            p["k8s"].default_pod_lister()


# ---- CRI: the wire codec, the clients against fake runtimes, the resolver


@pytest.mark.parametrize("cid", ["deadbeef", CID, "", "é-unicode"])
def test_container_status_request_bytes(cid):
    req = both(lambda p: p["cri"].encode_container_status_request(cid))
    fields = {f: v for f, _w, v in jax_iter_fields(req)}
    assert fields.get(2) == 1  # verbose=true: the info JSON carries the pid


@pytest.mark.parametrize("info", [
    {"info": json.dumps({"pid": 4242}), "other": "x"},
    {}, {"": ""}, {"info": "not json"},
    {f"k{i}": "v" * i for i in range(20)}])
def test_container_status_response_roundtrip(info):
    wire = both(lambda p: p["cri"].encode_container_status_response(info))
    assert both(lambda p: p["cri"].decode_container_status_info(wire)) \
        == info


@pytest.mark.parametrize("cid", ["docker://abc", "cri-o://ff00",
                                 "containerd://x://y", "abc123",
                                 "containerd://"])
def test_split_runtime_prefix(cid):
    def run(p):
        try:
            return p["cri"].split_runtime_prefix(cid)
        except p["cri"].CRIError as e:
            return ("error", str(e))

    both(run)


@pytest.fixture
def docker_sock(tmp_path):
    """Fake docker engine: ContainerInspect over a unix socket."""
    path = str(tmp_path / "docker.sock")
    containers = {"aaa111": 1234, "stopped": 0}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            cid = self.path.split("/")[2]
            if cid not in containers:
                self.send_response(404)
                self.end_headers()
                self.wfile.write(b'{"message":"no such container"}')
                return
            body = json.dumps(
                {"Id": cid, "State": {"Pid": containers[cid],
                                      "Running": True}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = socketserver.UnixStreamServer(path, Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield path
    srv.shutdown()
    srv.server_close()


def _outcome(p, fn):
    try:
        return fn()
    except p["cri"].CRITransportError as e:
        return ("transport", type(e).__name__)
    except p["cri"].CRIError as e:
        return ("error", str(e)[:40])


@pytest.mark.parametrize("cid", ["docker://aaa111", "docker://missing",
                                 "docker://stopped", "containerd://aaa111"])
def test_docker_client_resolves_pid(docker_sock, cid):
    got = both(lambda p: _outcome(p, lambda: p["cri"].DockerClient(
        socket_path=docker_sock).pid_from_container_id(cid)))
    assert (got == 1234) == (cid == "docker://aaa111")


@pytest.fixture
def cri_server():
    """Fake CRI RuntimeService (a real grpc server, hand-encoded replies)
    serving runtime.v1 or, for cri-o, only runtime.v1alpha2."""
    grpc = pytest.importorskip("grpc")
    from concurrent.futures import ThreadPoolExecutor

    containers = {"bbb222": 4321, "whatever": 77}
    servers = []

    def container_status(request: bytes, context) -> bytes:
        fields = {f: v for f, _w, v in jax_iter_fields(request)}
        cid = fields[1].decode()
        if cid not in containers:
            context.abort(grpc.StatusCode.NOT_FOUND, "no such container")
        return jax_cri.encode_container_status_response(
            {"info": json.dumps({"pid": containers[cid]})})

    def start(api):
        server = grpc.server(ThreadPoolExecutor(max_workers=2))
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                f"{api}.RuntimeService",
                {"ContainerStatus": grpc.unary_unary_rpc_method_handler(
                    container_status,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)}),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        servers.append(server)
        return f"127.0.0.1:{port}"

    yield start
    for s in servers:
        s.stop(None)


@pytest.mark.parametrize("cid", ["containerd://bbb222", "containerd://nope",
                                 "docker://bbb222"])
def test_containerd_client_resolves_pid(cri_server, cid):
    target = cri_server("runtime.v1")

    def run(p):
        c = p["cri"].ContainerdClient(socket_path="/nonexistent",
                                      target=target)
        try:
            return _outcome(p, lambda: c.pid_from_container_id(cid))
        finally:
            c.close()

    assert (both(run) == 4321) == (cid == "containerd://bbb222")


def test_crio_client_falls_back_to_v1alpha2(cri_server):
    target = cri_server("runtime.v1alpha2")

    def run(p):
        c = p["cri"].CrioClient(socket_path="/nonexistent", target=target)
        try:
            return c.pid_from_container_id("cri-o://whatever")
        finally:
            c.close()

    assert both(run) == 77


def test_resolver_dispatches_by_prefix(docker_sock):
    def run(p):
        calls = []

        class Fake:
            def pid_from_container_id(self, cid):
                calls.append(cid)
                return 7

            def close(self):
                calls.append("closed")

        r = p["cri"].CRIResolver(factories={
            "docker": lambda: p["cri"].DockerClient(socket_path=docker_sock),
            "containerd": Fake})
        out = [r.pid_from_container_id("docker://aaa111"),
               r.pid_from_container_id("containerd://x"),
               r.pid_from_container_id("containerd://y"),
               _outcome(p, lambda: r.pid_from_container_id("cri-o://z"))]
        r.close()
        return out, calls

    out, calls = both(run)
    assert out[:3] == [1234, 7, 7]
    assert calls == ["containerd://x", "containerd://y", "closed"]


def test_resolver_keeps_channel_on_lookup_miss(docker_sock):
    def run(p):
        built = []

        def factory():
            built.append(1)
            return p["cri"].DockerClient(socket_path=docker_sock)

        r = p["cri"].CRIResolver(factories={"docker": factory})
        out = [_outcome(p, lambda c=c: r.pid_from_container_id(c))
               for c in ("docker://aaa111", "docker://missing",
                         "docker://aaa111")]
        return out, len(built)

    out, built = both(run)
    assert out[0] == out[2] == 1234 and built == 1


def test_resolver_circuit_breaker_on_transport_failure(tmp_path):
    def run(p):
        built = []

        def factory():
            built.append(1)
            return p["cri"].DockerClient(
                socket_path=str(tmp_path / "absent.sock"))

        r = p["cri"].CRIResolver(factories={"docker": factory},
                                 breaker_ttl_s=30.0)
        out = [_outcome(p, lambda: r.pid_from_container_id("docker://a")),
               _outcome(p, lambda: r.pid_from_container_id("docker://b")),
               len(built)]
        r._broken_until.clear()  # TTL expiry
        out += [_outcome(p, lambda: r.pid_from_container_id("docker://a")),
                len(built)]
        return out

    assert both(run) == [("transport", "CRITransportError")] * 2 + [1] \
        + [("transport", "CRITransportError"), 2]


def test_resolver_socket_path_override_pins_every_runtime():
    def run(p):
        r = p["cri"].CRIResolver(socket_path="/custom/runtime.sock")
        return r._factories["docker"]()._path

    assert both(run) == "/custom/runtime.sock"


def _fallback(p, cri):
    seen_cid, racing_cid = "a" * 64, "b" * 64
    fs = p["fs"]({"/proc/10/cgroup": f"0::/kubepods/podx/{seen_cid}\n"
                  .encode(), "/proc/10/comm": b"seen\n"})
    pods = [p["k8s"].PodInfo(
        name="p", namespace="ns", uid="u", node="n",
        containers=(
            p["k8s"].ContainerInfo(name="seen", container_id=seen_cid,
                                   raw_id=f"containerd://{seen_cid}"),
            p["k8s"].ContainerInfo(name="racing", container_id=racing_cid,
                                   raw_id=f"containerd://{racing_cid}")))]
    d = p["k8s"].PodDiscoverer(
        node="n", lister=lambda node: pods,
        cgroups=p["cgroup"].CgroupContainerDiscoverer(fs=fs), cri=cri)
    return d, fs, racing_cid


def test_pod_discoverer_cri_fallback_adopts_validated_pid():
    def run(p):
        asked = []
        holder = {}

        class FakeCRI:
            def pid_from_container_id(self, cid):
                asked.append(cid)
                d, fs, racing_cid = holder["f"]
                fs.put("/proc/555/cgroup",
                       f"0::/kubepods/podx/{racing_cid}\n".encode())
                return 555

        holder["f"] = _fallback(p, FakeCRI())
        return _plain(holder["f"][0].scrape()), asked

    groups, asked = both(run)
    assert {g["labels"]["container"]: g["pids"] for g in groups} == \
        {"seen": [10], "racing": [555]}
    assert asked == ["containerd://" + "b" * 64]


def test_pod_discoverer_cri_fallback_rejects_foreign_pid():
    class FakeCRI:
        def pid_from_container_id(self, cid):
            return 10  # exists, but belongs to the other container

    groups = both(lambda p: _plain(_fallback(p, FakeCRI())[0].scrape()))
    assert [g["labels"]["container"] for g in groups] == ["seen"]


def test_pod_discoverer_cri_negative_cache():
    def run(p):
        calls = []

        class FailingCRI:
            def pid_from_container_id(self, cid):
                calls.append(cid)
                raise OSError("socket down")

        d = _fallback(p, FailingCRI())[0]
        d.scrape()
        d.scrape()
        n = [len(calls)]
        d._cri_failed_until.clear()
        d.scrape()
        return n + [len(calls)]

    assert both(run) == [1, 2]
