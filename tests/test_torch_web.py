"""The port's HTTP surface (web.py) held to parca_agent_tpu's.

The cases of tests/test_metrics_format.py and the web cases of
tests/test_shell.py. Both packages' `render_metrics` render the same
component states (a loop that ran the same window, batch clients that
took the same writes, fresh supervisors and registries, flight recorders
and device telemetry fed the same observations, identity trackers that
saw the same pids): the output passes the strict text-format parser of
tests/test_metrics_format.py, and every family both render has the same
`# TYPE` line and the same sample lines, apart from the loop's timing
gauges. The family sets differ only by the device-state divergence
(ROADMAP.md C). The query helpers, the label escaping, the status page
and /healthz without a supervisor are equal byte for byte; the routes
answer with the original's codes.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from parca_agent_tpu import web as jax_web  # noqa: E402
from parca_agent_tpu_torch import web as port_web  # noqa: E402
from test_metrics_format import (  # noqa: E402
    _parse_labels,
    parse_prometheus_text,
)

# The device-state divergence: the port's registry has no degraded
# state (no CPU fallback to demote to), so no cooldown, shadow, trips,
# fallback windows or demotion/promotion series.
DEVICE_ONLY_JAX = {
    "parca_agent_device_cooldown_windows",
    "parca_agent_device_shadow_pending",
    "parca_agent_device_trips",
    "parca_agent_device_demotions_total",
    "parca_agent_device_promotions_total",
    "parca_agent_device_fallback_windows_total",
    "parca_agent_device_shadow_windows_total",
    "parca_agent_device_shadow_mismatches_total",
}
# Last-value timing gauges of the loop: the same family, another clock.
TIMING = {
    "parca_agent_profiler_attempt_duration_seconds",
    "parca_agent_profiler_aggregate_duration_seconds",
    "parca_agent_profiler_symbolize_duration_seconds",
    "parca_agent_profiler_encode_duration_seconds",
}


class _Collect:
    def write(self, labels, blob):
        pass


class _Once:
    def __init__(self, snap):
        self._snap = snap

    def poll(self):
        snap, self._snap = self._snap, None
        return snap


def _components(tmp_path, which: str) -> dict:
    """render_metrics' keyword arguments in one package, each component
    in the same state as the other package's."""
    import importlib

    root = "parca_agent_tpu" if which == "jax" else "parca_agent_tpu_torch"

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    synth = mod("capture.synthetic")
    snap = synth.generate(synth.SyntheticSpec(
        n_pids=4, n_unique_stacks=64, n_rows=64, total_samples=256,
        mean_depth=6, seed=7))
    if which == "jax":
        prof = mod("profiler.cpu").CPUProfiler(
            source=_Once(snap), aggregator=mod("aggregator.cpu")
            .CPUAggregator(), profile_writer=_Collect(), duration_s=0.0)
    else:
        prof = mod("profiler.cpu").AggregateLoop(
            _Once(snap), mod("aggregator.cpu").CPUAggregator(),
            profile_writer=_Collect(), duration_s=0.0)
    prof.run_iteration()
    batch = mod("agent.batch").BatchWriteClient(
        mod("agent.batch").NoopStoreClient(),
        spool=mod("agent.spool").SpoolDir(str(tmp_path / which / "spool")))
    batch.write_raw({"__name__": "x"}, b"blob")
    batch.flush()
    rec = mod("runtime.trace").FlightRecorder()
    for stage in ("drain", "close", "prepare", "encode", "ship",
                  "batch_flush", "store_ack", "statics"):
        for i in range(5):
            rec.observe(stage, 0.001 * (i + 1))
    tr = rec.begin()
    tr.add_span("close", 0.01)
    tr.complete()
    tel = mod("runtime.device_telemetry").DeviceTelemetry(period_s=1.0)
    tel.record("feed_probe", 0.002, shape=(8,))
    tel.record("feed_probe", 0.001, shape=(8,))
    tel.record("close_pack", 0.003, shape=(4,))
    tel.record_transfer("feed_probe", "h2d", 4096)
    tel.tick_window(0.5)
    ident = mod("process.identity").ProcessIdentityTracker(
        starttime_of=lambda pid: 7)
    ident.observe_window([1, 2, 3])
    health = mod("runtime.device_health")
    return dict(
        profilers=[prof], batch_client=batch,
        supervisor=mod("runtime.supervisor").Supervisor(),
        quarantine=mod("runtime.quarantine").QuarantineRegistry(),
        device_health=health.DeviceHealthRegistry(probe=None),
        statics_store=mod("pprof.statics_store").StaticsStore(
            str(tmp_path / which / "statics.snap")),
        recorder=rec, identity=ident, device_telemetry=tel)


def _families(text: str) -> dict:
    """{family: (type, sorted samples)}, without the recorder's "total"
    stage (a wall-clock span of the trace)."""
    fams = parse_prometheus_text(text)
    return {name: (f["type"], sorted(
        (s[0], tuple(sorted(s[1].items())), s[2]) for s in f["samples"]
        if s[1].get("stage") != "total"))
        for name, f in fams.items()}


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("rendered")
    out = {}
    for which, web in (("jax", jax_web), ("port", port_web)):
        kw = _components(tmp_path, which)
        out[which] = web.render_metrics(
            kw.pop("profilers"), kw.pop("batch_client"),
            {"parca_agent_capture_lost_samples_total": 3,
             'parca_agent_build_info{version="dev",python="3.x"}': 1},
            **kw)
    return out


def test_render_metrics_is_strict_prometheus(rendered):
    fams = parse_prometheus_text(rendered["port"])
    assert fams["parca_agent_profiler_attempts_total"]["type"] == "counter"
    hist = fams["parca_agent_window_stage_duration_seconds"]
    assert hist["type"] == "histogram"
    assert {"drain", "close", "prepare", "encode", "ship", "batch_flush"} \
        <= {lab["stage"] for _, lab, _ in hist["samples"]}
    assert fams["parca_agent_build_info"]["samples"][0][1]["version"] == "dev"
    assert fams["parca_agent_kernel_duration_seconds"]["type"] == "histogram"


def test_render_metrics_families_equal_the_originals(rendered):
    jax_f, port_f = (_families(rendered[k]) for k in ("jax", "port"))
    assert set(jax_f) - set(port_f) == DEVICE_ONLY_JAX
    assert set(port_f) <= set(jax_f)
    for name in set(port_f) - TIMING - {"parca_agent_device_state",
                                        "parca_agent_device_info"}:
        assert port_f[name] == jax_f[name], name
    for name in TIMING:
        assert port_f[name][0] == jax_f[name][0]


def test_device_state_is_one_hot_over_the_ports_states(rendered):
    from parca_agent_tpu_torch.runtime.device_health import STATES

    samples = parse_prometheus_text(
        rendered["port"])["parca_agent_device_state"]["samples"]
    assert [lab["state"] for _, lab, _ in samples] == list(STATES)
    assert sum(v for _, _, v in samples) == 1
    assert dict((lab["state"], v) for _, lab, v in samples)["healthy"] == 1


@pytest.mark.parametrize("value", ['a"b\\c\nd', "plain", "", "\n\n",
                                   "x\\", 'é"'])
def test_escape_label_value(value):
    esc = port_web.escape_label_value(value)
    assert esc == jax_web.escape_label_value(value)
    assert _parse_labels(f'k="{esc}"') == {"k": value}


@pytest.mark.parametrize("value", [True, False, 0, 7, 0.1, 1e-12, 2.5e10,
                                   float("inf"), 3])
def test_fmt_value(value):
    assert port_web._fmt_value(value) == jax_web._fmt_value(value)


def test_render_metrics_escapes_hostile_label_values():
    from parca_agent_tpu_torch.profiler.cpu import ProfilerMetrics

    class Hostile:
        name = 'evil"profiler\\with\nnewline'
        metrics = ProfilerMetrics()

    fams = parse_prometheus_text(port_web.render_metrics([Hostile()]))
    assert fams["parca_agent_profiler_attempts_total"]["samples"][0][1][
        "profiler"] == Hostile.name


HELPER_CASES = [
    ("pop_timeout", {"timeout": "5"}), ("pop_timeout", {"timeout": "600"}),
    ("pop_timeout", {"timeout": "-1"}), ("pop_timeout", {"timeout": "inf"}),
    ("pop_timeout", {"timeout": "nan"}), ("pop_timeout", {}),
    ("pop_tenant", {"tenant": "pod:abc"}), ("pop_tenant", {"tenant": ""}),
    ("pop_tenant", {"tenant": "bad tenant"}), ("pop_tenant", {}),
    ("pop_k_scope", {"k": "3", "scope": "fleet"}),
    ("pop_k_scope", {"k": "0"}), ("pop_k_scope", {"scope": "moon"}),
    ("pop_time_range", {"t0": "1", "t1": "2"}),
    ("pop_time_range", {"t0": "inf"}), ("pop_time_range", {"range": "-3"}),
]


@pytest.mark.parametrize("name,params", HELPER_CASES)
def test_query_helpers(name, params):
    def run(web):
        p = dict(params)
        try:
            return getattr(web, name)(p), p
        except ValueError as e:
            return "ValueError", str(e)

    assert run(port_web) == run(jax_web)


@pytest.mark.parametrize("path", ["/", "/v1", "/sys/fs/cgroup/system.slice",
                                  "/kubepods/pod12345678_1234_1234_1234_"
                                  "123456789012/x", "/docker/" + "a" * 64,
                                  "/user.slice/user-1000.slice/s.scope",
                                  "/system.slice/nginx.service", None,
                                  "/weird path/\x00"])
def test_tenant_from_cgroup(path):
    from parca_agent_tpu.runtime import admission as jax_adm
    from parca_agent_tpu_torch.runtime import admission as port_adm

    assert port_adm.tenant_from_cgroup(path) == \
        jax_adm.tenant_from_cgroup(path)


class _FakeLoop:
    """The attributes render_status_page reads."""

    name = "cpu"

    def __init__(self, metrics, errors, last_error=None):
        self.metrics = metrics
        self.process_last_errors = errors
        self.last_error = last_error


@pytest.mark.parametrize("last_error", [None, RuntimeError("x<y>")])
def test_status_page_equal(last_error):
    from parca_agent_tpu.profiler.cpu import ProfilerMetrics as JaxMetrics
    from parca_agent_tpu_torch.profiler.cpu import ProfilerMetrics

    errors = {12: None, 13: RuntimeError("unwind failed & <tag>")}
    info = {"source": "replay", "lost": 3}
    page = port_web.render_status_page(
        [_FakeLoop(ProfilerMetrics(attempts_total=2, samples_aggregated=9),
                   errors, last_error)], "0.1.0", info)
    assert page == jax_web.render_status_page(
        [_FakeLoop(JaxMetrics(attempts_total=2, samples_aggregated=9),
                   errors, last_error)], "0.1.0", info)
    assert "unwind failed" in page and "/query?pid=12" in page


def _get(base, path, timeout=10):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """One server of each package over the same component states."""
    tmp_path = tmp_path_factory.mktemp("servers")
    out = {}
    for which, web in (("jax", jax_web), ("port", port_web)):
        kw = _components(tmp_path, which)
        from parca_agent_tpu_torch.agent.listener import (
            MatchingProfileListener,
        )

        srv = web.AgentHTTPServer(port=0, listener=MatchingProfileListener(),
                                  version="v-test", **kw)
        srv.start()
        out[which] = (srv, f"http://127.0.0.1:{srv.port}")
    yield out
    for srv, _ in out.values():
        srv.stop()


@pytest.mark.parametrize("path", [
    "/healthy", "/nope", "/debug/trace/abc", "/debug/trace/999999",
    "/debug/windows?limit=-1", "/debug/windows?limit=x",
    "/debug/device?limit=-2", "/query?timeout=-1", "/query?tenant=a%20b",
    "/debug/pprof/", "/hotspots?k=3", "/diff"])
def test_route_codes_and_bodies_equal(servers, path):
    got = {k: _get(base, path)[:2] for k, (_, base) in servers.items()}
    assert got["port"] == got["jax"]


def test_healthz_with_a_supervisor(servers):
    code, body, _ = _get(servers["port"][1], "/healthz")
    doc = json.loads(body)
    assert code == 200 and doc["status"] == "healthy"
    assert {"quarantine", "device", "statics", "process_identity"} <= set(doc)
    jcode, jbody, _ = _get(servers["jax"][1], "/healthz")
    assert set(json.loads(jbody)) - set(doc) == set()


def test_metrics_and_debug_routes(servers):
    base = servers["port"][1]
    code, body, _ = _get(base, "/metrics")
    assert code == 200
    parse_prometheus_text(body.decode())
    code, body, _ = _get(base, "/debug/windows")
    doc = json.loads(body)
    assert code == 200 and doc["traces"][-1]["complete"]
    seq = doc["traces"][-1]["seq"]
    code, body, _ = _get(base, f"/debug/trace/{seq}")
    assert code == 200 and json.loads(body)["seq"] == seq
    code, body, _ = _get(base, "/debug/device?limit=2")
    assert code == 200 and "timeline" in json.loads(body)
    code, body, _ = _get(base, "/")
    assert code == 200 and b"v-test" in body and b"attempts: 1" in body


def test_query_returns_the_next_matching_profile(servers):
    srv, base = servers["port"]
    got = {}

    def fetch():
        got["r"] = _get(base, "/query?pid=9&timeout=5")

    t = threading.Thread(target=fetch)
    t.start()
    time.sleep(0.2)
    srv.listener.write_raw({"pid": "8"}, b"other")
    srv.listener.write_raw({"pid": "9"}, b"sample-bytes")
    t.join(timeout=10)
    code, body, headers = got["r"]
    assert code == 200 and body == b"sample-bytes"
    assert json.loads(headers["X-Profile-Labels"])["labels"]["pid"] == "9"
    assert _get(base, "/query?pid=9&timeout=0.1")[0] == 404


@pytest.fixture(scope="module")
def bare():
    """A server of each package with no component."""
    srvs = {which: web.AgentHTTPServer(port=0)
            for which, web in (("jax", jax_web), ("port", port_web))}
    for srv in srvs.values():
        srv.start()
    yield {k: f"http://127.0.0.1:{srv.port}" for k, srv in srvs.items()}
    for srv in srvs.values():
        srv.stop()


@pytest.mark.parametrize("path,code", [
    ("/debug/windows", 503), ("/debug/trace/1", 503),
    ("/debug/device", 503), ("/query?pid=1", 503), ("/healthz", 200),
    ("/metrics", 200), ("/", 200)])
def test_routes_without_components(bare, path, code):
    out = {k: _get(base, path)[:2] for k, base in bare.items()}
    assert out["port"][0] == code
    if path == "/":
        assert out["port"][1].replace(b"dev", b"") == \
            out["jax"][1].replace(b"dev", b"")
    else:
        assert out["port"] == out["jax"]


def test_stop_without_start_and_port_zero():
    srv = port_web.AgentHTTPServer(port=0)
    assert srv.port > 0
    srv.stop()
