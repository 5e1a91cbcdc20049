"""The port's agent shell held to parca_agent_tpu's: logging
(utils/log.py), build info (buildinfo.py), the environment checks
(kconfig.py), the CLI's flags, and the CLI's HTTP surface, discovery and
optional recorders end to end.

The kconfig, buildinfo, flag and status-page cases of tests/test_shell.py
and the cases of tests/test_log.py, each run through both packages on the
same inputs: logfmt lines are equal apart from the timestamp (and, on
the root logger's lines, the root's name), kernel configs, container verdicts
and build info are equal, and the A14 flags have the original's names,
defaults and choices. The CLIs run in this process on the CPU; a capture
source of the test's scrapes the running server between windows.
"""

from __future__ import annotations

import gzip
import io
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from parca_agent_tpu import buildinfo as jax_bi  # noqa: E402
from parca_agent_tpu import cli as jax_cli  # noqa: E402
from parca_agent_tpu import kconfig as jax_kconfig  # noqa: E402
from parca_agent_tpu.utils import log as jax_log  # noqa: E402
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS  # noqa: E402
from parca_agent_tpu_torch import buildinfo as port_bi  # noqa: E402
from parca_agent_tpu_torch import cli  # noqa: E402
from parca_agent_tpu_torch import kconfig as port_kconfig  # noqa: E402
from parca_agent_tpu_torch.utils import log as port_log  # noqa: E402
from parca_agent_tpu_torch.utils.vfs import FakeFS as PortFS  # noqa: E402
from test_metrics_format import parse_prometheus_text  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CID = "c" * 64


@pytest.fixture(autouse=True)
def _clean_logging():
    yield
    port_log.reset_logging()
    root = logging.getLogger("parca_agent_tpu")
    for h in list(root.handlers):
        root.removeHandler(h)
    root.propagate = True
    root.setLevel(logging.NOTSET)


# -- logging -------------------------------------------------------------------


def _lines(level: str, emit) -> dict[str, list[str]]:
    """emit(get_logger) through both packages' loggers from the same
    line; the logfmt lines each wrote, timestamps dropped."""
    out = {}
    for name, mod in (("jax", jax_log), ("port", port_log)):
        buf = io.StringIO()
        mod.setup_logging(level, stream=buf)
        emit(mod.get_logger)
        out[name] = [ln.split(" ", 1)[1].replace(
            f"component={mod._ROOT} ", "component=ROOT ")
            for ln in buf.getvalue().splitlines()]
    return out


LOG_CASES = {
    "plain": lambda g: g("x").info("window closed", pids=412, samples=9),
    "quoting": lambda g: g("profiler").info('say "hi"', count=3,
                                            path="/a b/c"),
    "empty values": lambda g: g("").warn("", k="", eq="a=b"),
    "backslashes": lambda g: g("cli").error('c:\\tmp "x"', v="\\"),
    "every level": lambda g: [getattr(g("lvl"), m)(m, n=i) for i, m in
                              enumerate(("debug", "info", "warn", "error"))],
    "exception": lambda g: g("x").error("failed", exc=ValueError("boom")),
}


@pytest.mark.parametrize("case", sorted(LOG_CASES))
@pytest.mark.parametrize("level", ["debug", "warn"])
def test_logfmt_lines_equal(case, level):
    got = _lines(level, LOG_CASES[case])
    assert got["port"] == got["jax"]
    assert all("caller=test_torch_shell.py:" in ln for ln in got["port"])


def test_logfmt_shape_and_filtering():
    got = _lines("warn", LOG_CASES["every level"])["port"]
    assert [ln.split()[0] for ln in got] == ["level=warn", "level=error"]
    got = _lines("debug", LOG_CASES["quoting"])["port"]
    assert 'msg="say \\"hi\\""' in got[0] and 'path="/a b/c"' in got[0]
    assert "component=profiler" in got[0]


def test_unknown_level_rejected():
    for mod in (jax_log, port_log):
        with pytest.raises(ValueError, match="unknown log level"):
            mod.setup_logging("verbose")
    assert port_log.LEVELS == jax_log.LEVELS


def test_reset_logging_gives_the_root_back():
    port_log.setup_logging("debug", stream=io.StringIO())
    root = logging.getLogger("parca_agent_tpu_torch")
    assert root.handlers and not root.propagate
    port_log.reset_logging()
    assert not root.handlers and root.propagate
    assert root.level == logging.NOTSET


# -- kconfig, buildinfo --------------------------------------------------------

_CFG = "CONFIG_PERF_EVENTS=y\nCONFIG_BPF=y\n# CONFIG_BPF_JIT is not set\n"
KCONFIG_TREES = {
    "boot config": {"/proc/sys/kernel/osrelease": b"6.6-test\n",
                    "/boot/config-6.6-test": _CFG.encode()},
    "config.gz off": {"/proc/config.gz":
                      gzip.compress(b"CONFIG_PERF_EVENTS=n\n")},
    "config.gz all": {"/proc/config.gz": gzip.compress(
        b"CONFIG_PERF_EVENTS=m\nCONFIG_BPF=y\nCONFIG_BPF_SYSCALL=y\n"
        b"CONFIG_HAVE_EBPF_JIT=y\nCONFIG_BPF_JIT=y\nCONFIG_BPF_EVENTS=y\n")},
    "none": {},
    "no boot file": {"/proc/sys/kernel/osrelease": b"6.6-x\n"},
}


@pytest.mark.parametrize("tree", sorted(KCONFIG_TREES))
def test_kconfig_check_equal(tree):
    files = KCONFIG_TREES[tree]
    got = port_kconfig.check_profiling_enabled(PortFS(dict(files)))
    assert got == jax_kconfig.check_profiling_enabled(JaxFS(dict(files)))
    assert port_kconfig.read_kernel_config(PortFS(dict(files))) == \
        jax_kconfig.read_kernel_config(JaxFS(dict(files)))


@pytest.mark.parametrize("text", [_CFG, "", "# only\n\n", "A=1=2\nB\n"])
def test_parse_kernel_config_equal(text):
    assert port_kconfig.parse_kernel_config(text) == \
        jax_kconfig.parse_kernel_config(text)


CONTAINER_TREES = {
    "dockerenv": {"/.dockerenv": b""},
    "containerenv": {"/run/.containerenv": b""},
    "pod cgroup": {"/proc/1/cgroup": b"0::/kubepods/pod1/abc\n"},
    "root cgroup": {"/proc/1/cgroup": b"0::/\n"},
    "init scope": {"/proc/1/cgroup": b"1:name=systemd:/init.scope\n"},
    "nothing": {},
}


@pytest.mark.parametrize("tree", sorted(CONTAINER_TREES))
def test_is_in_container_equal(tree):
    files = CONTAINER_TREES[tree]
    got = port_kconfig.is_in_container(PortFS(dict(files)))
    assert got == jax_kconfig.is_in_container(JaxFS(dict(files)))
    assert got == (tree in ("dockerenv", "containerenv", "pod cgroup"))


@pytest.mark.parametrize("fields", [
    dict(version="0.1.0"),
    dict(version="0.1.0", vcs_revision="f" * 40, vcs_time="t",
         vcs_modified=True, python="3.12.0"),
    dict(version="1", vcs_revision="abc", vcs_modified=False)])
def test_buildinfo_display_and_metrics_equal(fields):
    port, jax = port_bi.BuildInfo(**fields), jax_bi.BuildInfo(**fields)
    assert port.display() == jax.display()
    assert port.as_metrics() == jax.as_metrics()


def test_buildinfo_collects_and_never_raises(monkeypatch):
    for mod in (port_bi, jax_bi):
        mod.collect.cache_clear()
    try:
        info = port_bi.collect()
        assert info.version and info.display().startswith(info.version)
        assert (info.vcs_revision, info.python) == \
            (jax_bi.collect().vcs_revision, jax_bi.collect().python)
        for mod in (port_bi, jax_bi):
            mod.collect.cache_clear()
        monkeypatch.setenv("PARCA_AGENT_VCS_REVISION", "f" * 40)
        stamped = port_bi.collect()
        assert stamped.vcs_revision == "f" * 40
        assert "ffffffffffff" in stamped.display()
        assert stamped.as_metrics()["revision"] == "f" * 40
    finally:
        for mod in (port_bi, jax_bi):
            mod.collect.cache_clear()


# -- flags ---------------------------------------------------------------------

A14_FLAGS = ["--http-address", "--log-level", "--version",
             "--enable-cgroup-discovery", "--enable-kubernetes-discovery",
             "--enable-systemd-discovery", "--systemd-units",
             "--metadata-container-runtime-socket-path",
             "--no-window-trace", "--no-device-telemetry"]


def _action(parser, flag):
    return next(a for a in parser._actions if flag in a.option_strings)


@pytest.mark.parametrize("flag", A14_FLAGS)
def test_a14_flag_matches_the_original(flag):
    port, jax = (_action(m.build_parser(), flag) for m in (cli, jax_cli))
    assert (type(port), port.dest, port.default, port.choices, port.nargs) \
        == (type(jax), jax.dest, jax.default, jax.choices, jax.nargs)


A15_FLAGS = [
    "--tenant-quota-samples", "--tenant-quota-pids", "--tenant-burst-windows",
    "--tenant-top-n", "--overload-close-latency", "--overload-registry-rows",
    "--overload-backlog", "--overload-shed-after", "--overload-recover-after",
    "--fork-storm-new-pids", "--hotspots", "--hotspot-top-k",
    "--hotspot-candidates", "--hotspot-cm-depth", "--hotspot-cm-width",
    "--hotspot-rollup-intervals", "--hotspot-level-bytes",
    "--hotspot-stale-after", "--regression", "--regression-interval",
    "--regression-baseline-windows", "--regression-path",
    "--regression-sigma", "--regression-min-count", "--regression-min-ratio",
    "--regression-drift-threshold", "--regression-max-groups",
    "--regression-max-keys", "--alerts-path", "--sink", "--autofdo-dir",
    "--autofdo-flush-windows", "--autofdo-max-binaries",
    "--autofdo-max-offsets", "--series-max-sets"]


@pytest.mark.parametrize("flag", A15_FLAGS)
def test_a15_flag_matches_the_original(flag):
    port, jax = (_action(m.build_parser(), flag) for m in (cli, jax_cli))
    assert (type(port), port.dest, port.default, port.choices, port.nargs,
            port.type, port.help) == \
        (type(jax), jax.dest, jax.default, jax.choices, jax.nargs, jax.type,
         jax.help)


def test_the_cli_has_71_flags():
    """The CLI's flag count: 71 before the analytics, whose 35 flags
    (admission, hotspots, the regression sentinel, the sinks) make 106.
    The one flag of the JAX CLI the port lacks is
    --device-promote-after (no CPU fallback to promote from)."""
    flags = [a for a in cli.build_parser()._actions
             if a.option_strings and a.dest != "help"]
    assert len(flags) == 106
    jax = {o for a in jax_cli.build_parser()._actions
           if a.dest != "help" for o in a.option_strings}
    port = {o for a in flags for o in a.option_strings}
    assert jax - port == {"--device-promote-after"}


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as ei:
        cli.build_parser().parse_args(["--version"])
    assert ei.value.code == 0
    assert capsys.readouterr().out.strip() == "parca-agent-tpu-torch 0.1.0"


def test_log_level_flag_controls_output():
    args = cli.build_parser().parse_args(["--log-level", "debug"])
    assert args.log_level == "debug"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--log-level", "verbose"])


# -- the CLI end to end, in this process --------------------------------------


def _get(base, path, timeout=10):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _trace_seq(base, timeout=30.0):
    """The seq of window 1's trace once /debug/windows lists it complete
    (a detached trace completes on the encode worker after its ship), as
    tests/test_metrics_format.py reads it; 1 when tracing is off (the
    route then answers 503 whatever the seq)."""
    deadline = time.monotonic() + timeout
    while True:
        code, body, _ = _get(base, "/debug/windows")
        if code != 200:
            return 1
        done = [t["seq"] for t in json.loads(body)["traces"]
                if t["complete"]]
        if done or time.monotonic() > deadline:
            return min(done, default=1)
        time.sleep(0.02)


def _small_window(seed: int):
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate

    return generate(SyntheticSpec(n_pids=8, n_unique_stacks=128, n_rows=128,
                                  total_samples=1024, mean_depth=6,
                                  seed=seed))


class Harness:
    """Runs the port's CLI in this process over `windows` small synthetic
    windows; `hook(base_url)` runs inside the capture source's poll before
    window `at` (the server answers from its own threads meanwhile)."""

    def __init__(self, monkeypatch, windows=3, at=3, hook=None):
        from parca_agent_tpu_torch import web

        self.servers = []
        harness = self
        real = web.AgentHTTPServer

        class Recorded(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                harness.servers.append(self)

        class Source:
            def __init__(self, n):
                self._n = 0

            def poll(self):
                if self._n >= windows:
                    return None
                self._n += 1
                if hook is not None and self._n == at:
                    hook(harness.base)
                return _small_window(self._n)

        monkeypatch.setattr(web, "AgentHTTPServer", Recorded)
        monkeypatch.setattr(cli, "SyntheticSource", Source)
        self.windows = windows

    @property
    def base(self):
        return f"http://127.0.0.1:{self.servers[0].port}"

    def run(self, capsys, *flags):
        code = cli.run(["--device", "cpu", "--http-address", "127.0.0.1:0",
                        "--capture", "synthetic", "--windows",
                        str(self.windows), "--profiling-duration", "0.05",
                        *flags])
        out = capsys.readouterr()
        lines = [json.loads(ln) for ln in out.out.splitlines()
                 if ln.startswith("{")]
        return code, lines, out.err


def test_cli_serves_every_route(monkeypatch, capsys, tmp_path):
    """The routes phase 14 of chip_smoke.py scrapes, on the CPU: the
    port's CLI with --fast-encode, discovery and --log-level debug."""
    seen = {}

    def query(base):
        seen["query"] = _get(base, "/query?pid=1000&timeout=20")

    def hook(base):
        # /query waits for the next profile of pid 1000: the next window's,
        # which cannot start before this hook returns.
        seen["query_thread"] = threading.Thread(target=query, args=(base,))
        seen["query_thread"].start()
        for path in ("/", "/metrics", "/healthy", "/healthz",
                     "/debug/windows", "/debug/trace/99999", "/debug/device",
                     "/debug/pprof/cmdline", "/debug/pprof/profile?seconds=0.2",
                     "/debug/pprof/heap?seconds=0.1", "/hotspots", "/diff"):
            seen[path] = _get(base, path)
        seen["/debug/trace/1"] = _get(base, f"/debug/trace/{_trace_seq(base)}")

    h = Harness(monkeypatch, hook=hook)
    code, lines, err = h.run(
        capsys, "--aggregator", "dict", "--fast-encode",
        "--enable-cgroup-discovery", "--enable-systemd-discovery",
        "--log-level", "debug", "--local-store-directory",
        str(tmp_path / "store"))
    assert code == 0, err[-2000:]
    seen.pop("query_thread").join(timeout=30)
    assert "parca-agent-tpu-torch listening" in err and "level=info" in err
    status = {k: v[0] for k, v in seen.items()}
    assert status == {
        "/": 200, "/metrics": 200, "/healthy": 200, "/healthz": 200,
        "/debug/windows": 200, "/debug/trace/1": 200,
        "/debug/trace/99999": 404, "/debug/device": 200,
        "/debug/pprof/cmdline": 200, "/debug/pprof/profile?seconds=0.2": 200,
        "/debug/pprof/heap?seconds=0.1": 200, "/hotspots": 503,
        "/diff": 503, "query": 200}
    assert b"parca-agent-tpu (0.1.0" in seen["/"][1]
    fams = parse_prometheus_text(seen["/metrics"][1].decode())
    attempts = fams["parca_agent_profiler_attempts_total"]["samples"][0][2]
    assert attempts == 2
    assert fams["parca_agent_window_stage_duration_seconds"]["type"] == \
        "histogram"
    assert "discovery" in json.loads(seen["/healthz"][1])["actors"]
    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    threads = {lbl["thread"] for _, _, lbl in parse_pprof(
        seen["/debug/pprof/profile?seconds=0.2"][1]).samples}
    assert "actor-profiler" in threads
    labels = json.loads(seen["query"][2]["X-Profile-Labels"])["labels"]
    assert labels["pid"] == "1000"
    assert [ln["window"] for ln in lines if "window" in ln] == [1, 2, 3]
    # The server is gone with the run.
    assert not any(t.name == "http" for t in threading.enumerate())
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", h.servers[0].port), 1).close()


def test_cli_metrics_agree_with_the_window_lines(monkeypatch, capsys):
    """Once the window lines printed by then are every window taken, the
    loop's counters on /metrics are theirs."""
    got = {}

    def hook(base):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            fams = parse_prometheus_text(_get(base, "/metrics")[1].decode())
            written = fams["parca_agent_profiler_profiles_written_total"]
            if written["samples"][0][2] == 16:
                break
            time.sleep(0.05)
        got["fams"] = fams

    h = Harness(monkeypatch, hook=hook)
    code, lines, _ = h.run(capsys, "--aggregator", "dict", "--fast-encode")
    assert code == 0
    wins = [ln for ln in lines if "window" in ln]

    def value(name):
        return got["fams"][name]["samples"][0][2]

    assert value("parca_agent_profiler_attempts_total") == 2
    assert value("parca_agent_profiler_profiles_written_total") == \
        sum(w["profiles"] for w in wins[:2])
    assert value("parca_agent_profiler_samples_aggregated_total") == \
        sum(w["samples"] for w in wins[:2])
    assert value("parca_agent_profiler_errors_total") == 0


class _FakeDiscoverer:
    """A cgroup discoverer stand-in: one container holding pid 1000."""

    def __init__(self, *a, **k):
        pass

    def run(self, stop, up):
        from parca_agent_tpu_torch.discovery.manager import Group

        up([Group(source=f"cgroup/{CID}", labels={"containerid": CID},
                  pids=[1000], entry_pid=1000)])
        stop.wait()


def test_cli_discovery_labels_reach_the_stored_profiles(monkeypatch, capsys,
                                                       tmp_path):
    from parca_agent_tpu_torch.discovery import cgroup

    monkeypatch.setattr(cgroup, "CgroupContainerDiscoverer", _FakeDiscoverer)
    h = Harness(monkeypatch, windows=2)
    store = tmp_path / "store"
    code, _, err = h.run(capsys, "--aggregator", "dict", "--fast-encode",
                         "--enable-cgroup-discovery",
                         "--local-store-directory", str(store))
    assert code == 0, err[-2000:]
    names = [f.name for f in store.iterdir()]
    tagged = [n for n in names if f"containerid={CID}" in n]
    # Both windows, the first included (discovery's first scrape is
    # seeded before it), and only pid 1000.
    assert len(tagged) == 2 and all("_pid=1000." in n for n in tagged)
    assert len(names) == 16


@pytest.mark.parametrize("flags", [("--no-window-trace",),
                                   ("--no-device-telemetry",),
                                   ("--no-window-trace",
                                    "--no-device-telemetry")])
def test_cli_runs_without_the_recorders(monkeypatch, capsys, tmp_path,
                                        flags):
    seen = {}

    def hook(base):
        for path in ("/debug/windows", "/debug/device", "/metrics"):
            seen[path] = _get(base, path)[0]
        seen["/debug/trace/1"] = _get(
            base, f"/debug/trace/{_trace_seq(base)}")[0]

    h = Harness(monkeypatch, windows=2, at=2, hook=hook)
    code, lines, err = h.run(capsys, "--aggregator", "dict", "--fast-encode",
                             "--trace-incident-dir", str(tmp_path / "inc"),
                             *flags)
    assert code == 0, err[-2000:]
    trace_off = "--no-window-trace" in flags
    tel_off = "--no-device-telemetry" in flags
    assert seen["/debug/windows"] == (503 if trace_off else 200)
    assert seen["/debug/trace/1"] == (503 if trace_off else 200)
    assert seen["/debug/device"] == (503 if tel_off else 200)
    assert seen["/metrics"] == 200
    runtime = next(ln["runtime"] for ln in lines if "runtime" in ln)
    assert ("trace" in runtime) != trace_off
    assert ("device_telemetry" in runtime) != tel_off
    assert len([ln for ln in lines if "window" in ln]) == 2


def test_cli_stops_with_an_error_when_the_address_is_taken(capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        code = cli.run(["--device", "cpu", "--http-address",
                        f"127.0.0.1:{port}", "--windows", "1",
                        "--profiling-duration", "0.05"])
    assert code == 2
    err = capsys.readouterr().err
    assert "cannot listen on --http-address" in err and str(port) in err


# The families the JAX CLI serves and the port's does not: the
# device-state divergence (ROADMAP.md C: no degraded state, so no
# cooldown, shadow, trips, fallback windows, demotions or promotions) and
# the backend resolution the port does not have (a CUDA tensor launches
# the hand kernel, a CPU tensor runs its plain version).
JAX_ONLY = {
    "parca_agent_device_cooldown_windows", "parca_agent_device_trips",
    "parca_agent_device_shadow_pending",
    "parca_agent_device_demotions_total",
    "parca_agent_device_promotions_total",
    "parca_agent_device_fallback_windows_total",
    "parca_agent_device_shadow_windows_total",
    "parca_agent_device_shadow_mismatches_total",
    "parca_agent_kernel_backend", "parca_agent_kernel_fallback",
    "parca_agent_kernel_interpret",
}
# Families both render once a kernel ran on the device path: the JAX CLI
# aggregates its first windows on its CPU fallback while its device probe
# is pending, so it may have none yet.
KERNEL_EVENTS = {
    "parca_agent_kernel_duration_seconds", "parca_agent_kernel_p50_seconds",
    "parca_agent_kernel_p99_seconds", "parca_agent_kernel_max_seconds",
    "parca_agent_kernel_compiles_total", "parca_agent_kernel_shapes",
    "parca_agent_kernel_recompiles_total",
    "parca_agent_transfer_bytes_total", "parca_agent_transfer_ops_total",
}


def _families_of_both_clis(monkeypatch, capsys, tmp_path, extra=None):
    """Both CLIs replay the same three windows (--aggregator dict
    --fast-encode, plus `extra(run_dir)` flags); /metrics before the
    third window. Returns each one's {family: type}."""
    import parca_agent_tpu.capture.replay as jax_replay
    import parca_agent_tpu.runtime.device_telemetry as jax_dtel
    import parca_agent_tpu.runtime.trace as jax_trace
    import parca_agent_tpu.web as jax_web
    import parca_agent_tpu_torch.capture.replay as port_replay
    import parca_agent_tpu_torch.web as port_web
    from parca_agent_tpu_torch.capture.formats import save_snapshot

    files = []
    for i in range(3):
        files.append(str(tmp_path / f"w{i}.snap"))
        save_snapshot(_small_window(i + 1), files[-1])
    scraped = {}

    def patch(name, web, replay):
        servers = []

        class Recorded(web.AgentHTTPServer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                servers.append(self)

        class Scraping(replay.ReplaySource):
            def poll(self):
                if self._pos == 2:
                    scraped[name] = _get(
                        f"http://127.0.0.1:{servers[0].port}",
                        "/metrics")[1].decode()
                return super().poll()

        monkeypatch.setattr(web, "AgentHTTPServer", Recorded)
        monkeypatch.setattr(replay, "ReplaySource", Scraping)

    patch("jax", jax_web, jax_replay)
    patch("port", port_web, port_replay)
    flags = ["--capture", "replay", "--replay", *files, "--windows", "3",
             "--profiling-duration", "0.05", "--aggregator", "dict",
             "--fast-encode", "--aggregator-capacity", "4096",
             "--http-address", "127.0.0.1:0"]
    import signal

    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGINT, signal.SIGTERM)}

    def run_flags(name):
        out = flags + ["--local-store-directory", str(tmp_path / name)]
        return out + (extra(tmp_path / f"{name}-run") if extra else [])

    try:
        assert jax_cli.run(run_flags("jax")) == 0
    finally:
        # The JAX CLI installs process-global hooks and signal handlers.
        jax_trace.install(None)
        jax_dtel.install(None)
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert cli.run(run_flags("port") + ["--device", "cpu"]) == 0
    capsys.readouterr()
    return ({k: v["type"] for k, v in
             parse_prometheus_text(scraped[w]).items()}
            for w in ("jax", "port"))


def _assert_families_agree(jax_f, port_f, device_path=KERNEL_EVENTS):
    assert set(jax_f) - set(port_f) <= JAX_ONLY
    assert set(jax_f) - set(port_f) >= JAX_ONLY - {
        "parca_agent_kernel_backend", "parca_agent_kernel_fallback",
        "parca_agent_kernel_interpret"}
    assert set(port_f) - set(jax_f) <= device_path
    assert {k: port_f[k] for k in set(port_f) & set(jax_f)} == \
        {k: jax_f[k] for k in set(port_f) & set(jax_f)}


def test_cli_metrics_families_equal_the_jax_clis(monkeypatch, capsys,
                                                 tmp_path):
    _assert_families_agree(*_families_of_both_clis(monkeypatch, capsys,
                                                   tmp_path))


def _analytics_flags(run_dir):
    """The analytics' flags (hotspots, the regression sentinel judging
    every window, every sink, tenant quotas), files under `run_dir`."""
    return ["--hotspots", "--regression", "--regression-interval", "0.05",
            "--regression-baseline-windows", "1",
            "--sink", "pprof,autofdo,series,alerts",
            "--autofdo-dir", str(run_dir / "afdo"),
            "--autofdo-flush-windows", "1",
            "--alerts-path", str(run_dir / "alerts.jsonl"),
            "--tenant-quota-samples", "2000", "--tenant-quota-pids", "4"]


ANALYTICS_FAMILIES = (
    "parca_agent_hotspot_windows_folded_total",
    "parca_agent_regression_windows_folded_total",
    "parca_agent_admission_over_quota_windows_total",
    "parca_agent_tenant_window_samples",
    "parca_agent_sink_windows_total",
)
# The series sink's samples render once a window reached the sinks:
# the JAX CLI's first windows take its CPU fallback (the scalar path,
# which no sink sees) while its device probe is pending, as they do for
# KERNEL_EVENTS.
SINK_DATA = {"parca_agent_sink_series_samples_total"}


def test_cli_metrics_families_equal_the_jax_clis_with_the_analytics(
        monkeypatch, capsys, tmp_path):
    """The same comparison with the analytics on in both CLIs: their
    families are the same, and no family is added to JAX_ONLY."""
    jax_f, port_f = _families_of_both_clis(monkeypatch, capsys, tmp_path,
                                           _analytics_flags)
    _assert_families_agree(jax_f, port_f, KERNEL_EVENTS | SINK_DATA)
    assert all(f in port_f and f in jax_f for f in ANALYTICS_FAMILIES)


def _store(path):
    """(labels, decompressed profile) of each file of a local store
    directory, sorted (a name is the labels, the write time, .pb.gz)."""
    return sorted((f.name.rsplit(".", 3)[0], gzip.decompress(f.read_bytes()))
                  for f in path.iterdir())


def test_cli_serves_the_analytics(monkeypatch, capsys, tmp_path):
    """The port's CLI with the analytics' flags on the CPU: /hotspots and
    /diff answer 200 with their JSON, /metrics parses strictly and
    carries their families, /healthz has their sections, the AutoFDO
    directory holds profdata, and the stored pprof bytes equal a run's
    with the pprof sink alone."""
    seen = {}

    def hook(base):
        for path in ("/hotspots", "/hotspots?k=3&tenant=unknown", "/diff",
                     "/diff?kind=regressed", "/metrics", "/healthz"):
            seen[path] = _get(base, path)

    run = tmp_path / "run"
    flags = ["--aggregator", "dict", "--fast-encode", *_analytics_flags(run)]
    code, lines, err = Harness(monkeypatch, hook=hook).run(
        capsys, *flags, "--local-store-directory", str(tmp_path / "all"))
    assert code == 0, err[-2000:]
    assert {k: v[0] for k, v in seen.items()} == dict.fromkeys(seen, 200)
    hot = json.loads(seen["/hotspots"][1])
    counts = [e["count"] for e in hot["entries"]]
    assert counts and counts == sorted(counts, reverse=True)
    # Window 2 may still be on the encode worker.
    assert hot["windows"] in (1, 2) and all(e["frames"] for e in hot["entries"])
    assert len(json.loads(seen["/hotspots?k=3&tenant=unknown"][1])[
        "entries"]) <= 3
    assert "groups" in json.loads(seen["/diff"][1])
    fams = parse_prometheus_text(seen["/metrics"][1].decode())
    assert all(f in fams for f in ANALYTICS_FAMILIES)
    health = json.loads(seen["/healthz"][1])
    assert {"hotspots", "sinks", "admission", "regression"} <= set(health)
    assert any(f.name.endswith(".afdo.txt") for f in (run / "afdo").iterdir())
    assert len([ln for ln in lines if "window" in ln]) == 3
    # The same windows with the pprof sink alone: the same bytes.
    code, _, err = Harness(monkeypatch).run(
        capsys, *flags, "--sink", "pprof", "--local-store-directory",
        str(tmp_path / "pprof"))
    assert code == 0, err[-2000:]
    alone = _store(tmp_path / "pprof")
    assert alone and _store(tmp_path / "all") == alone


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_incident_file_carries_a_self_profile(tmp_path):
    """A device hang's incident file bundles a self-pprof of the agent
    (profiler/selfprofile.py), not self_profile_error."""
    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0", "--capture", "synthetic",
         "--windows", "2", "--profiling-duration", "0.1",
         "--device-timeout", "1", "--fault-inject",
         "device.dispatch:hang:after=0", "--trace-incident-dir",
         str(tmp_path / "inc"), "--fast-encode"],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 1, r.stderr[-2000:]
    (inc,) = (tmp_path / "inc").iterdir()
    body = json.loads(inc.read_text())
    assert "self_profile_error" not in body
    import base64

    prof = parse_pprof(base64.b64decode(body["self_profile_pprof_gz_b64"]))
    assert "http" in {lbl["thread"] for _, _, lbl in prof.samples}
