"""The port's CLI shipping to a Parca store over gRPC, on the CPU.

The store is an in-process gRPC server that records every WriteRaw
request; the CLI runs as a subprocess (``--device cpu``), as a user runs
it. Every window's profiles must arrive, the last window's included,
under the label pipeline's labels, and each pid's mass must equal the
synthetic windows' (regenerated here from their seeds). A run against a
dead address spills every window to the spool, and a second run against
a live store replays it oldest first. The CLI must also run where grpc
and yaml cannot be imported, when no flag asks for them.

The JAX CLI cannot be held to the port's byte for byte here (its CPU
fallback changes its store), so the parity at this level is of the label
sets: the port's loops and parca_agent_tpu's loop, over the same window
and the same FakeFS, write each pid under the same labels and drop the
same targets.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
from concurrent import futures
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu_torch.agent.grpc_client import (
    MAX_MSG_BYTES,
    WRITE_RAW_METHOD,
)
from parca_agent_tpu_torch.agent.profilestore import decode_write_raw_request
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import parse_pprof

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WINDOWS = 3
RELABEL = "relabel_configs:\n- action: labeldrop\n  regex: kernel_release\n"


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


class Store:
    """An in-process WriteRaw server: every request's series, in order.
    It takes requests up to the client's message cap (gRPC servers take
    4 MiB by default; a window of the CLI's synthetic source is more)."""

    def __init__(self, grpc):
        self.requests: list = []
        self._mu = threading.Lock()
        svc, method = WRITE_RAW_METHOD.lstrip("/").rsplit("/", 1)
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=2),
            options=[("grpc.max_receive_message_length", MAX_MSG_BYTES)])
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(svc, {
                method: grpc.unary_unary_rpc_method_handler(
                    self._handle, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)}),))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def _handle(self, request, context):
        series, normalized = decode_write_raw_request(request)
        assert normalized
        with self._mu:
            self.requests.append(series)
        return b""

    def series(self) -> list:
        with self._mu:
            return [s for req in self.requests for s in req]

    def stop(self) -> None:
        self.server.stop(0)


@pytest.fixture
def store():
    grpc = pytest.importorskip("grpc")
    s = Store(grpc)
    yield s
    s.stop()


def _run_cli(tmp_path, *flags, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--windows", str(WINDOWS), *flags],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    return ([ln for ln in lines if "window" in ln],
            next(ln["runtime"] for ln in lines if "runtime" in ln))


def _window_mass() -> dict[int, int]:
    """Each pid's mass over the CLI's synthetic windows (seeds 1..3)."""
    mass: dict[int, int] = {}
    for n in range(1, WINDOWS + 1):
        snap = generate(SyntheticSpec(seed=n))
        per = np.bincount(snap.pids, weights=snap.counts.astype(np.float64))
        for pid in np.flatnonzero(per):
            mass[int(pid)] = mass.get(int(pid), 0) + int(per[pid])
    return mass


def _received_mass(series) -> tuple[dict[int, int], dict[int, int]]:
    """(mass, samples) by pid of the store's series; every sample's pprof
    must gunzip and parse."""
    mass: dict[int, int] = {}
    samples: dict[int, int] = {}
    for s in series:
        pid = int(s.labels["pid"])
        for blob in s.samples:
            prof = parse_pprof(gzip.decompress(blob))
            mass[pid] = mass.get(pid, 0) + sum(v[0] for _, v, _
                                               in prof.samples)
            samples[pid] = samples.get(pid, 0) + 1
    return mass, samples


def _labels_flags(tmp_path) -> list[str]:
    cfg = tmp_path / "relabel.yaml"
    cfg.write_text(RELABEL)
    return ["--node", "e2e-node", "--metadata-external-labels",
            "env=e2e,team=profiling", "--config-path", str(cfg)]


@pytest.mark.parametrize("fast", [False, True], ids=["scalar", "fast-encode"])
def test_cli_ships_every_window_to_the_store(tmp_path, store, fast):
    pytest.importorskip("yaml")
    windows, runtime = _run_cli(
        tmp_path, *(["--fast-encode"] if fast else []),
        "--profiling-duration", "0.1",
        "--remote-store-address", f"127.0.0.1:{store.port}",
        "--remote-store-insecure", "--debuginfo-upload-disable",
        *_labels_flags(tmp_path))
    assert len(windows) == WINDOWS
    series = store.series()
    for s in series:
        assert s.labels["__name__"] == "parca_agent_cpu"
        assert s.labels["node"] == "e2e-node"
        assert s.labels["env"] == "e2e" and s.labels["team"] == "profiling"
        assert "kernel_release" not in s.labels  # the relabel rule
    mass, samples = _received_mass(series)
    # Every window's profiles, the last one's included: one sample a pid
    # a window, and each pid's mass that of the windows.
    assert sum(samples.values()) == sum(w["profiles"] for w in windows)
    assert mass == _window_mass()
    assert sum(mass.values()) == sum(w["mass"] for w in windows)
    t = runtime["transport"]
    assert t["parca_agent_remote_write_batches_sent_total"] >= 1
    assert t["parca_agent_remote_write_errors_total"] == 0
    assert t["parca_agent_remote_write_buffered_samples"] == 0
    assert t["parca_agent_remote_write_samples_dropped"] == 0
    assert t["parca_agent_remote_store_channel_resets_total"] == 0
    assert runtime["supervisor"]["flush"]["state"] == "exited"


def test_cli_spools_an_outage_and_replays_it_oldest_first(tmp_path, store):
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    spool = tmp_path / "spool"
    common = ["--profiling-duration", "0.3", "--spool-directory", str(spool),
              "--remote-store-insecure", "--debuginfo-upload-disable",
              "--remote-store-batch-write-interval", "0.2"]
    windows, runtime = _run_cli(tmp_path, "--remote-store-address",
                                f"127.0.0.1:{dead}", *common)
    t = runtime["transport"]
    assert t["parca_agent_remote_write_batches_sent_total"] == 0
    assert t["parca_agent_spool_segments"] >= 1
    assert t["parca_agent_spool_samples_dropped"] == 0
    # The spool holds every window: read a copy of it oldest first.
    from parca_agent_tpu_torch.agent.spool import SpoolDir

    shutil.copytree(spool, tmp_path / "copy")
    copy = SpoolDir(str(tmp_path / "copy"))
    spilled = []
    while (got := copy.read_oldest()) is not None:
        spilled.extend(got[1])
        copy.pop(got[0])
    mass, samples = _received_mass(spilled)
    assert mass == _window_mass()
    assert sum(samples.values()) == sum(w["profiles"] for w in windows)

    _, runtime = _run_cli(tmp_path, "--remote-store-address",
                          f"127.0.0.1:{store.port}", *common)
    t = runtime["transport"]
    assert t["parca_agent_spool_segments"] == 0
    assert t["parca_agent_remote_write_segments_replayed"] >= 1
    # The spilled samples arrive in the spool's order (oldest first),
    # among this run's own windows.
    wanted = [b for s in spilled for b in s.samples]
    got = [b for s in store.series() for b in s.samples]
    pos = {b: i for i, b in enumerate(got)}
    assert all(b in pos for b in wanted)
    order = [pos[b] for b in wanted]
    assert order == sorted(order)


def test_cli_runs_without_grpc_and_yaml(tmp_path):
    code = (
        "import sys\n"
        "class Blocker:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('grpc', 'yaml'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Blocker())\n"
        "from parca_agent_tpu_torch import cli\n"
        "rc = cli.run(['--device', 'cpu', '--windows', '2',\n"
        "              '--http-address', '127.0.0.1:0',\n"
        "              '--profiling-duration', '0.1', '--fast-encode',\n"
        "              '--node', 'n1', '--local-store-directory', 'store'])\n"
        "assert not any(m.split('.')[0] in ('grpc', 'yaml')\n"
        "               for m in sys.modules), 'grpc or yaml imported'\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    files = list((tmp_path / "store").glob("*.pb.gz"))
    assert files and all("node=n1" in f.name for f in files)


def test_cli_without_label_flags_keeps_the_file_names(tmp_path):
    """No store and no label flag: profiles keep {__name__, pid}, so the
    local store's files are named as before the label pipeline."""
    windows, runtime = _run_cli(tmp_path, "--profiling-duration", "0.1",
                                "--local-store-directory", "store")
    names = [f.name for f in (tmp_path / "store").glob("*.pb.gz")]
    assert len(names) == sum(w["profiles"] for w in windows)
    assert all(n.startswith("pid=") and n.count("=") == 1 for n in names)
    # The transport runs on its no-op store, as the original's does.
    t = runtime["transport"]
    assert t["parca_agent_remote_write_batches_sent_total"] >= 1
    assert "parca_agent_remote_store_channel_resets_total" not in t


# -- the label sets: the port's loops against parca_agent_tpu's ---------------


def _procfs(pids) -> dict[str, bytes]:
    files = {"/proc/sys/kernel/osrelease": b"6.1.0-fake\n"}
    for pid in pids:
        comm = b"java" if pid % 5 == 0 else b"svc-%d" % (pid % 3)
        files[f"/proc/{pid}/comm"] = comm + b"\n"
        files[f"/proc/{pid}/cmdline"] = b"/usr/bin/" + comm + b"\x00-x\x00"
        files[f"/proc/{pid}/cgroup"] = b"0::/system.slice/%d.service\n" % pid
    return files


RULES = [{"action": "drop", "source_labels": ["comm"], "regex": "java"},
         {"action": "labeldrop", "regex": "kernel_release"},
         {"action": "replace", "source_labels": ["comm"], "regex": "svc-(.)",
          "target_label": "shard", "replacement": "s$1"}]


class _Recorder:
    def __init__(self):
        self.labels = {}

    def write(self, labels, pprof_bytes):
        self.labels[int(labels["pid"])] = dict(labels)


def _port_manager(files):
    from parca_agent_tpu_torch.labels.manager import LabelsManager
    from parca_agent_tpu_torch.labels.relabel import RelabelConfig
    from parca_agent_tpu_torch.metadata import providers as mp
    from parca_agent_tpu_torch.utils.vfs import FakeFS

    fs = FakeFS(dict(files))
    return LabelsManager(
        [mp.ServiceDiscoveryProvider(), mp.ProcessProvider(fs=fs),
         mp.CgroupProvider(fs=fs), mp.SystemProvider(fs=fs),
         mp.TargetProvider(node="n1", external={"env": "e"})],
        [RelabelConfig.from_dict(r) for r in RULES])


def _jax_manager(files):
    from parca_agent_tpu.labels.manager import LabelsManager
    from parca_agent_tpu.labels.relabel import RelabelConfig
    from parca_agent_tpu.metadata import providers as mp
    from parca_agent_tpu.utils.vfs import FakeFS

    fs = FakeFS(dict(files))
    return LabelsManager(
        [mp.ServiceDiscoveryProvider(), mp.ProcessProvider(fs=fs),
         mp.CgroupProvider(fs=fs), mp.SystemProvider(fs=fs),
         mp.TargetProvider(node="n1", external={"env": "e"})],
        [RelabelConfig.from_dict(r) for r in RULES])


class _OneWindow:
    def __init__(self, snap):
        self._snap = snap

    def poll(self):
        snap, self._snap = self._snap, None
        return snap


@pytest.mark.parametrize("loop", ["aggregate", "fast", "fast-scalar"])
def test_loops_write_the_same_label_sets(loop):
    from parca_agent_tpu.aggregator.cpu import CPUAggregator as JaxCPU
    from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
    from parca_agent_tpu.capture.synthetic import generate as jax_generate
    from parca_agent_tpu.profiler.cpu import CPUProfiler as JaxProfiler
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.profiler.cpu import AggregateLoop, CPUProfiler

    spec = dict(n_pids=30, n_unique_stacks=300, total_samples=5_000, seed=3)
    snap = generate(SyntheticSpec(**spec))
    files = _procfs(np.unique(snap.pids).tolist())
    port_rec, jax_rec = _Recorder(), _Recorder()
    if loop == "aggregate":
        port = AggregateLoop(_OneWindow(snap), CPUAggregator(),
                             profile_writer=port_rec,
                             labels_manager=_port_manager(files))
    else:
        port = CPUProfiler(
            _OneWindow(snap), DictAggregator(capacity=1 << 12,
                                             device=torch.device("cpu")),
            profile_writer=port_rec, encode_pipeline=False,
            encode_deadline_s=1e-9 if loop == "fast-scalar" else None,
            labels_manager=_port_manager(files))
    records = []
    port._on_window = records.append
    assert port.run_iteration()
    jax = JaxProfiler(_OneWindow(jax_generate(JaxSpec(**spec))), JaxCPU(),
                      labels_manager=_jax_manager(files),
                      profile_writer=jax_rec)
    assert jax.run_iteration()
    assert port_rec.labels == jax_rec.labels
    dropped = {p for p in np.unique(snap.pids).tolist() if p % 5 == 0}
    assert dropped and not dropped & set(port_rec.labels)
    assert set(port_rec.labels) | dropped == set(np.unique(snap.pids).tolist())
    assert port.metrics.profiles_written == len(port_rec.labels) == \
        jax.metrics.profiles_written
    assert records[0]["profiles"] == len(port_rec.labels)
    if loop == "fast-scalar":
        assert port.metrics.scalar_windows_total == 1
