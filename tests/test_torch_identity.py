"""The port's process identity (process/identity.py) against
parca_agent_tpu's, and the pid-reuse regression through the port's
window loop.

The same /proc contents and the same seeded window sequences go through
both packages' trackers: the starttimes read, the reused pids found, the
invalidators fired and the counters must be equal. The regression runs
parca_agent_tpu's bench_zoo pid_reuse scenario (its windows made here,
since the zoo's runner drives parca_agent_tpu's classes) through the
port's AggregateLoop on the dictionary with device="cpu": with the stamp
off the recycled pids' samples land on the dead binary, as the
original's control arm shows; with it on, none do. The chaos site
``process.identity`` fails open alike, and the CLI without --fast-encode
observes identity unless --no-pid-generation or PARCA_NO_PID_GENERATION=1
turns it off, and survives the site's fault and ``symbolize.kernel``'s.
"""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from parca_agent_tpu.bench_zoo import run_scenario
from parca_agent_tpu.bench_zoo.scenarios import PidReuseScenario
from parca_agent_tpu.process import identity as jax_identity
from parca_agent_tpu.utils import faults as jax_faults
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS
from parca_agent_tpu_torch import cli
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture import formats
from parca_agent_tpu_torch.process import identity
from parca_agent_tpu_torch.profiler.cpu import AggregateLoop
from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import FakeFS

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.install(None)
    jax_faults.install(None)


def _stat(pid: int, comm: str, start: int) -> bytes:
    rest = ["R", "1", "1", "1", "0", "-1", "4194560", "0", "0", "0", "0",
            "5", "6", "0", "0", "20", "0", "1", "0", str(start), "0"]
    return f"{pid} ({comm}) {' '.join(rest)}".encode()


@pytest.mark.parametrize("body", [
    _stat(7, "a (b) c", 123456789),
    _stat(7, "plain", 1),
    b"no parens here",
    b"7 (x) R 1",
    b"7 (x) " + b"1 " * 18 + b"notanumber 0",
])
def test_read_starttime_matches_parca_agent_tpus(body):
    outs = []
    for mod, fs in ((identity, FakeFS({"/proc/7/stat": body})),
                    (jax_identity, JaxFS({"/proc/7/stat": body}))):
        try:
            outs.append(mod.read_starttime(fs, 7))
        except Exception as e:  # noqa: BLE001 - the outcome compared
            outs.append(type(e).__name__)
    assert outs[0] == outs[1]
    for mod, fs in ((identity, FakeFS({})), (jax_identity, JaxFS({}))):
        with pytest.raises(FileNotFoundError):
            mod.read_starttime(fs, 8)


def _worlds(seed: int, windows: int = 30, pids: int = 40):
    """A seeded sequence of (window pids, starttime of each live pid):
    pids come and go, exit mid-window (no stat) and are recycled with a
    new starttime."""
    rng = np.random.default_rng(seed)
    start = {p: int(rng.integers(1, 1 << 30)) for p in range(pids)}
    out = []
    for _ in range(windows):
        for p in rng.choice(pids, 3, replace=False).tolist():
            start[p] = int(rng.integers(1, 1 << 30))   # recycled
        gone = set(rng.choice(pids, 2, replace=False).tolist())
        seen = rng.choice(pids, int(rng.integers(5, pids)), replace=True)
        seen = np.concatenate([seen, [-1]]).tolist()  # a pseudo-pid
        out.append((seen, {p: s for p, s in start.items()
                           if p not in gone}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("enabled", [True, False])
def test_tracker_matches_parca_agent_tpus(seed, enabled):
    world: dict[int, int] = {}
    t = identity.ProcessIdentityTracker(starttime_of=world.__getitem__,
                                        enabled=enabled)
    jt = jax_identity.ProcessIdentityTracker(starttime_of=world.__getitem__,
                                             enabled=enabled)
    fired, jfired = [], []
    t.add_invalidator("boom", lambda pid: 1 / 0 if pid % 5 == 0 else None)
    jt.add_invalidator("boom", lambda pid: 1 / 0 if pid % 5 == 0 else None)
    t.add_invalidator("rec", fired.append)
    jt.add_invalidator("rec", jfired.append)
    for k, (seen, starts) in enumerate(_worlds(seed)):
        world.clear()
        world.update(starts)
        assert t.observe_window(seen) == jt.observe_window(seen)
        if k == 10:
            t.forget(seen[0])
            jt.forget(seen[0])
    assert fired == jfired
    assert t.metrics() == jt.metrics()
    snap, jsnap = t.snapshot(), jt.snapshot()
    assert snap == jsnap
    if enabled:
        assert t.metrics()["reuse_detected_total"] > 0
        assert t.metrics()["invalidation_errors_total"] > 0
    else:
        assert fired == [] and t.metrics()["checks_total"] == 0


@pytest.mark.chaos
def test_identity_fault_is_fail_open_alike():
    world = {10: 100, 11: 5}
    t = identity.ProcessIdentityTracker(starttime_of=world.__getitem__,
                                        enabled=True)
    jt = jax_identity.ProcessIdentityTracker(starttime_of=world.__getitem__,
                                             enabled=True)
    for tr in (t, jt):
        tr.observe_window([10, 11])
    faults.install(faults.FaultInjector.from_spec(
        "process.identity:error", seed=42))
    jax_faults.install(jax_faults.FaultInjector.from_spec(
        "process.identity:error", seed=42))
    world[10] = 999
    assert t.observe_window([10]) == jt.observe_window([10]) == []
    faults.install(None)
    jax_faults.install(None)
    assert t.observe_window([10]) == jt.observe_window([10]) == [10]
    assert t.metrics() == jt.metrics()
    assert t.metrics()["errors_total"] == 1


# -- the regression through the port's window loop ---------------------------


def _port_snap(w):
    def fields(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}

    return formats.WindowSnapshot(**{
        **fields(w), "mappings": formats.MappingTable(**fields(w.mappings))})


class _Source:
    """The scenario's windows, each one's starttimes set in the world
    before it is polled (as the zoo's own source does)."""

    def __init__(self, windows, world: dict):
        self._windows = list(windows)
        self._world = world
        self.current = -1

    def poll(self):
        if self.current + 1 >= len(self._windows):
            return None
        self.current += 1
        zw = self._windows[self.current]
        self._world.update(zw.starttimes)
        return _port_snap(zw.snapshot)


class _Recording:
    """The dictionary, keeping each window's profiles."""

    def __init__(self, inner):
        self._inner = inner
        self.by_window = []

    def aggregate(self, snap):
        out = self._inner.aggregate(snap)
        self.by_window.append(out)
        return out


def _port_pid_reuse(seed: int, hardened: bool) -> dict:
    scn = PidReuseScenario()
    windows = scn.build(seed, 0.25)
    world: dict[int, int] = {}
    inner = DictAggregator(capacity=1 << 14, device="cpu")
    agg = _Recording(inner)
    quarantine = QuarantineRegistry()
    perf = PerfMapCache(fs=FakeFS())
    tracker = identity.ProcessIdentityTracker(
        starttime_of=world.__getitem__, enabled=hardened)
    tracker.add_invalidator("quarantine", quarantine.forget_pid)
    tracker.add_invalidator("perfmap", perf.evict)
    tracker.add_invalidator("aggregator", inner.invalidate_pid)
    loop = AggregateLoop(_Source(windows, world), agg,
                         quarantine=quarantine, identity=tracker,
                         device_timeout_s=None, duration_s=0.01)
    while loop.run_iteration():
        pass
    outcome = {"hardened": hardened, "identity": tracker.metrics()}
    bars = scn.check(outcome, types.SimpleNamespace(
        profiles_by_window=agg.by_window))
    outcome["bars"] = bars
    outcome["windows"] = len(agg.by_window)
    return outcome


def test_pid_reuse_misattribution_shows_without_the_stamp_and_vanishes():
    bad = _port_pid_reuse(2026, hardened=False)
    good = _port_pid_reuse(2026, hardened=True)
    jbad = run_scenario("pid_reuse", 2026, scale=0.25, hardened=False)
    jgood = run_scenario("pid_reuse", 2026, scale=0.25, hardened=True)
    # Without the stamp the recycled pids' samples land on the dead
    # binary, by the same mass as in parca_agent_tpu's control arm.
    assert bad["misattributed_mass"] > 0
    assert bad["misattributed_mass"] == jbad["misattributed_mass"]
    assert all(bad["bars"].values()), bad["bars"]
    # With it, none do, and every recycled pid is detected.
    assert good["misattributed_mass"] == 0
    assert good["post_reuse_mass_new_binary"] == \
        jgood["post_reuse_mass_new_binary"] > 0
    assert all(good["bars"].values()), good["bars"]
    assert good["identity"]["reuse_detected_total"] == \
        jgood["identity"]["reuse_detected_total"] >= 2
    assert good["windows"] == bad["windows"] == 8


# -- the CLI ------------------------------------------------------------------


def _cli(capsys, *flags) -> tuple[int, dict, list]:
    code = cli.run(["--device", "cpu", "--http-address", "127.0.0.1:0",
                    "--capture", "synthetic",
                    "--aggregator", "dict", "--aggregator-capacity",
                    "1048576", "--windows", "2", "--profiling-duration",
                    "0.05", *flags])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    runtime = next(ln["runtime"] for ln in lines if "runtime" in ln)
    return code, runtime, [ln for ln in lines if "window" in ln]


def test_cli_observes_identity_unless_turned_off(capsys, monkeypatch):
    code, runtime, wins = _cli(capsys)
    assert code == 0 and len(wins) == 2
    # Synthetic pids have no /proc entry here: each check fails open.
    ident = runtime["process_identity"]
    assert ident["checks_total"] + ident["errors_total"] > 0
    code, runtime, _ = _cli(capsys, "--no-pid-generation")
    assert code == 0 and "process_identity" not in runtime
    monkeypatch.setenv("PARCA_NO_PID_GENERATION", "1")
    code, runtime, _ = _cli(capsys)
    assert code == 0 and "process_identity" not in runtime


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["process.identity", "symbolize.kernel"])
def test_cli_chaos_sites_fail_open(capsys, site):
    """--fault-inject at the identity check or at the kernel resolve
    costs the window nothing: both windows ship their whole mass and the
    run exits 0; the identity site's faults are counted."""
    code, runtime, wins = _cli(capsys, "--fault-inject", f"{site}:error")
    assert code == 0
    assert len(wins) == 2 and all(w["mass"] == w["samples"] for w in wins)
    assert all("symbolize_ms" in w for w in wins)
    if site == "process.identity":
        assert runtime["process_identity"]["errors_total"] == 2
        assert runtime["process_identity"]["checks_total"] == 0
