"""The port's runtime edges against parca_agent_tpu's, and the guards they
put on the card.

runtime/{trace,device_telemetry,quarantine,supervisor}.py are copies:
the same event sequences, on the same fake clocks the JAX tests use, go
through both packages' FlightRecorder, DeviceTelemetry (identity fields
aside), QuarantineRegistry and Supervisor, and the histograms, states,
strike counts and snapshots must be equal. runtime/device_health.py is
the port's subset (a bounded probe and a fault record, no CPU fallback
to demote to): its probe accounting is held against the original's.

Then the port's own edges: the device watchdog (a hung device call ends
the run, on the CLI with a bounded non-zero exit and the health
snapshot last), the inline encode's soft deadline (scalar profiles of
the card's counts), the streaming feeder's watchdog and cooldown, a
poisoned maps file sent down the quarantine ladder, the window trace's
spans and device telemetry's byte accounting on the dictionary.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.cpu import CPUAggregator as JaxCPU
from parca_agent_tpu.capture.live import \
    mapping_table_for_pids as jax_mapping_table_for_pids
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.runtime import device_health as jax_health
from parca_agent_tpu.runtime import device_telemetry as jax_dtel
from parca_agent_tpu.runtime import quarantine as jax_quarantine
from parca_agent_tpu.runtime import supervisor as jax_supervisor
from parca_agent_tpu.runtime import trace as jax_trace
from parca_agent_tpu.utils.poison import PoisonInput as JaxPoison
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.live import mapping_table_for_pids
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import parse_pprof
from parca_agent_tpu_torch.profiler import cpu as profiler_cpu
from parca_agent_tpu_torch.profiler.cpu import (
    CPUProfiler,
    DeviceHang,
    DeviceWatchdog,
)
from parca_agent_tpu_torch.profiler.streaming import StreamingWindowFeeder
from parca_agent_tpu_torch.runtime import device_health
from parca_agent_tpu_torch.runtime import device_telemetry as dtel
from parca_agent_tpu_torch.runtime import quarantine
from parca_agent_tpu_torch.runtime import supervisor
from parca_agent_tpu_torch.runtime import trace
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.bounded import bounded_call, device_wait
from parca_agent_tpu_torch.utils.poison import PoisonInput

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_global_state():
    yield
    faults.install(None)
    trace.install(None)
    dtel.install(None)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _snap(seed=7, n_pids=6, rows=200):
    return generate(SyntheticSpec(
        n_pids=n_pids, n_unique_stacks=rows, n_rows=rows,
        total_samples=rows * 4, mean_depth=8, kernel_fraction=0.25,
        seed=seed))


def _jsnap(seed=7, n_pids=6, rows=200):
    return jax_generate(JaxSpec(
        n_pids=n_pids, n_unique_stacks=rows, n_rows=rows,
        total_samples=rows * 4, mean_depth=8, kernel_fraction=0.25,
        seed=seed))


class ListSource:
    def __init__(self, snaps):
        self._snaps = list(snaps)

    def poll(self):
        return self._snaps.pop(0) if self._snaps else None


class Collect:
    def __init__(self):
        self.got = []

    def write(self, labels, blob):
        self.got.append((labels, bytes(blob)))


# -- the flight recorder ------------------------------------------------------

_CLOSE_MS = [4, 5, 6, 5, 4, 6, 5, 5, 4, 6, 400, 5, 7, 9000, 5]


def _drive_recorder(mod, incident_dir):
    rec = mod.FlightRecorder(ring=8, slow_multiple=3.0, min_count=4,
                             incident_dir=str(incident_dir),
                             incident_interval_s=10.0, clock=FakeClock(),
                             self_profile=lambda: b"self",
                             context=lambda: {"state": "ok"})
    for i, ms in enumerate(_CLOSE_MS):
        tr = rec.begin(time_ns=i)
        tr.add_span("drain", 0.002)
        tr.add_span("close", ms / 1e3)
        tr.add_span("statics", 0.3, histogram=False)
        tr.annotate(window=i)
        if i % 5 == 4:
            tr.detach()
            tr.finish(error="late")   # a detached trace is annotated
            tr.complete()
        else:
            tr.finish()
        rec.observe("statics", 0.01 * (i % 3 + 1))
        deadline = time.monotonic() + 10
        while rec._dumping and time.monotonic() < deadline:
            time.sleep(0.01)
    spare = rec.begin(time_ns=99)
    spare.discard()
    return rec


def _no_total(hists):
    return {k: v for k, v in hists.items() if k != "total"}


def test_flight_recorder_matches_parca_agent_tpus(tmp_path):
    """The same windows through both recorders: per-stage histograms
    (the real-time total aside), percentiles, stats, the ring's spans and
    the one rate-limited incident file agree."""
    port = _drive_recorder(trace, tmp_path / "port")
    jax = _drive_recorder(jax_trace, tmp_path / "jax")
    assert _no_total(port.export_histograms()) == \
        _no_total(jax.export_histograms())
    assert _no_total(port.percentiles()) == _no_total(jax.percentiles())
    assert port.stats == jax.stats
    assert port.stats["incidents_written"] == 1
    assert port.stats["incidents_suppressed"] >= 1

    def ring(rec):
        return [(t["seq"], t["complete"], t.get("meta"),
                 [(s["stage"], s["duration_s"], s.get("slow"))
                  for s in t["spans"] if s["stage"] != "total"])
                for t in rec.traces()]

    assert ring(port) == ring(jax)
    assert port.trace(15) == port.traces()[-1] and port.trace(1) is None
    files = {d: sorted((tmp_path / d).iterdir()) for d in ("port", "jax")}
    assert [f.name[25:] for f in files["port"]] == \
        [f.name[25:] for f in files["jax"]]
    a, b = (json.loads(files[d][0].read_text()) for d in ("port", "jax"))
    for k in ("kind", "stage", "duration_s", "budget_s", "context",
              "self_profile_pprof_gz_b64"):
        assert a[k] == b[k], k


@pytest.mark.chaos
@pytest.mark.parametrize("spec", ["trace.record:error",
                                  "trace.record:error:p=0.5"])
def test_trace_record_faults_are_swallowed_and_counted_alike(spec):
    from parca_agent_tpu.utils import faults as jax_faults

    counts = []
    for mod, fmod in ((trace, faults), (jax_trace, jax_faults)):
        fmod.install(fmod.FaultInjector.from_spec(spec, seed=3))
        try:
            rec = mod.FlightRecorder()
            for i in range(20):
                tr = rec.begin()
                tr.add_span("close", 0.001)
                tr.complete()
            counts.append(dict(rec.stats))
        finally:
            fmod.install(None)
    assert counts[0] == counts[1] and counts[0]["record_errors"] > 0


def test_incident_without_a_self_profiler_says_why(tmp_path, monkeypatch):
    """When the self-profiler fails, the incident says why (the default
    self-profile is profiler/selfprofile.py's profile_self)."""
    from parca_agent_tpu_torch.profiler import selfprofile

    def no_sampler(duration_s):
        raise RuntimeError("no sampler here")

    monkeypatch.setattr(selfprofile, "profile_self", no_sampler)
    rec = trace.FlightRecorder(incident_dir=str(tmp_path))
    tr = rec.begin()
    tr.add_span("close", 0.5)
    tr.complete()
    path = rec.flush_incident("device_hang", "close", {"error": "x"})
    body = json.loads(Path(path).read_text())
    assert body["kind"] == "device_hang" and body["detail"] == {"error": "x"}
    assert body["trace"]["seq"] == 1
    assert "no sampler here" in body["self_profile_error"]
    assert "self_profile_pprof_gz_b64" not in body
    assert trace.FlightRecorder().flush_incident("k", "s", {}) is None


def test_incident_carries_the_default_self_profile(tmp_path):
    """Without a self_profile callable the recorder samples the process
    itself for self_profile_s (profile_self), as the original does."""
    import base64
    import gzip

    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    rec = trace.FlightRecorder(incident_dir=str(tmp_path),
                               self_profile_s=0.05)
    tr = rec.begin()
    tr.add_span("close", 0.5)
    tr.complete()
    body = json.loads(Path(rec.flush_incident("device_hang", "close",
                                              {})).read_text())
    assert "self_profile_error" not in body
    prof = parse_pprof(gzip.decompress(
        base64.b64decode(body["self_profile_pprof_gz_b64"])))
    assert prof.sample_types == [("samples", "count"),
                                 ("cpu", "nanoseconds")]


def test_module_observe_feeds_the_installed_recorder():
    trace.observe("statics", 0.1)  # no recorder: free
    rec = trace.FlightRecorder()
    trace.install(rec)
    trace.observe("statics", 0.1)
    assert rec.percentiles()["statics"]["count"] == 1


# -- device telemetry ---------------------------------------------------------


def _drive_telemetry(mod, rec_mod):
    clock = FakeClock()
    rec = rec_mod.FlightRecorder()
    rec_mod.install(rec)
    try:
        t = mod.DeviceTelemetry(period_s=1.0, ring=16,
                                incident_interval_s=5.0, clock=clock)
        for i in range(6):
            clock.advance(0.5)
            t.record("feed_probe", 0.001 * (i + 1), shape=(1 << 12, 16),
                     h2d_bytes=256)
            t.record("close_pack", 0.0005, shape=(4096, 8))
            t.record("close_fetch", 0.0002, d2h_bytes=1024)
            t.record_transfer("miss_settle", "h2d", 96)
        t.record("feed_probe", 0.2, shape=(1 << 12, 32))  # new signature
        clock.advance(1.0)
        t.record("feed_probe", 0.2, shape=(1 << 12, 64))  # suppressed
        t.note_backend("feed_probe", requested="kernel", resolved="kernel")
        t.note_backend("feed_probe", interpret=False)
        t.tick_window(0.4)
        t.tick_window(1.5)
        worker = threading.Thread(
            target=t.record, args=("close_fetch", 0.3), kwargs={})
        worker.start()
        worker.join()
        t.tick_window(0.8)
        return t
    finally:
        rec_mod.install(None)


def test_device_telemetry_matches_parca_agent_tpus():
    """The same kernel events, transfers, backend notes and windows:
    snapshots (identity aside) and timelines equal; the first launch of
    each signature is the compile event, a new signature a recompile."""
    port = _drive_telemetry(dtel, trace)
    jax = _drive_telemetry(jax_dtel, jax_trace)
    a, b = port.snapshot(), jax.snapshot()
    a.pop("identity"), b.pop("identity")
    assert a == b
    assert port.timeline() == jax.timeline()
    k = a["kernels"]["feed_probe"]
    assert (k["compiles"], k["executes"], k["recompiles"]) == (3, 5, 2)
    assert a["transfers"]["feed_probe"]["h2d"] == {"bytes": 1536, "ops": 6}
    assert a["window_budget"]["windows_over_budget_total"] == 2
    assert a["stats"]["recompile_incidents"] == 0


def test_device_telemetry_identity_is_torchs():
    ident = dtel.DeviceTelemetry(device="cpu").ensure_identity()
    assert ident["platform"] == "cpu" and ident["device_kind"] == "cpu"
    assert ident["torch_version"] == torch.__version__
    assert ident["routes"]["feed_probe"] == "plain"
    assert set(ident["routes"]) >= {"feed_probe", "close_pack", "row_hash"}
    assert not any(k.startswith("jax") for k in ident)


@pytest.mark.chaos
def test_dictionary_reports_launches_and_bytes():
    """On the dictionary: the first feed of a padded shape is its
    compile event, the rest execute; H2D bytes are the packed buffers'
    sizes, D2H the fetched close buffers'; pprof bytes do not move with
    telemetry on, or with its chaos site failing every record."""
    snap = _snap(seed=3, rows=600)
    kept = []

    class Kept(DictAggregator):
        def _close_pack_collect(self, out_dev):
            host = super()._close_pack_collect(out_dev)
            kept.append(host.nbytes)
            return host

    def run():
        from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder

        agg = Kept(capacity=1 << 12, overflow="raise", device="cpu")
        enc = WindowEncoder(agg)
        out = []
        for w in range(3):
            for lo in (0, 300):
                agg.feed(snap, lo=lo, hi=lo + 300)
            c = agg.close_window()
            out.append([(p, bytes(b)) for p, b in enc.encode(
                c, snap.time_ns + w, snap.window_ns, snap.period_ns)])
        return out

    base = run()
    kept.clear()
    t = dtel.DeviceTelemetry(device="cpu")
    dtel.install(t)
    assert run() == base
    snap_t = t.snapshot()
    fp = snap_t["kernels"]["feed_probe"]
    assert fp["compiles"] == 1 and fp["executes"] == 5
    n_pad = 1 << (300 - 1).bit_length()
    assert snap_t["transfers"]["feed_probe"]["h2d"] == {
        "bytes": 6 * 4 * 4 * n_pad, "ops": 6}
    assert snap_t["transfers"]["close_fetch"]["d2h"] == {
        "bytes": sum(kept), "ops": len(kept)}
    assert snap_t["kernels"]["close_pack"]["compiles"] >= 1
    faults.install(faults.FaultInjector.from_spec("device.telemetry:error"))
    assert run() == base
    assert t.stats["record_errors"] > 0


# -- quarantine ---------------------------------------------------------------


def _drive_quarantine(mod, poison_cls):
    clock = FakeClock()
    reg = mod.QuarantineRegistry(max_strikes=2, quarantine_windows=2,
                                 probation_windows=1, escalate_after=1,
                                 healthy_after_windows=3, deadline_s=0.5,
                                 clock=clock)
    shots = []
    for w in range(14):
        if w in (0, 1, 2, 6, 9):
            reg.record_error(101, "maps.parse", poison_cls("bad maps"))
        if w == 4:
            t0 = reg.clock()
            clock.advance(0.8)
            reg.check_deadline(202, t0)
        if w == 5:
            reg.record_error(303, "maps.objfile", ValueError("elf"))
        if w == 11:
            reg.forget_pid(303)
        shots.append((reg.level(101), reg.is_quarantined(101),
                      reg.quarantined_pids(), reg.counts()))
        reg.tick_window()
    return reg, shots


def test_quarantine_registry_matches_parca_agent_tpus():
    port, shots = _drive_quarantine(quarantine, PoisonInput)
    jax, jshots = _drive_quarantine(jax_quarantine, JaxPoison)
    assert shots == jshots
    assert port.snapshot() == jax.snapshot()
    assert port.stats["trips_total"] >= 1
    assert port.stats["deadline_trips_total"] == 1


@pytest.mark.parametrize("level", [1, 2])
def test_ladder_matches_parca_agent_tpus(level):
    snap, jsnap = _snap(seed=5), _jsnap(seed=5)
    profs = CPUAggregator().aggregate(snap)
    jprofs = JaxCPU().aggregate(jsnap)
    reg = quarantine.QuarantineRegistry(max_strikes=0, escalate_after=1)
    jreg = jax_quarantine.QuarantineRegistry(max_strikes=0,
                                             escalate_after=1)
    victim = profs[1].pid
    for r in (reg, jreg):
        # The first trip rides the addresses level; a fault in the
        # probation after its cooldown re-trips it to the scalar level.
        r.record_error(victim, "maps.parse", ValueError("x"))
        if level == 2:
            for _ in range(3):
                r.tick_window()
            r.record_error(victim, "maps.parse", ValueError("x"))
    assert reg.level(victim) == jreg.level(victim) == level
    out = quarantine.apply_ladder(profs, reg)
    jout = jax_quarantine.apply_ladder(jprofs, jreg)
    assert len(out) == len(jout) == len(profs)
    for a, b in zip(out, jout):
        for f in ("pid", "stack_depths", "values", "loc_address",
                  "stack_loc_ids", "loc_mapping_id"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f
    assert reg.stats == jreg.stats
    assert sum(p.total() for p in out) == snap.total_samples()


class PoisonMaps:
    """Maps of every pid but one, whose maps file is poison."""

    def __init__(self, bad, cls):
        self.bad, self.cls = bad, cls

    def executable_mappings(self, pid):
        if pid == self.bad:
            e = self.cls("maps line 1: bad")
            e.site = "maps.parse"
            raise e
        return []


class NoObjs:
    def build_ids(self, per_pid):
        return {}

    def get(self, pid, m):
        return None


def test_poisoned_maps_file_rides_the_ladder_not_out_of_the_window():
    """With a registry a poisoned pid is charged and skipped, in both
    packages alike; without one the poison propagates (the original's
    contract too)."""
    reg = quarantine.QuarantineRegistry(max_strikes=1)
    jreg = jax_quarantine.QuarantineRegistry(max_strikes=1)
    for _ in range(3):
        t = mapping_table_for_pids(PoisonMaps(7, PoisonInput), NoObjs(),
                                   [5, 7, 9], quarantine=reg)
        jt = jax_mapping_table_for_pids(PoisonMaps(7, JaxPoison), NoObjs(),
                                        [5, 7, 9], quarantine=jreg)
        assert len(t.pids) == len(jt.pids) == 0
    assert reg.snapshot() == jreg.snapshot()
    assert reg.is_quarantined(7)
    with pytest.raises(PoisonInput):
        mapping_table_for_pids(PoisonMaps(7, PoisonInput), NoObjs(), [7])


# -- supervisor ---------------------------------------------------------------


def _drive_supervisor(mod):
    clock = FakeClock()
    sleeps = []
    sup = mod.Supervisor(max_restarts=3, backoff_initial_s=0.5,
                         backoff_max_s=2.0, healthy_after_s=30.0,
                         clock=clock, sleep=sleeps.append)
    state = {"crashes": 0, "healthy": True, "revived": 0}

    def flaky():
        if state["crashes"] < 2:
            state["crashes"] += 1
            raise RuntimeError(f"crash {state['crashes']}")

    def doomed():
        raise ValueError("always")

    def revive():
        state["revived"] += 1
        state["healthy"] = True

    sup.add_actor("flaky", run=flaky)
    sup.add_actor("doomed", run=doomed, critical=False)
    sup.add_probe("encode", check=lambda: state["healthy"], revive=revive,
                  critical=False)
    with pytest.raises(ValueError):
        sup.add_actor("flaky", run=flaky)
    sup.start()
    deadline = time.monotonic() + 10
    while not (sup.finished("flaky") and sup.finished("doomed")):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    health = [sup.health()]
    for healthy in (False, True, False):
        state["healthy"] = healthy
        sup.poll_probes()
        health.append(sup.health())
    clock.advance(31.0)
    health.append(sup.health())
    sup.stop(timeout_s=1.0)
    return sup, health, sorted(sleeps), state


def test_supervisor_matches_parca_agent_tpus():
    """Crash budgets, capped backoffs, probe revives and the health
    report: equal in both packages."""
    port, health, sleeps, state = _drive_supervisor(supervisor)
    jax, jhealth, jsleeps, jstate = _drive_supervisor(jax_supervisor)
    assert health == jhealth
    assert sleeps == jsleeps and state == jstate
    assert port.overall() == jax.overall()
    assert port.actor_restarts() == jax.actor_restarts() == {
        "flaky": 2, "doomed": 4, "encode": 2}
    assert health[0]["flaky"]["state"] == "exited"
    assert health[0]["doomed"]["state"] == "dead"


def test_device_hang_is_terminal_for_the_supervisor():
    sup = supervisor.Supervisor(sleep=lambda s: None)
    calls = []

    def hang():
        calls.append(1)
        raise DeviceHang("wedged")

    sup.add_actor("profiler", run=hang)
    sup.start()
    deadline = time.monotonic() + 5
    while not sup.finished("profiler"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert calls == [1] and sup.health()["profiler"]["state"] == "dead"
    assert sup.overall() == "dead"


# -- device health ------------------------------------------------------------


@pytest.mark.parametrize("outcome", ["ok", "fail", "raise"])
def test_probe_accounting_matches_parca_agent_tpus(outcome):
    def probe():
        if outcome == "raise":
            raise OSError("spawn")
        return outcome == "ok", "detail"

    port = device_health.DeviceHealthRegistry(probe=probe)
    assert port.run_probe() is (outcome == "ok")
    jax = jax_health.DeviceHealthRegistry(probe=probe)
    jax.start()
    deadline = time.monotonic() + 5
    while jax.snapshot()["probe_in_flight"]:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    keys = ("probes_total", "probes_ok", "probes_failed", "probes_hung",
            "hangs_total", "dispatch_errors_total")
    assert {k: port.stats[k] for k in keys} == \
        {k: jax.stats[k] for k in keys}
    assert port.state == ("healthy" if outcome == "ok" else "failed")


@pytest.mark.chaos
def test_probe_site_hang_is_bounded():
    faults.install(faults.FaultInjector.from_spec("device.probe:hang:ms=5000"))
    reg = device_health.DeviceHealthRegistry(
        probe=lambda: (True, "ok"), probe_deadline_s=0.2)
    t0 = time.monotonic()
    assert not reg.run_probe()
    assert time.monotonic() - t0 < 2.0
    assert reg.stats["probes_hung"] == reg.stats["probes_failed"] == 1
    assert reg.snapshot()["state"] == "failed"


def test_subprocess_probe_launches_the_row_hash_and_is_killed_at_its_bound():
    env_keep = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        assert device_health.subprocess_probe(120, "cpu") == (True, "ok")
        ok, detail = device_health.subprocess_probe(
            30, code="import time; time.sleep(60)")
        assert not ok
    finally:
        if env_keep is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_keep
    ok, detail = device_health.subprocess_probe(0.3,
                                                code="import time; "
                                                     "time.sleep(30)")
    assert not ok and "hung" in detail
    ok, detail = device_health.subprocess_probe(30, code="print(2)")
    assert not ok and "wrong output" in detail


def test_startup_probe_skips_the_cpu():
    from parca_agent_tpu_torch.cli import startup_probe

    reg = startup_probe(torch.device("cpu"), 60)
    assert reg.state == "healthy" and reg.stats["probes_total"] == 0


# -- the device watchdog ------------------------------------------------------


def test_watchdog_error_propagates_and_is_counted():
    reg = device_health.DeviceHealthRegistry()
    wd = DeviceWatchdog(5.0, reg)

    def boom():
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        wd.call(boom)
    assert reg.stats["dispatch_errors_total"] == 1
    assert reg.state == "healthy"
    assert wd.call(lambda: 7) == 7


def _stuck_on_card(release: threading.Event):
    """A call that waits on the card until ``release`` (a wedged fetch)."""
    with device_wait():
        release.wait(10)


def test_watchdog_hang_wedges_until_the_abandoned_call_returns():
    reg = device_health.DeviceHealthRegistry()
    wd = DeviceWatchdog(0.1, reg)
    release = threading.Event()
    with pytest.raises(DeviceHang):
        wd.call(lambda: _stuck_on_card(release))
    assert reg.snapshot()["state"] == "wedged"
    assert reg.stats["hangs_total"] == 1
    touched = []
    with pytest.raises(DeviceHang, match="still in flight"):
        wd.call(lambda: touched.append(1))
    assert not touched
    release.set()
    time.sleep(0.05)
    assert wd.call(lambda: 3) == 3
    assert wd.stats["abandoned_ok"] == 1


def test_watchdog_times_device_waits_not_host_work():
    """A host settle longer than the timeout between short device waits
    is not a hang (a cold window's miss settle); one device wait past it
    is."""
    reg = device_health.DeviceHealthRegistry()
    wd = DeviceWatchdog(0.2, reg)

    def settle():
        for _ in range(4):
            with device_wait():
                time.sleep(0.01)
            time.sleep(0.15)   # host work, 0.6 s in all
        return "settled"

    assert wd.call(settle) == "settled"
    assert wd.stats["hangs"] == 0 and reg.state == "healthy"

    def wedged():
        time.sleep(0.3)        # host work first: not timed
        with device_wait():
            time.sleep(1.0)

    t0 = time.monotonic()
    with pytest.raises(DeviceHang):
        wd.call(wedged)
    assert 0.45 < time.monotonic() - t0 < 0.9
    assert reg.stats["hangs_total"] == 1


def test_waits_only_bound_is_per_wait_and_thread_local():
    """Each wait gets the whole bound; a wait marked on another thread
    (not the bounded call's) is not this call's."""
    def call():
        for _ in range(3):
            with device_wait():
                time.sleep(0.12)
        return 1

    assert bounded_call(call, 0.2, waits_only=True)[0] == "ok"
    assert bounded_call(call, 0.2)[0] == "hang"
    with device_wait():        # no bounded call on this thread: a no-op
        pass


@pytest.mark.chaos
def test_dispatch_site_hang_ends_the_profiler_loop():
    faults.install(faults.FaultInjector.from_spec(
        "device.dispatch:hang:ms=3000"))
    reg = device_health.DeviceHealthRegistry()
    rec = trace.FlightRecorder()
    agg = DictAggregator(capacity=1 << 11, overflow="raise", device="cpu")
    prof = CPUProfiler(ListSource([_snap()] * 3), agg, encode_pipeline=False,
                       device_timeout_s=0.2, device_health=reg,
                       trace_recorder=rec, duration_s=0.0)
    with pytest.raises(DeviceHang):
        prof.run(3)
    assert isinstance(prof.crashed, DeviceHang)
    assert reg.stats["hangs_total"] == 1
    (tr,) = rec.traces()
    assert "DeviceHang" in tr["error"]


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


@pytest.mark.chaos
@pytest.mark.parametrize("fast", [True, False])
def test_cli_dispatch_hang_exits_bounded_with_the_health_snapshot(
        tmp_path, fast):
    """An injected device.dispatch hang: the CLI exits non-zero within
    the watchdog's 2 s plus start-up, the health snapshot on its last
    line and the incident file written; nothing later ran on the CPU."""
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--windows", "3",
         "--profiling-duration", "0.1", "--device-timeout", "2",
         "--fault-inject", "device.dispatch:hang:after=0",
         "--trace-incident-dir", str(tmp_path / "inc"),
         "--local-store-directory", str(tmp_path / "store"),
         *(("--fast-encode",) if fast else ())],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    wall = time.monotonic() - t0
    assert r.returncode == 1, r.stderr[-2000:]
    assert wall < 60
    last = json.loads(r.stdout.strip().splitlines()[-1])
    h = last["device_health"]
    assert h["state"] == "wedged" and h["stats"]["hangs_total"] == 1
    (inc,) = (tmp_path / "inc").iterdir()
    body = json.loads(inc.read_text())
    assert body["kind"] == "device_hang"
    assert body["context"]["device"]["state"] == "wedged"
    assert not list((tmp_path / "store").glob("*.pb.gz"))


def test_cli_runtime_summary_line(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--windows", "2", "--fast-encode",
         "--profiling-duration", "0.1",
         "--telemetry-ring", "32", "--trace-ring", "4",
         "--quarantine-max-strikes", "2", "--quarantine-windows", "2",
         "--quarantine-pid-deadline", "5"],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    assert [x["window"] for x in lines if "window" in x] == [1, 2]
    rt = lines[-1]["runtime"]
    assert rt["supervisor"]["profiler"]["state"] == "exited"
    assert rt["device"]["state"] == "healthy" and rt["device"]["windows"] == 2
    assert rt["trace"]["stats"]["traces_completed"] == 2
    assert {"drain", "close", "encode", "ship"} <= \
        set(rt["trace"]["stage_percentiles"])
    assert rt["device_telemetry"]["identity"]["platform"] == "cpu"
    assert rt["device_telemetry"]["kernels"]["feed_probe"]["compiles"] >= 1
    assert rt["device_telemetry"]["window_budget"]["windows_total"] == 2
    assert rt["quarantine"]["counts"]["quarantined"] == 0


# -- the inline encode's soft deadline ----------------------------------------


def test_encode_deadline_ships_scalar_profiles_of_the_cards_counts():
    snaps = [_snap(seed=s) for s in (1, 1, 1)]
    agg = DictAggregator(capacity=1 << 11, overflow="raise", device="cpu")
    writer = Collect()
    prof = CPUProfiler(ListSource(snaps), agg, profile_writer=writer,
                       encode_pipeline=False, encode_deadline_s=0.2)
    release = threading.Event()
    real = prof.encoder.encode

    def slow(*a, **kw):
        release.wait(10)
        return real(*a, **kw)

    prof.encoder.encode = slow
    assert prof.run_iteration()
    assert prof.metrics.encode_deadline_hits_total == 1
    want = {p.pid: p.total() for p in CPUAggregator().aggregate(snaps[0])}
    got = {}
    for labels, blob in writer.got:
        p = parse_pprof(blob)
        assert len(p.samples) == 1
        got[int(labels["pid"])] = p.samples[0][1][0]
    assert got == want
    # The abandoned encode still owns the encoder: scalar again.
    writer.got.clear()
    assert prof.run_iteration()
    assert prof.metrics.scalar_windows_total == 2 and len(writer.got) == 6
    release.set()
    time.sleep(0.2)
    writer.got.clear()
    prof.encoder.encode = real
    assert prof.run_iteration()
    assert prof.metrics.scalar_windows_total == 2
    assert sum(len(parse_pprof(b).samples) for _, b in writer.got) > 6


# -- the streaming feeder's watchdog ------------------------------------------


class FakeMaps:
    def executable_mappings(self, pid):
        return []


class FakeObjs:
    def build_ids(self, per_pid):
        return {}

    def get(self, pid, m):
        return None


def _cols(snap):
    return (snap.pids, snap.tids, snap.user_len, snap.kernel_len,
            snap.stacks, snap.counts)


def test_feeder_hang_is_abandoned_cools_down_and_reprobes():
    snap = _snap(seed=9)
    release = threading.Event()

    class Slow(DictAggregator):
        hold = True

        def feed(self, *a, **kw):
            if self.hold:
                _stuck_on_card(release)
            return super().feed(*a, **kw)

    agg = Slow(capacity=1 << 11, overflow="raise", device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs(),
                                   feed_timeout_s=0.05,
                                   first_feed_timeout_s=0.1)
    t0 = time.monotonic()
    feeder.on_drain(_cols(snap))
    assert time.monotonic() - t0 < 2.0
    assert feeder.stats["feed_hangs"] == 1 and feeder.disabled
    assert feeder.device_blocked()
    agg.hold = False
    release.set()
    assert feeder.wait_unblocked(10)
    want = agg.window_counts(snap).copy()
    for w in range(2):   # the cooldown's two windows re-aggregate
        feeder.on_drain(_cols(snap))
        assert feeder.take_window_if_complete(snap) is None
        assert np.array_equal(agg.window_counts(snap), want)
    assert feeder.stats["reprobes"] == 1 and not feeder.disabled
    feeder.on_drain(_cols(snap))
    assert np.array_equal(feeder.take_window_if_complete(snap), want)
    assert feeder.stats["windows_streamed"] == 1


def test_feeder_slow_host_settle_is_not_a_hang():
    """A feed whose host work outlasts feed_timeout_s streams: only its
    device waits are timed."""
    snap = _snap(seed=9)

    class SlowHost(DictAggregator):
        def feed(self, *a, **kw):
            time.sleep(0.3)
            return super().feed(*a, **kw)

    agg = SlowHost(capacity=1 << 11, overflow="raise", device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs(),
                                   feed_timeout_s=0.05,
                                   first_feed_timeout_s=0.05)
    feeder.on_drain(_cols(snap))
    assert feeder.stats["feed_hangs"] == 0 and not feeder.disabled
    counts = feeder.take_window_if_complete(snap)
    id_pid = np.asarray(agg._id_pid[:len(counts)])
    got = {pid: int(counts[id_pid == pid].sum())
           for pid in np.unique(id_pid).tolist()}
    want = {p.pid: p.total() for p in CPUAggregator().aggregate(snap)}
    assert got == want
    assert feeder.stats["windows_streamed"] == 1


def test_profiler_waits_out_an_abandoned_feed_before_the_close():
    snap = _snap(seed=2)
    release = threading.Event()

    class Slow(DictAggregator):
        def feed(self, *a, **kw):
            _stuck_on_card(release)
            return super().feed(*a, **kw)

    class TeeSource:
        def __init__(self, feeder):
            self.feeder, self.n = feeder, 0

        def poll(self):
            if self.n:
                return None
            self.n += 1
            self.feeder.on_drain(_cols(snap))
            threading.Timer(0.3, release.set).start()
            return snap

    agg = Slow(capacity=1 << 11, overflow="raise", device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs(),
                                   feed_timeout_s=0.05,
                                   first_feed_timeout_s=0.05)
    records = []
    prof = CPUProfiler(TeeSource(feeder), agg, encode_pipeline=False,
                       streaming_feeder=feeder, on_window=records.append,
                       device_timeout_s=10.0)
    assert prof.run_iteration()
    assert records[0]["mass"] == snap.total_samples()
    assert feeder.stats["feed_hangs"] == 1


# -- the window trace through the port's loop ---------------------------------


def test_profiler_traces_carry_the_mandatory_spans():
    rec = trace.FlightRecorder()
    agg = DictAggregator(capacity=1 << 12, overflow="raise", device="cpu")
    reg = quarantine.QuarantineRegistry()
    health = device_health.DeviceHealthRegistry()
    t = dtel.DeviceTelemetry(device="cpu")
    dtel.install(t)
    prof = CPUProfiler(ListSource([_snap(seed=s) for s in (1, 2, 3)]), agg,
                       trace_recorder=rec, quarantine=reg,
                       device_health=health)
    for _ in range(3):
        assert prof.run_iteration()
        prof.pipeline.flush(60)
    prof.close()
    traces = rec.traces()
    assert len(traces) == 3 and all(x["complete"] for x in traces)
    piped = [x for x in traces if x["meta"].get("path") == "pipeline"]
    assert piped
    for x in piped:
        assert set(jax_trace.MANDATORY_SPANS) <= \
            {s["stage"] for s in x["spans"]}
    assert health.windows == 3
    assert t.window_stats["windows_total"] == 3
    assert profiler_cpu.NULL_TRACE is trace.NULL_TRACE
