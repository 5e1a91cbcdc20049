"""The port's workload zoo (bench_zoo/) held to parca_agent_tpu's.

Every case of tests/test_zoo.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions, but for the
two outage cases: the port has no CPU aggregator to demote to and
recover from, so its outage rows score its own device health (a dispatch
hang raises DeviceHang within its bound and wedges the registry after
every earlier window shipped whole; a failed probe runs no window), and
those two cases assert that under their original names. Below them, the
same seeds go through both packages: the scenarios' windows are equal
byte for byte, and each scenario's row on each arm agrees in its digest,
per-window mass, shipped bytes and every bar but the wall-clock one. The
one exception is the original's encoder fault (ROADMAP.md C): after
pid_reuse's invalidations the original's long-lived window encoder
mis-encodes, and there the port is held to a fresh encoder's bytes.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    pkg,
    plain,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

from parca_agent_tpu_torch.bench_zoo import (  # noqa: E402
    OUTAGES,
    SCENARIOS,
    run_matrix,
    run_scenario,
)
from parca_agent_tpu_torch.bench_zoo import runner  # noqa: E402
from parca_agent_tpu_torch.runtime.device_health import (  # noqa: E402
    STATE_FAILED,
    STATE_WEDGED,
)

port_cases("test_zoo", globals(), replaced=(
    "test_matrix_runs_every_path_cadence_and_outage_row",
    "test_outage_probe_demotes_and_recovers_at_subsecond_cadence"))

pytestmark = pytest.mark.chaos

BOTH = ("jax", "port")
ARMS = ("scalar", "pipeline", "streaming")
# Wall-clock bars and fields: timing, never compared across packages.
TIMING_BARS = ("close_latency_ceiling",)
TIMING_KEYS = ("wall_s", "close_latency_max_s", "last_window_feed_s",
               "last_close_s")


def test_matrix_runs_every_path_cadence_and_outage_row():
    """The original's matrix case, on the port's outage contract: 3
    paths x 2 cadences + 1 outage x 2 cadences, one scenario; every
    row passes, the outage rows on the port's own bars."""
    m = run_matrix(11, scale=0.25, names=["pid_reuse"],
                   cadences=(10.0, 1.0), outages=("dispatch",))
    assert m["rows_total"] == 8
    assert m["passed"], [
        (r["scenario"], r["path"], r["window_s"], r["outage"],
         {k: v for k, v in r["bars"].items() if not v})
        for r in m["rows"] if not r["passed"]]
    cross = m["cross"][0]
    assert cross["bars"]["path_bytes_identical@10s"]
    assert cross["bars"]["path_bytes_identical@1s"]
    assert cross["bars"]["path_mass_identical@10s"]
    assert cross["bars"]["path_mass_identical@1s"]
    assert cross["bars"]["cadence_digest_identical"]
    outage_rows = [r for r in m["rows"] if r["outage"] == "dispatch"]
    assert len(outage_rows) == 2
    for r in outage_rows:
        assert r["device_state"] == STATE_WEDGED
        assert r["bars"]["outage_hang_bounded"], r["hang_s"]
        assert r["bars"]["windows_before_hang_shipped"]
        assert "outage_recovered" not in r["bars"]


def test_outage_probe_demotes_and_recovers_at_subsecond_cadence():
    """The original's probe case, on the port's contract: a hung
    bring-up probe leaves the registry failed and, as the CLI stops
    there, no window runs — there is no CPU path to demote to."""
    row = run_scenario("fork_storm", 23, scale=0.25, outage="probe",
                       window_s=1.0)
    assert row["passed"], row["bars"]
    assert row["bars"]["outage_injected"]
    assert row["bars"]["outage_failed"]
    assert row["bars"]["no_window_ran"]
    assert row["device_state"] == STATE_FAILED
    assert row["device_health"]["probes_hung"] == 1
    assert row["windows_lost"] == 0
    assert row["profiles_written"] == 0


# -- the port's outage contract ----------------------------------------------


@pytest.mark.parametrize("window_s", [10.0, 1.0])
@pytest.mark.parametrize("scenario", ["kernel_heavy", "tenant_burst"])
def test_dispatch_hang_ends_the_row_bounded_after_whole_windows(
        scenario, window_s):
    row = run_scenario(scenario, 17, scale=0.25, outage="dispatch",
                       window_s=window_s)
    assert row["passed"], row["bars"]
    n = row["hang_window"]
    assert n == row["windows"] // 2
    # DeviceHang within the watchdog's bound plus the stated margin.
    assert row["hang_s"] <= (runner._OUTAGE_DEVICE_TIMEOUT_S
                             + runner.OUTAGE_HANG_MARGIN_S)
    assert row["device_state"] == STATE_WEDGED
    assert row["device_health"]["hangs_total"] == 1
    # Every window before the hang closed and shipped with its mass.
    assert row["windows_closed"] == n and len(row["mass_by_window"]) == n
    assert row["samples_shipped"] == row["samples_fed"] > 0
    assert row["windows_lost"] == 0


def test_no_cpu_aggregator_on_the_zoo_or_the_soak(monkeypatch):
    """The zoo's arms, its outage rows and the soak never build a CPU
    aggregator: the dictionary is the only aggregation."""
    from parca_agent_tpu_torch.aggregator import cpu as cpu_agg
    from parca_agent_tpu_torch.bench_zoo import run_soak

    def refuse(*a, **k):
        raise AssertionError("a CPU aggregator was built")

    monkeypatch.setattr(cpu_agg.CPUAggregator, "__init__", refuse)
    for path in ARMS:
        assert run_scenario("deep_stacks", 5, scale=0.25,
                            path=path)["passed"]
    for outage in OUTAGES:
        assert run_scenario("deep_stacks", 5, scale=0.25,
                            outage=outage)["passed"]
    assert run_soak(wall_s=1.0, seed=3, scale=0.25,
                    rss_slope_limit=1 << 20,
                    lane_slope_limit=1 << 16)["passed"]


def test_outage_rows_need_a_known_outage():
    with pytest.raises(ValueError):
        run_scenario("pid_reuse", 3, scale=0.25, outage="ladder")


# -- the two packages on the same seeds -------------------------------------


def _windows(which, name, seed, scale):
    scn = pkg(which, "bench_zoo.scenarios").SCENARIOS[name]()
    built = scn.build(seed, scale)
    return scn, built


@pytest.mark.parametrize("scale", [0.25, 1.0])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_parity_scenario_windows_byte_for_byte(name, scale):
    """Each scenario's windows: the snapshots (every array, the mapping
    table, the time), the procfs files, the starttimes, the degraded
    flag, the truth and the config, equal in both packages."""
    out = {}
    for which in BOTH:
        scn, built = _windows(which, name, 7, scale)
        out[which] = (
            [(plain(zw.snapshot), zw.files, zw.starttimes, zw.degraded)
             for zw in built],
            plain(scn.truth), scn.config(scale), scn.windows(scale),
            scn.axis)
    assert out["jax"] == out["port"]


def test_parity_schedules_and_helpers():
    a, b = (pkg(which, "bench_zoo") for which in BOTH)
    for seed in (0, 5, 99, 2**31 - 1):
        assert a.build_schedule(seed) == b.build_schedule(seed)
        assert a.build_schedule(seed, ["pid_reuse", "jit_churn"]) \
            == b.build_schedule(seed, ["pid_reuse", "jit_churn"])
    assert a.PATHS == b.PATHS and a.CADENCES == b.CADENCES \
        and a.OUTAGES == b.OUTAGES
    ra, rb = (pkg(which, "bench_zoo.runner") for which in BOTH)
    assert ra.DEFAULT_CLOSE_CEILING_S == rb.DEFAULT_CLOSE_CEILING_S
    for cfg in ({}, {"admission": {"quota_samples": 3000}},
                {"quarantine": {"max_strikes": 1, "quarantine_windows": 3}}):
        for w in (10.0, 1.0, 0.5):
            assert ra._wall_equivalent(cfg, w) == rb._wall_equivalent(cfg, w)


def _comparable(row):
    """A row without its wall-clock bars and fields (and its verdict,
    which reads them: the original's first window may pay a compile)."""
    out = {k: v for k, v in row.items()
           if k not in TIMING_KEYS and k not in ("bars", "device", "passed")}
    out["bars"] = {k: v for k, v in row["bars"].items()
                   if k not in TIMING_BARS}
    if "streaming" in out:
        out["streaming"] = {k: v for k, v in out["streaming"].items()
                            if k in ("windows_streamed", "path_fallbacks")}
    return out


# The original's encoder fault: its long-lived window encoder keeps its
# per-id mirrors across pid_reuse's invalidation compactions (ROADMAP.md
# C), so its fast arms' bytes differ from the reuse window on.
FAULTY = {("pid_reuse", "pipeline"), ("pid_reuse", "streaming")}


@pytest.mark.parametrize("path", ARMS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_parity_rows_per_scenario_and_arm(name, path):
    """Each scenario on each arm at scale 0.25, seed 11: the digest (but
    the pipeline's, which tags each ship with the window the loop had
    polled when the worker wrote it: timing), per-window mass, shipped
    (pid, sha256) sequence, scenario truth and registry stats, and every
    non-timing bar, equal in both packages."""
    rows = {}
    for which in BOTH:
        kw = {} if which == "jax" else {"device": "cpu"}
        rows[which] = pkg(which, "bench_zoo").run_scenario(
            name, 11, scale=0.25, path=path, **kw)
    jax_row, port_row = (_comparable(rows[w]) for w in BOTH)
    assert rows["port"]["passed"], rows["port"]["bars"]
    if (name, path) in FAULTY:
        # Held to a fresh encoder instead (the test below).
        for row in (jax_row, port_row):
            row.pop("shipped_seq")
            row.pop("digest")
    elif path == "pipeline":
        for row in (jax_row, port_row):
            row.pop("digest")
    assert jax_row == port_row


def test_pid_reuse_fast_arms_hold_the_port_to_a_fresh_encoder(monkeypatch):
    """pid_reuse invalidates the reused pids at the reuse window, a
    compaction that remaps ids. The original's long-lived encoder keeps
    its stale mirrors and mis-encodes every window from there on; with
    its encoder reset before each window (a fresh encoder's bytes) the
    original ships exactly the port's sequence, on both fast arms."""
    port = {path: run_scenario("pid_reuse", 11, scale=0.25, path=path)
            for path in ("pipeline", "streaming")}
    jax_zoo = pkg("jax", "bench_zoo")
    faulty = jax_zoo.run_scenario("pid_reuse", 11, scale=0.25,
                                  path="streaming")
    enc = pkg("jax", "pprof.window_encoder").WindowEncoder
    encode = enc.encode

    def fresh(self, *a, **k):
        self.reset()
        return encode(self, *a, **k)

    monkeypatch.setattr(enc, "encode", fresh)
    fresh_row = jax_zoo.run_scenario("pid_reuse", 11, scale=0.25,
                                     path="streaming")
    want = fresh_row["shipped_seq"]
    assert port["streaming"]["shipped_seq"] == want
    assert port["pipeline"]["shipped_seq"] == want
    # The fault shows exactly from the reuse window on: 4 profiles a
    # window (2 reused pids, 2 bystanders).
    reuse_w = pkg("jax", "bench_zoo.scenarios").PidReuseScenario.REUSE_W
    per_w = len(want) // faulty["windows"]
    differ = [i for i, (a, b) in enumerate(zip(faulty["shipped_seq"], want))
              if a != b]
    assert differ and min(differ) >= reuse_w * per_w
    assert faulty["mass_by_window"] == fresh_row["mass_by_window"] \
        == port["streaming"]["mass_by_window"]


@pytest.mark.parametrize("path", ["scalar", "streaming"])
def test_parity_chaos_rows(path):
    """The zoo's chaos sites through both packages: zoo.scenario
    degrades every build alike; zoo.path falls the streaming arm open to
    window_counts alike (the same fallbacks, mass and bytes)."""
    site = "zoo.scenario:error:p=0.5" if path == "scalar" \
        else "zoo.path:error:count=2"
    rows = {}
    for which in BOTH:
        faults = pkg(which, "utils.faults")
        faults.install(faults.FaultInjector.from_spec(site, seed=42))
        try:
            kw = {} if which == "jax" else {"device": "cpu"}
            rows[which] = pkg(which, "bench_zoo").run_scenario(
                "kernel_heavy", 17, scale=0.25, path=path, **kw)
        finally:
            faults.install(None)
    assert _comparable(rows["jax"]) == _comparable(rows["port"])
    if path == "scalar":
        assert 0 < rows["port"]["degraded_builds"] < rows["port"]["windows"]
    else:
        assert rows["port"]["streaming"]["path_fallbacks"] == 2


def test_parity_run_zoo_sweep():
    """The scalar sweep: schedule, and each row's digest, mass and
    non-timing bars, equal in both packages."""
    out = {}
    for which in BOTH:
        kw = {} if which == "jax" else {"device": "cpu"}
        z = pkg(which, "bench_zoo").run_zoo(5, scale=0.25, **kw)
        out[which] = (z["schedule"], z["scenarios_total"],
                      [_comparable(r) for r in z["rows"]])
    assert out["jax"] == out["port"]
