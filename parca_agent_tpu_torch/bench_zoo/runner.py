"""Workload-zoo runner: score scenarios through the port's window loop.

The port's copy of parca_agent_tpu/bench_zoo/runner.py. No simulation
shortcuts: every scenario's windows flow through a live window loop
with the production components wired the way the port's cli.py wires
them — DictAggregator on ``device`` (the card unless the caller asks
for the CPU), Symbolizer over a PerfMapCache + KsymCache on the
scenario's FakeFS, quarantine registry, admission controller with its
TenantResolver reading the scenario's fake cgroups, and the
generation-stamped ProcessIdentityTracker with the same invalidator set
the CLI registers. The scenario only supplies the WORLD: snapshots,
procfs files, and per-pid starttimes, mutated window by window exactly
as a hostile host would mutate them under the agent.

Three axes beyond the scenario itself (``run_matrix``):

* **path** — the same windows ride the scalar close path (``scalar``:
  ``AggregateLoop``, the CLI without --fast-encode), the fast-encode
  pipeline (``pipeline``: ``CPUProfiler`` with window_counts +
  vectorized encoder + encode worker), or a streaming feeder with the
  carry cache (``streaming``: chunked ``feed`` + packed close over a
  carry-enabled dict). The fast arms must ship byte-identical pprof
  sequences and all three must conserve the same per-window mass.
* **cadence** — every row re-runs at a sub-second window
  (``window_s=1.0``). Scenario knobs are authored at the reference
  10 s window, so the runner scales them to their wall-time-equivalent
  values (:func:`_wall_equivalent`) and the registries' own
  window_clock conversion restores the exact per-window numbers; a
  compensated run therefore must make identical per-window decisions,
  and the scalar digest must be bit-identical across cadences.
* **outage** — scalar rows re-run under the port's device health
  (runtime/device_health.py) while a mid-run ``device.dispatch`` hang
  or a hung bring-up ``device.probe`` is injected. The port has no CPU
  aggregator to demote to, so the row scores the port's contract, not
  the original's demote-and-recover ladder: a dispatch hang raises
  DeviceHang within ``device_timeout_s`` plus a stated margin, the
  registry ends wedged with the hang counted, and every window closed
  before the hang shipped with its mass conserved; a failed probe
  leaves the registry failed and runs no window (the CLI stops there).

Scoring: every row carries the base bars (windows_lost == 0, sample
mass conserved end to end, close-latency ceiling) plus the scenario's
own (reuse detected, abuser quarantined, byte identity, ...); outage
rows carry the outage bars in place of the whole-run ones. A row
passes only if every bar holds; ``run_zoo`` is the scalar sweep,
``run_matrix`` the full path x cadence x outage cross-product.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np

from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.bench_zoo.scenarios import (
    SCENARIOS, Scenario, ZooWindow, build_schedule)
from parca_agent_tpu_torch.process.identity import ProcessIdentityTracker
from parca_agent_tpu_torch.profiler.cpu import (
    AggregateLoop, CPUProfiler, DeviceHang)
from parca_agent_tpu_torch.runtime.admission import (
    AdmissionController, TenantResolver)
from parca_agent_tpu_torch.runtime.device_health import (
    DeviceHealthRegistry, STATE_FAILED, STATE_WEDGED)
from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
from parca_agent_tpu_torch.symbolize.ksym import KsymCache
from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache
from parca_agent_tpu_torch.symbolize.symbolizer import Symbolizer
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import FakeFS
from parca_agent_tpu_torch.utils.window_clock import (
    REFERENCE_WINDOW_S, check_window_s)

# Per-scenario close-latency ceiling (seconds). The zoo runs tiny
# windows; a close that takes longer than this is a regression even on
# a loaded host. Wall time: a process's first launches (the CUDA
# context, each kernel library's load) belong to a warm-up before the
# zoo, never to a row.
DEFAULT_CLOSE_CEILING_S = 2.0

# The three close paths every scenario must survive.
PATHS = ("scalar", "pipeline", "streaming")

# Reference cadence plus the 10x sub-second re-run.
CADENCES = (REFERENCE_WINDOW_S, 1.0)

# Mid-run device faults (faults.py SITES) each scenario is crossed with.
OUTAGES = ("dispatch", "probe")

# Outage-row device watchdog: it bounds each of a window's waits on the
# card (utils/bounded.py device_wait), so the injected dispatch hang
# must overrun it and a real zoo window's waits (milliseconds on these
# snapshots, once the warm-up has loaded every kernel) must not.
_OUTAGE_DEVICE_TIMEOUT_S = 0.5
_OUTAGE_HANG_MS = 2000
# The stated margin on the hang's bound: DeviceHang must leave the
# hung iteration within the watchdog's timeout plus this (the watchdog
# looks at its open wait every 0.1 s; the rest is a loaded host's
# scheduling).
OUTAGE_HANG_MARGIN_S = 1.0
# The bring-up probe's deadline in the probe rows: the injected hang
# overruns it at once.
_OUTAGE_PROBE_DEADLINE_S = 0.05

# The scenario knob names AdmissionController/QuarantineRegistry treat
# as wall-time window counts vs per-reference-window rates, with the
# constructor defaults repeated here: wall-equivalence must scale the
# DEFAULTED values too, or a compensated sub-second run would make
# different per-window decisions than the reference run.
_ADMISSION_DEFAULTS = {
    "quota_samples": 0, "quota_pids": 0, "burst_windows": 3,
    "degrade_after": 2, "escalate_after": 3, "recover_windows": 3,
    "storm_new_pids": 0,
}
_ADMISSION_WINDOW_KNOBS = ("burst_windows", "degrade_after",
                           "escalate_after", "recover_windows")
_ADMISSION_RATE_KNOBS = ("quota_samples", "quota_pids", "storm_new_pids")
_QUARANTINE_DEFAULTS = {
    "quarantine_windows": 3, "max_quarantine_windows": 60,
    "probation_windows": 2, "healthy_after_windows": 6,
}


def _wall_equivalent(cfg: dict, window_s: float) -> tuple[dict, dict]:
    """Scale a scenario's reference-cadence knobs to wall-time-equivalent
    values at ``window_s``. Window-count knobs shrink by window_s/10 and
    rate knobs grow by 10/window_s, so the registries' own window_clock
    conversion restores the exact per-window numbers — the compensated
    run is the SAME run at a different tick rate, which is exactly what
    the cadence-invariance bar needs to hold. Per-event knobs
    (max_strikes, escalate trip counts) pass through untouched."""
    scale_w = window_s / REFERENCE_WINDOW_S
    adm = dict(_ADMISSION_DEFAULTS)
    adm.update(cfg.get("admission", {}))
    for k in _ADMISSION_WINDOW_KNOBS:
        adm[k] = adm[k] * scale_w
    for k in _ADMISSION_RATE_KNOBS:
        adm[k] = adm[k] / scale_w
    adm["window_s"] = window_s
    qua = dict(_QUARANTINE_DEFAULTS)
    qua.update(cfg.get("quarantine", {}))
    for k in _QUARANTINE_DEFAULTS:
        qua[k] = qua[k] * scale_w
    qua["window_s"] = window_s
    return adm, qua


class _ZooSource:
    """Capture source over a scenario's window stream: applies each
    window's world mutations (procfs files, starttimes) BEFORE handing
    the snapshot over, exactly as the real world mutates under a poll."""

    def __init__(self, windows: list[ZooWindow], fs: FakeFS,
                 world: dict[int, int]):
        self._windows = windows
        self._fs = fs
        self._world = world
        self.current = -1

    def poll(self):
        i = self.current + 1
        if i >= len(self._windows):
            return None
        zw = self._windows[i]
        for path in sorted(zw.files):
            self._fs.put(path, zw.files[path])
        self._world.update(zw.starttimes)
        self.current = i
        return zw.snapshot


class _ZooWriter:
    """Profile sink recording (window, labels, pprof bytes) triples."""

    def __init__(self, source: _ZooSource):
        self._source = source
        self.shipped: list[tuple[int, dict, bytes]] = []

    def write(self, labels: dict, blob: bytes) -> None:
        # bytes() copy: the fast-encode arms ship views into the
        # encoder's reusable buffers, which later windows overwrite.
        self.shipped.append((self._source.current, dict(labels),
                             bytes(blob)))


class _RecordingAggregator:
    """Transparent DictAggregator proxy that keeps each window's
    pre-ladder profile objects for scoring (the loop ships the same
    objects, so symbolization results are visible here too). Entries are
    also tagged with the window the call was DISPATCHED for: an
    abandoned (hung) device aggregate completes late, after the source
    advanced, and must not be misattributed to a later window."""

    def __init__(self, inner: DictAggregator,
                 source: _ZooSource | None = None):
        self._inner = inner
        self._zoo_source = source
        self.windows: list[list] = []
        self.tagged: list[tuple[int, list]] = []

    def aggregate(self, snapshot):
        w = self._zoo_source.current if self._zoo_source is not None else -1
        profiles = self._inner.aggregate(snapshot)
        self.windows.append(list(profiles))
        self.tagged.append((w, list(profiles)))
        return profiles

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _RecordingDict(DictAggregator):
    """DictAggregator whose one-shot closes record per-window mass. The
    fast arms never materialize PidProfile objects, so this tap (plus
    the streaming feeder's) is where their mass-conservation bar reads
    from. A real subclass, not a proxy: the WindowEncoder reads
    aggregator internals directly."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.zoo_source: _ZooSource | None = None
        self.mass_by_window: dict[int, int] = {}

    def window_counts(self, snapshot, hashes=None):
        counts = super().window_counts(snapshot, hashes)
        w = self.zoo_source.current if self.zoo_source is not None else -1
        self.mass_by_window[w] = (self.mass_by_window.get(w, 0)
                                  + int(np.asarray(counts).sum()))
        return counts


class _ZooStreamFeeder:
    """Minimal streaming feeder for the zoo's streaming-carry arm: each
    polled snapshot is fed to the (carry-enabled) aggregator in
    drain-sized chunks — the carry cache and the coalesce fold see a
    multi-drain window, like the production tee does — and the window
    closes packed at take_window_if_complete. The chunked path is a
    chaos site (``zoo.path``): an injected fault is counted
    (path_fallbacks), the open window is discarded, and None hands the
    window to the loop, which re-aggregates it with window_counts on the
    same aggregator (the same device) — same mass, never a lost window.
    The attach/block hooks are the loop's feeder protocol
    (profiler/streaming.py); this feeder feeds on the loop's own thread,
    so it never blocks and prebuilds nothing."""

    CHUNKS = 4

    def __init__(self, agg: DictAggregator, source):
        self._agg = agg
        self._source = source
        self.mass_by_window: dict[int, int] = {}
        self.stats = {"windows_streamed": 0, "path_fallbacks": 0,
                      "last_window_streamed": 0,
                      "last_window_feed_s": 0.0, "last_close_s": 0.0}

    def attach_encoder(self, encoder, prebuild=None) -> None:
        pass

    def device_blocked(self) -> bool:
        return False

    def wait_unblocked(self) -> None:
        pass

    def _chunk_bounds(self, pids) -> list[int]:
        """Drain boundaries that never split a pid's row run: per-pid
        location registration is batch-local (np.unique order inside
        each feed), so a pid fed across two drains would register its
        locations in a different order than the one-shot close and
        break the cross-arm byte-identity bar. Zoo snapshots group rows
        by pid; if a pid ever appeared in two runs the window degrades
        to a single drain rather than ship divergent bytes."""
        n = len(pids)
        edges = [i for i in range(1, n) if pids[i] != pids[i - 1]]
        if len(edges) + 1 != len(set(pids)):
            return [0, n]
        bounds = [0]
        for k in range(1, self.CHUNKS):
            target = round(k * n / self.CHUNKS)
            best = min(edges, key=lambda e: abs(e - target), default=None)
            if best is not None and best > bounds[-1]:
                bounds.append(best)
        bounds.append(n)
        return bounds

    def take_window_if_complete(self, snapshot):
        t0 = time.perf_counter()
        self.stats["last_window_streamed"] = 0
        n = int(np.asarray(snapshot.counts).shape[0])
        if n == 0:
            return None  # nothing streamed: window_counts owns it
        try:
            faults.inject("zoo.path")
            bounds = self._chunk_bounds(
                np.asarray(snapshot.pids).tolist())
            for lo, hi in zip(bounds, bounds[1:]):
                self._agg.feed(snapshot, lo=lo, hi=hi)
            t1 = time.perf_counter()
            counts = self._agg.close_window(copy=True)
        except Exception:  # noqa: BLE001 - fail-open: window_counts path
            self.stats["path_fallbacks"] += 1
            self._agg.discard_open_window()
            return None
        self.stats["windows_streamed"] += 1
        self.stats["last_window_streamed"] = 1
        self.stats["last_close_s"] = time.perf_counter() - t1
        self.stats["last_window_feed_s"] = t1 - t0
        w = self._source.current
        self.mass_by_window[w] = (self.mass_by_window.get(w, 0)
                                  + int(np.asarray(counts).sum()))
        return counts


@dataclasses.dataclass
class RunContext:
    """Everything a scenario's check() may inspect after the run."""

    profiles_by_window: list[list]
    shipped: list[tuple[int, dict, bytes]]
    truth: dict
    aggregator: DictAggregator
    identity: ProcessIdentityTracker
    admission: AdmissionController
    quarantine: QuarantineRegistry
    resolver: TenantResolver
    perf: PerfMapCache


def _digest(ctx: RunContext) -> str:
    """Canonical run digest: the seeded-determinism handle. Covers the
    scored substance (per-window profile tables + shipped bytes), never
    wall-clock measurements."""
    h = hashlib.sha256()
    for w, profs in enumerate(ctx.profiles_by_window):
        for p in sorted(profs, key=lambda p: p.pid):
            h.update(repr((
                w, p.pid, p.values.tolist(),
                p.stack_loc_ids[:, :8].tolist(), p.stack_depths.tolist(),
                p.loc_address.tolist(), p.loc_normalized.tolist(),
                p.loc_mapping_id.tolist(),
                [(m.id, m.path, m.start) for m in p.mappings],
                sorted(f[0] for f in p.functions),
            )).encode())
    for w, labels, blob in ctx.shipped:
        h.update(repr((w, sorted(labels.items()))).encode())
        h.update(hashlib.sha256(blob).digest())
    return h.hexdigest()


def _shipped_seq(shipped) -> list[tuple[str, str]]:
    """Cross-arm byte-identity handle: the ordered (pid, blob sha)
    sequence. Window indices are deliberately excluded — the encode
    pipeline ships asynchronously, so the writer's window tag can lag a
    ship, but FIFO ordering makes the sequence itself comparable."""
    return [(labels.get("pid", ""), hashlib.sha256(blob).hexdigest())
            for _w, labels, blob in shipped]


def run_scenario(scenario, seed: int, scale: float = 1.0,
                 hardened: bool | None = None, path: str = "scalar",
                 window_s: float = REFERENCE_WINDOW_S,
                 outage: str | None = None,
                 device: str = "cuda") -> dict:
    """One matrix row: build the scenario's windows, drive them through
    the port's window loop on the requested close ``path`` at the
    requested cadence, its dictionary on ``device``, and score against
    the bars. ``hardened`` None follows PARCA_NO_PID_GENERATION (the
    control-arm pin); ``outage`` (scalar path only) injects a device
    fault and scores the port's device-health contract."""
    scn: Scenario = (SCENARIOS[scenario]()
                     if isinstance(scenario, str) else scenario)
    if hardened is None:
        hardened = os.environ.get("PARCA_NO_PID_GENERATION", "") != "1"
    if path not in PATHS:
        raise ValueError(f"unknown zoo path {path!r} (want one of {PATHS})")
    if outage is not None and outage not in OUTAGES:
        raise ValueError(f"unknown outage {outage!r} "
                         f"(want one of {OUTAGES})")
    if outage is not None and path != "scalar":
        raise ValueError("outage rows run the scalar close path (the "
                         "guarded device dispatch)")
    check_window_s(window_s)
    windows = scn.build(seed, scale)
    cfg = scn.config(scale)
    adm_kwargs, qua_kwargs = _wall_equivalent(cfg, window_s)

    fs = FakeFS()
    world: dict[int, int] = {}
    resolver = TenantResolver(fs=fs)
    admission = AdmissionController(resolver, **adm_kwargs)
    quarantine = QuarantineRegistry(**qua_kwargs)
    perf = PerfMapCache(fs=fs, churn_budget=int(cfg.get("churn_budget", 8)))
    ksym = None
    if cfg.get("kallsyms"):
        fs.put("/proc/kallsyms", cfg["kallsyms"])
        ksym = KsymCache(fs=fs)
    identity = ProcessIdentityTracker(
        starttime_of=world.__getitem__, enabled=hardened)
    # The same invalidator set cli.py registers: every bare-pid cache
    # drops the dead generation's state on a starttime mismatch.
    identity.add_invalidator("quarantine", quarantine.forget_pid)
    identity.add_invalidator("tenant", resolver.forget)
    identity.add_invalidator("perfmap", perf.evict)

    source = _ZooSource(windows, fs, world)
    writer = _ZooWriter(source)

    agg = None            # scalar arms: recording proxy over the dict
    fastagg = None        # fast arms: recording DictAggregator subclass
    feeder = None
    health = None
    loop_kwargs: dict = {}
    if path == "scalar":
        symbolizer = Symbolizer(ksym=ksym, perf=perf,
                                quarantine=quarantine, admission=admission)
        inner = DictAggregator(capacity=1 << 14, device=device)
        agg = _RecordingAggregator(inner, source=source)
        identity.add_invalidator("aggregator", inner.invalidate_pid)
        if outage is not None:
            # The registry under test: no probe for the dispatch rows
            # (the card is trusted at once), a probe the injected hang
            # overruns for the probe rows.
            health = DeviceHealthRegistry(
                probe=(lambda: (True, "ok")) if outage == "probe" else None,
                probe_deadline_s=_OUTAGE_PROBE_DEADLINE_S)
            loop_kwargs = {"device_health": health,
                           "device_timeout_s": _OUTAGE_DEVICE_TIMEOUT_S}
        profiler = AggregateLoop(
            source, agg, symbolizer=symbolizer, profile_writer=writer,
            quarantine=quarantine, admission=admission, identity=identity,
            **loop_kwargs)
    else:
        # Fast arms ship unsymbolized (the fast-encode contract); the
        # streaming arm additionally exercises the carry cache across
        # chunked drains. An arm that cannot close its window on its own
        # path has failed the row.
        fastagg = _RecordingDict(capacity=1 << 14,
                                 carry=(path == "streaming"), device=device)
        fastagg.zoo_source = source
        identity.add_invalidator("aggregator", fastagg.invalidate_pid)
        if path == "streaming":
            feeder = _ZooStreamFeeder(fastagg, source)
        profiler = CPUProfiler(
            source, fastagg, profile_writer=writer,
            quarantine=quarantine, admission=admission, identity=identity,
            streaming_feeder=feeder, encode_pipeline=(path == "pipeline"))

    if outage == "dispatch" and windows:
        # Outage rows bound every device wait at _OUTAGE_DEVICE_TIMEOUT_S:
        # each window shape's first launches (the kernel libraries' load
        # on the card) go to a throwaway dict first, so no real window
        # reads as a hang.
        warm = DictAggregator(capacity=1 << 14, device=device)
        for w in windows:
            warm.window_counts(w.snapshot)

    hang_at = (max(1, len(windows) // 2)
               if outage == "dispatch" else None)
    hang_s = None
    probe_ok = None
    prior_injector = faults.get()
    close_lat: list[float] = []
    t0 = time.perf_counter()
    try:
        if outage == "probe":
            # The CLI's bring-up: a failed probe stops the agent before
            # its first window, so a failed probe row runs none.
            faults.install(faults.FaultInjector.from_spec(
                f"device.probe:hang:ms={_OUTAGE_HANG_MS},count=1",
                seed=seed))
            try:
                probe_ok = health.run_probe()
            finally:
                faults.install(prior_injector)
        it = 0
        while probe_ok is not False:
            if hang_at is not None and it == hang_at:
                faults.install(faults.FaultInjector.from_spec(
                    f"device.dispatch:hang:ms={_OUTAGE_HANG_MS},count=1",
                    seed=seed))
            t_it = time.perf_counter()
            try:
                if not profiler.run_iteration():
                    break
            except DeviceHang:
                if hang_at is None:
                    raise
                # The port's contract: the run ends here. Wait for the
                # abandoned call (it sleeps out the injected hang, then
                # aggregates into its own window's record) so nothing of
                # this row runs after it returns.
                hang_s = time.perf_counter() - t_it
                done = profiler.watchdog._inflight
                if done is not None:
                    done.wait(2 * _OUTAGE_HANG_MS / 1000.0)
                break
            close_lat.append(profiler.metrics.last_aggregate_duration_s)
            it += 1
        wall_s = time.perf_counter() - t0
    finally:
        faults.install(prior_injector)
        if profiler.pipeline is not None:
            # The manual loop bypasses run()'s teardown: drain the
            # encode worker so every closed window is shipped.
            profiler.pipeline.close()

    # -- assemble the scored substance per path -----------------------------
    n_run = len(windows) if outage is None else (
        0 if outage == "probe" else hang_at)
    if path == "scalar":
        # Entries tagged with the window they were dispatched for: an
        # abandoned aggregate lands late under its own window, which
        # never closed.
        by_w: dict[int, list] = {}
        for w, profs in agg.tagged:
            if w < n_run:
                by_w.setdefault(w, profs)
        profiles_by_window = [by_w.get(i, []) for i in range(n_run)]
        windows_closed = len(by_w)
        mass_by_window = [sum(int(p.total()) for p in profs)
                          for profs in profiles_by_window]
    else:
        profiles_by_window = []
        masses = dict(fastagg.mass_by_window)
        if feeder is not None:
            for w, m in feeder.mass_by_window.items():
                masses[w] = masses.get(w, 0) + m
        windows_closed = len(masses)
        mass_by_window = [masses.get(i, 0) for i in range(len(windows))]

    ctx = RunContext(
        profiles_by_window=profiles_by_window, shipped=writer.shipped,
        truth=scn.truth,
        aggregator=(agg._inner if agg is not None else fastagg),
        identity=identity, admission=admission, quarantine=quarantine,
        resolver=resolver, perf=perf)

    fed_by_window = [int(zw.snapshot.counts.sum()) for zw in windows]
    samples_fed = int(sum(fed_by_window[:n_run]))
    samples_shipped = int(sum(mass_by_window))
    ceiling = float(cfg.get("close_latency_ceiling_s",
                            DEFAULT_CLOSE_CEILING_S))
    outcome = {
        "scenario": scn.name,
        "axis": scn.axis,
        "description": scn.description,
        "seed": int(seed),
        "scale": float(scale),
        "hardened": bool(hardened),
        "path": path,
        "window_s": float(window_s),
        "outage": outage,
        "device": str(device),
        "windows": len(windows),
        "degraded_builds": int(scn.truth.get("degraded_builds", 0)),
        "windows_lost": int(profiler.metrics.errors_total),
        "windows_closed": windows_closed,
        "profiles_written": int(profiler.metrics.profiles_written),
        "samples_fed": samples_fed,
        "samples_shipped": samples_shipped,
        "mass_by_window": mass_by_window,
        "shipped_seq": _shipped_seq(writer.shipped),
        "close_latency_max_s": max(close_lat, default=0.0),
        "close_latency_ceiling_s": ceiling,
        "wall_s": wall_s,
        "identity": identity.metrics(),
        "admission": dict(admission.stats),
        "quarantine": dict(quarantine.stats),
        "perfmap": dict(perf.stats),
        "tenant_resolver": dict(resolver.stats),
    }
    if feeder is not None:
        outcome["streaming"] = dict(feeder.stats)
    bars = {
        "windows_lost_zero": outcome["windows_lost"] == 0,
        "every_window_closed": outcome["windows_closed"] == n_run,
        "mass_conserved": samples_shipped == samples_fed,
        "close_latency_ceiling":
            outcome["close_latency_max_s"] <= ceiling,
    }
    if path == "scalar" and outage is None:
        # Scenario-specific truths inspect scalar profile objects;
        # path/outage rows are scored on the base + axis bars
        # above/below instead.
        bars.update(scn.check(outcome, ctx))
    if health is not None:
        snap = health.snapshot()
        outcome["device_health"] = snap["stats"]
        outcome["device_state"] = snap["state"]
        if outage == "dispatch":
            bound_s = _OUTAGE_DEVICE_TIMEOUT_S + OUTAGE_HANG_MARGIN_S
            outcome["hang_s"] = hang_s
            outcome["hang_bound_s"] = bound_s
            outcome["hang_window"] = hang_at
            shipped_w = {w for w, _l, _b in writer.shipped}
            bars["outage_injected"] = snap["stats"]["hangs_total"] >= 1
            bars["outage_hang_bounded"] = (hang_s is not None
                                           and hang_s <= bound_s)
            bars["outage_wedged"] = snap["state"] == STATE_WEDGED
            # Every window closed before the hang shipped (the mass bar
            # above holds them to their fed samples, window by window).
            bars["windows_before_hang_shipped"] = \
                set(range(hang_at)) <= shipped_w and all(
                    m == f for m, f in zip(mass_by_window, fed_by_window))
        else:
            bars["outage_injected"] = snap["stats"]["probes_hung"] >= 1
            bars["outage_failed"] = (probe_ok is False
                                     and snap["state"] == STATE_FAILED)
            bars["no_window_ran"] = (profiler.metrics.attempts_total == 0
                                     and not writer.shipped)
    outcome["bars"] = bars
    outcome["passed"] = all(bars.values())
    outcome["digest"] = _digest(ctx)
    return outcome


def run_zoo(seed: int, scale: float = 1.0, names=None,
            hardened: bool | None = None, device: str = "cuda") -> dict:
    """The scalar matrix sweep: a deterministic schedule of scenario
    rows, each scored through the port's window loop on ``device``."""
    schedule = build_schedule(seed, names)
    rows = [run_scenario(e["scenario"], e["seed"], scale=scale,
                         hardened=hardened, device=device)
            for e in schedule]
    return {
        "seed": int(seed),
        "scale": float(scale),
        "schedule": schedule,
        "rows": rows,
        "scenarios_passed": sum(r["passed"] for r in rows),
        "scenarios_total": len(rows),
        "passed": bool(rows) and all(r["passed"] for r in rows),
    }


def run_matrix(seed: int, scale: float = 1.0, names=None,
               cadences=CADENCES, outages=OUTAGES,
               device: str = "cuda") -> dict:
    """The full endurance matrix: every scheduled scenario runs as a
    three-arm row (scalar / pipeline / streaming-carry) at every
    cadence, plus the device-outage cross-product, with the cross-arm
    bars (pprof byte identity between the fast arms, per-window mass
    identity across all three, scalar digest identity across cadences)
    scored per scenario."""
    schedule = build_schedule(seed, names)
    rows: list[dict] = []
    cross: list[dict] = []
    for e in schedule:
        per_arm: dict[tuple[str, float], dict] = {}
        for w in cadences:
            for path in PATHS:
                row = run_scenario(e["scenario"], e["seed"], scale=scale,
                                   path=path, window_s=w, device=device)
                per_arm[(path, w)] = row
                rows.append(row)
        for mode in outages:
            for w in cadences:
                rows.append(run_scenario(e["scenario"], e["seed"],
                                         scale=scale, path="scalar",
                                         window_s=w, outage=mode,
                                         device=device))
        scalar_digests = {w: per_arm[("scalar", w)]["digest"]
                          for w in cadences}
        bars = {}
        for w in cadences:
            sc = per_arm[("scalar", w)]
            pi = per_arm[("pipeline", w)]
            st = per_arm[("streaming", w)]
            bars[f"path_bytes_identical@{w:g}s"] = \
                bool(pi["shipped_seq"]) \
                and pi["shipped_seq"] == st["shipped_seq"]
            bars[f"path_mass_identical@{w:g}s"] = (
                sc["mass_by_window"] == pi["mass_by_window"]
                == st["mass_by_window"])
        bars["cadence_digest_identical"] = \
            len(set(scalar_digests.values())) == 1
        cross.append({
            "scenario": e["scenario"], "seed": e["seed"], "bars": bars,
            "scalar_digests": {f"{w:g}": d
                               for w, d in scalar_digests.items()},
            "passed": all(bars.values()),
        })
    passed = (bool(rows) and all(r["passed"] for r in rows)
              and all(c["passed"] for c in cross))
    return {
        "seed": int(seed),
        "scale": float(scale),
        "paths": list(PATHS),
        "cadences": [float(w) for w in cadences],
        "outages": list(outages),
        "schedule": schedule,
        "rows": rows,
        "cross": cross,
        "rows_passed": sum(r["passed"] for r in rows),
        "rows_total": len(rows),
        "passed": passed,
    }
