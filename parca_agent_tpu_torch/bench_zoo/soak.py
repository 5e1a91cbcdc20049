"""Wall-clock endurance: the workload zoo run until the clock says stop.

The port's copy of parca_agent_tpu/bench_zoo/soak.py. ``run_soak``
wires ONE persistent agent (admission, quarantine, perf-map cache,
generation-stamped identity, a carry-enabled DictAggregator on
``device`` behind the zoo's streaming feeder) and drives an endless
interleave of zoo scenario schedules through the port's
``CPUProfiler.run_iteration`` loop until ``wall_s`` elapses. Windows run
back-to-back — hour-scale window counts compressed into minutes of wall
time — while every window samples the process RSS and the per-subsystem
byte lanes (``DictAggregator.footprint_bytes``, identity table,
admission/quarantine registries). On the card, the CUDA context and the
caching allocator grow the host RSS in the first windows: the fixed
warm-up below keeps them out of every slope.

The verdict is mechanical, not vibes:

* ``rss_slope_ok`` — least-squares RSS growth per window (after a
  fixed warm-up) under ``rss_slope_limit``;
* ``lanes_ok`` — every byte/entry lane's post-warm-up slope under
  ``lane_slope_limit`` (a cache that grows without bound fails here
  long before it OOMs);
* ``windows_lost_zero`` and ``mass_conserved`` — the zoo's own bars,
  cumulative over the whole soak.

Sampling rides the ``soak.tick`` chaos site and is fail-open: an
injected fault costs that window's sample only (counted tick_errors),
never the window or the verdict arithmetic. ``main`` is the command
line (``python -c "from parca_agent_tpu_torch.bench_zoo.soak import
main; main()" --wall 45`` — not ``-m``: the package imports this
module, and runpy would load it twice); it honors PARCA_FAULTS like the
CLI, and ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from parca_agent_tpu_torch.bench_zoo.runner import (
    _RecordingDict, _ZooStreamFeeder, _wall_equivalent)
from parca_agent_tpu_torch.bench_zoo.scenarios import SCENARIOS, build_schedule
from parca_agent_tpu_torch.process.identity import ProcessIdentityTracker
from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
from parca_agent_tpu_torch.runtime.admission import (
    AdmissionController, TenantResolver)
from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
from parca_agent_tpu_torch.utils.window_clock import check_window_s
from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import FakeFS

try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):  # pragma: no cover
    _PAGE = 4096

# Fixed warm-up excluded from every slope: allocator arenas, the CUDA
# context, the caching allocator's first blocks and cold caches all land
# in the first windows and are not leaks.
WARMUP_WINDOWS = 32
_MIN_SLOPE_POINTS = 8

# Bytes of RSS growth per window the verdict tolerates after warm-up.
# Python allocator noise is real; a genuine per-window leak clears this
# in minutes and the per-lane slopes catch the culprit cache by name.
DEFAULT_RSS_SLOPE_LIMIT = 2048.0

# Per-lane growth per window (bytes for the byte lanes, entries for the
# count lanes). The zoo population recurs every cycle, so every cache
# must plateau once it has seen the whole zoo.
DEFAULT_LANE_SLOPE_LIMIT = 256.0


def _rss_bytes() -> int:
    with open("/proc/self/statm", "rb") as f:
        return int(f.read().split()[1]) * _PAGE


class _SlopeReg:
    """Streaming least-squares y-per-x slope: running sums only, so the
    soak's own bookkeeping stays O(1) per window (a sampler that grows a
    list per window would fail its own RSS bar on a long run)."""

    __slots__ = ("n", "sx", "sy", "sxx", "sxy")

    def __init__(self) -> None:
        self.n = 0
        self.sx = self.sy = self.sxx = self.sxy = 0.0

    def add(self, x: float, y: float) -> None:
        self.n += 1
        self.sx += x
        self.sy += y
        self.sxx += x * x
        self.sxy += x * y

    def slope(self) -> float:
        if self.n < 2:
            return 0.0
        d = self.n * self.sxx - self.sx * self.sx
        if d == 0.0:
            return 0.0
        return (self.n * self.sxy - self.sx * self.sy) / d


class SoakStatus:
    """Live soak telemetry, shared with the web endpoints: the soak
    loop updates it per window, /metrics and /healthz read snapshots.
    Never-red by construction — it carries numbers and the last
    verdict, it cannot veto readiness."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._d: dict = {
            "running": False, "scenario": "", "scenarios": (),
            "windows_elapsed": 0, "rss_bytes": 0, "lanes": {},
            "verdict": None,
        }

    def update(self, **kw) -> None:
        with self._lock:
            self._d.update(kw)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._d)
            out["lanes"] = dict(out["lanes"])
            return out


class _SoakSource:
    """Capture source over an endless zoo interleave: pops windows from
    deterministically re-seeded scenario schedules, applies each
    window's world mutations, and returns None only when the wall clock
    says the soak is over."""

    def __init__(self, seed: int, scale: float, fs: FakeFS,
                 world: dict[int, int], deadline: float,
                 names=None, clock=time.monotonic):
        self._seed = int(seed)
        self._scale = float(scale)
        self._fs = fs
        self._world = world
        self._deadline = deadline
        self._names = names
        self._clock = clock
        self._cycle = 0
        self._queue: list = []  # (scenario_name, ZooWindow)
        self.current = -1
        self.scenario = ""
        self.samples_fed = 0
        self.cycles = 0

    def _replenish(self) -> None:
        # One full schedule per cycle, re-seeded so content varies but
        # the whole soak replays bit-identically from (seed, wall).
        schedule = build_schedule(self._seed + self._cycle, self._names)
        for e in schedule:
            scn = SCENARIOS[e["scenario"]]()
            for zw in scn.build(e["seed"], self._scale):
                self._queue.append((e["scenario"], zw))
        self._cycle += 1
        self.cycles = self._cycle

    def poll(self):
        if self._clock() >= self._deadline:
            return None
        if not self._queue:
            self._replenish()
        name, zw = self._queue.pop(0)
        for path in sorted(zw.files):
            self._fs.put(path, zw.files[path])
        self._world.update(zw.starttimes)
        self.current += 1
        self.scenario = name
        self.samples_fed += int(zw.snapshot.counts.sum())
        return zw.snapshot


class _CountingWriter:
    """Ship sink that keeps totals, never blobs: a writer that retained
    every profile would be the leak the soak is hunting."""

    def __init__(self) -> None:
        self.profiles = 0
        self.bytes_total = 0

    def write(self, labels: dict, blob) -> None:
        self.profiles += 1
        self.bytes_total += len(blob)


def run_soak(wall_s: float = 60.0, seed: int = 1234, scale: float = 0.5,
             window_s: float = 1.0,
             rss_slope_limit: float = DEFAULT_RSS_SLOPE_LIMIT,
             lane_slope_limit: float = DEFAULT_LANE_SLOPE_LIMIT,
             names=None, status: SoakStatus | None = None,
             series_points: int = 256, device: str = "cuda") -> dict:
    """Run the endurance soak for ``wall_s`` seconds, the dictionary on
    ``device``, and return the verdict artifact. Deterministic content
    for a given (seed, scale); the wall clock only decides how many
    windows fit."""
    check_window_s(window_s)
    wall_s = float(wall_s)
    if wall_s <= 0:
        raise ValueError(f"wall_s must be > 0, got {wall_s}")

    fs = FakeFS()
    world: dict[int, int] = {}
    resolver = TenantResolver(fs=fs)
    adm_kwargs, qua_kwargs = _wall_equivalent({}, window_s)
    admission = AdmissionController(resolver, **adm_kwargs)
    quarantine = QuarantineRegistry(**qua_kwargs)
    perf = PerfMapCache(fs=fs, churn_budget=8)
    identity = ProcessIdentityTracker(
        starttime_of=world.__getitem__, enabled=True)
    identity.add_invalidator("quarantine", quarantine.forget_pid)
    identity.add_invalidator("tenant", resolver.forget)
    identity.add_invalidator("perfmap", perf.evict)

    t_start = time.monotonic()
    source = _SoakSource(seed, scale, fs, world, t_start + wall_s,
                         names=names)
    writer = _CountingWriter()
    if status is not None:
        # The scenario universe up front so /metrics can render the
        # one-hot family with a stable label set from window zero.
        status.update(running=True,
                      scenarios=tuple(names) if names else tuple(SCENARIOS))
    agg = _RecordingDict(capacity=1 << 14, carry=True, device=device)
    agg.zoo_source = source
    identity.add_invalidator("aggregator", agg.invalidate_pid)
    feeder = _ZooStreamFeeder(agg, source)

    samples_shipped = 0
    tick_errors = 0
    regs: dict[str, _SlopeReg] = {}
    warm_regs: dict[str, _SlopeReg] = {}
    series: list[dict] = []  # downsampled, for the artifact
    lanes_last: dict[str, float] = {}

    def _observe(name: str, w: int, value: float) -> None:
        lanes_last[name] = value
        regs.setdefault(name, _SlopeReg()).add(w, value)
        if w >= WARMUP_WINDOWS:
            warm_regs.setdefault(name, _SlopeReg()).add(w, value)

    def _tick(_attempts: int) -> None:
        nonlocal samples_shipped, tick_errors
        w = source.current
        # Fold this window's shipped mass OUT of the recorders so the
        # soak's own accounting is O(1), then sample under the chaos
        # site: an injected fault costs this sample only.
        for rec in (agg.mass_by_window, feeder.mass_by_window):
            for _k in list(rec):
                samples_shipped += rec.pop(_k)
        try:
            faults.inject("soak.tick")
            rss = _rss_bytes()
            _observe("rss_bytes", w, float(rss))
            for lane, val in agg.footprint_bytes().items():
                _observe(lane, w, float(val))
            _observe("identity_tracked_pids", w,
                     float(identity.snapshot().get("tracked_pids", 0)))
            _observe("quarantine_entries", w,
                     float(len(quarantine.snapshot().get("pids", {}))))
            if w % max(1, (source.current + 1) // series_points) == 0 \
                    and len(series) < 2 * series_points:
                series.append({"window": w, "rss_bytes": rss,
                               "scenario": source.scenario})
            if status is not None:
                status.update(running=True, scenario=source.scenario,
                              windows_elapsed=w + 1, rss_bytes=rss,
                              lanes=dict(lanes_last))
        except Exception:  # noqa: BLE001 - counted, never the window
            tick_errors += 1

    profiler = CPUProfiler(
        source, agg, profile_writer=writer, quarantine=quarantine,
        admission=admission, identity=identity, encode_pipeline=False,
        streaming_feeder=feeder, on_iteration=_tick)

    while profiler.run_iteration():
        pass
    wall_used = time.monotonic() - t_start

    # Late stragglers (last window's mass folds after the final tick).
    for rec in (agg.mass_by_window, feeder.mass_by_window):
        for _k in list(rec):
            samples_shipped += rec.pop(_k)

    windows = source.current + 1
    # Slopes are judged on post-warm-up samples only; a run too short
    # to clear warm-up has no leak-vs-startup signal, so it reports the
    # slopes as unmeasured rather than failing on its own cold caches.
    slope_measured = bool(warm_regs) and all(
        r.n >= _MIN_SLOPE_POINTS for r in warm_regs.values())
    slopes = {name: reg.slope()
              for name, reg in (warm_regs if slope_measured
                                else regs).items()}
    rss_slope = slopes.pop("rss_bytes", 0.0)
    bad_lanes = {name: s for name, s in slopes.items()
                 if s > lane_slope_limit}
    bars = {
        "ran_windows": windows >= 1,
        "windows_lost_zero": int(profiler.metrics.errors_total) == 0,
        "mass_conserved": samples_shipped == source.samples_fed,
        "rss_slope_ok": (not slope_measured
                         or rss_slope <= rss_slope_limit),
        "lanes_ok": not slope_measured or not bad_lanes,
    }
    verdict = {
        "wall_s": float(wall_s),
        "wall_used_s": float(wall_used),
        "device": str(device),
        "seed": int(seed),
        "scale": float(scale),
        "window_s": float(window_s),
        "windows": windows,
        "cycles": source.cycles,
        "windows_lost": int(profiler.metrics.errors_total),
        "samples_fed": int(source.samples_fed),
        "samples_shipped": int(samples_shipped),
        "profiles_written": writer.profiles,
        "shipped_bytes": writer.bytes_total,
        "path_fallbacks": feeder.stats["path_fallbacks"],
        "tick_errors": tick_errors,
        "slope_measured": slope_measured,
        "rss_slope_bytes_per_window": float(rss_slope),
        "rss_slope_limit": float(rss_slope_limit),
        "lane_slopes": {k: float(v) for k, v in slopes.items()},
        "lane_slope_limit": float(lane_slope_limit),
        "bad_lanes": {k: float(v) for k, v in bad_lanes.items()},
        "lanes_final": {k: float(v) for k, v in lanes_last.items()},
        "series": series,
        "bars": bars,
        "passed": all(bars.values()),
    }
    if status is not None:
        status.update(running=False, verdict=verdict,
                      windows_elapsed=windows)
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="workload-zoo endurance soak of the port")
    ap.add_argument("--wall", type=float, default=300.0,
                    help="soak wall time in seconds")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--window", type=float, default=1.0,
                    help="registry window_s (cadence semantics under "
                         "test; windows still run back-to-back)")
    ap.add_argument("--rss-slope-limit", type=float,
                    default=DEFAULT_RSS_SLOPE_LIMIT)
    ap.add_argument("--lane-slope-limit", type=float,
                    default=DEFAULT_LANE_SLOPE_LIMIT)
    ap.add_argument("--device", default="cuda",
                    help="the dictionary's device (cuda, or cpu)")
    ap.add_argument("--out", default="", help="write the verdict "
                    "artifact to this JSON path")
    args = ap.parse_args(argv)

    spec = os.environ.get("PARCA_FAULTS", "")
    if spec:
        faults.install(faults.FaultInjector.from_spec(
            spec, seed=int(os.environ.get("PARCA_FAULT_SEED", "0"))))
    out = run_soak(wall_s=args.wall, seed=args.seed, scale=args.scale,
                   window_s=args.window,
                   rss_slope_limit=args.rss_slope_limit,
                   lane_slope_limit=args.lane_slope_limit,
                   device=args.device)
    brief = {k: out[k] for k in (
        "windows", "cycles", "windows_lost", "samples_fed",
        "samples_shipped", "rss_slope_bytes_per_window", "bad_lanes",
        "tick_errors", "path_fallbacks", "passed")}
    print(json.dumps(brief, indent=2, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
        print(f"soak artifact: {args.out}")
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
