"""The window loop: one loop, two per-window bodies.

The part of parca_agent_tpu's CPUProfiler (profiler/cpu.py there) that
the port's CLI runs. ``WindowLoop`` is the supervised loop both write
paths share: the poll, the window trace, the window sink, the quarantine,
device-health and telemetry ticks, the stop event and the window count.
``AggregateLoop`` is the path without --fast-encode: each window's
profiles from ``aggregator.aggregate`` (under the device watchdog), down
the quarantine ladder, through the symbolizer when one is given (kernel
names from kallsyms, JIT names from perf maps: symbolize/; pids on the
ladder are skipped), then build_pprof into the writer.
``CPUProfiler`` is the --fast-encode path: each window, the dictionary's
counts (on
the card unless the aggregator was made on the CPU), then the vectorized
pprof encode — handed to the encode pipeline's worker thread, or inline
on this thread — then the profile writer, one profile a pid, under the
labels the port's CLI writes.

The counts come from the streaming feeder when one is given (the drains
were fed during the window, and the close is one packed fetch:
profiler/streaming.py), else from ``window_counts`` of the snapshot. A
window the feeder did not see whole is re-aggregated by window_counts on
the same aggregator (the feeder counts it). With a statics store
(pprof/statics_store.py) and the pipeline, the worker writes the warm
statics snapshot every ``statics_snapshot_every`` windows. A
``window_sink`` gets each window's snapshot once the window is handed to
the encoder (the fleet merge actor feeds on it: cli.py); a sink that
raises is logged and the window goes on, as the original's tee.

The window's device call (the streamed close, or window_counts) runs
under the device watchdog, as the original's guarded call: on an
abandonable thread, behind the chaos site ``device.dispatch``, its
outcome recorded in the device-health registry
(runtime/device_health.py). Unlike the original's, the bound
``device_timeout_s`` applies to each of the call's waits on the card
(utils/bounded.py device_wait: the uploads, the miss count, the close
fetch; the site itself counts as one), not to the call: the host's miss
settle between them, tens of seconds in a cold window at the bench
width, is not the card's. No CPU aggregator stands behind the card, so:

  * a device call that raises propagates (counted in the registry);
  * a device call that hangs is abandoned and ENDS THE RUN: the loop
    raises DeviceHang, which the supervisor does not restart and the CLI
    turns into a bounded, non-zero exit (the trace and the health
    snapshot flushed first). A wedged card costs a bounded exit, not a
    hung agent;
  * an inline encode that raises propagates;
  * with ``encode_deadline_s``, an inline encode that overruns it is
    abandoned to its thread (it keeps warming the template) and the
    window ships each pid's scalar profile instead — one sample holding
    the pid's exact count from the card (runtime/quarantine.py
    scalar_profile, the ladder's level 2) — counted in
    encode_deadline_hits_total. This is the original's output
    degradation for a slow host encode, not a device fallback: the
    counts are the card's either way;
  * a window the pipeline refuses because its worker is still busy
    (backpressure, counted) waits the worker out, bounded, and is then
    encoded inline on this thread;
  * a pipelined window whose encode raised disables the pipeline (its
    loss is counted in the pipeline's windows_lost) and the loop raises
    that error at the next window or at close.

Both loops take a process identity tracker (process/identity.py): it
observes each window's pids before the close, so a recycled pid's stale
state (its maps, perf map, unwind tables, quarantine record and the
dictionary's per-pid registry) is invalidated before the new process's
samples resolve through it. With a debuginfo manager (debuginfo/), each
window's object files go to ``ensure_uploaded`` after the window. The
fast path ships unsymbolized profiles and refuses a symbolizer. With a
labels manager (labels/), each profile's label set is the manager's
``label_set("parca_agent_cpu", pid)``, and a pid whose target the
relabel rules drop is not written; without one it is {__name__, pid}.
A clean exit of run() flushes the encode pipeline's in-flight window
into the writer, so the batch client's final drain (stopped after the
loop) ships the last window too.

Each window records a trace in the flight recorder when one is given
(runtime/trace.py: drain, close, the feeder's feed spans, fetch,
buffer_flip, delta_fetch, then symbolize (without --fast-encode),
encode and ship here or prepare, statics, encode and ship on the
pipeline's worker), and each iteration ticks the quarantine registry,
the device-health registry and device telemetry's window budget
(runtime/device_telemetry.py).

The analytics ride both loops as in the original. With ``admission``
(runtime/admission.py) each window's usage is charged to its tenants
before the close and the controller ticks after it, beside the
quarantine registry; the loop without --fast-encode rides each profile
down the larger of both ladders. On the fast path, a ``hotspot_store``
(runtime/hotspots.py) and a ``regression`` sentinel
(runtime/regression.py) fold each shipped window on the encode
pipeline's worker, through a registry view taken on this thread at the
hand-off (the sentinel in the ``finally`` arm, so a failed hotspot fold
never costs the window's judgment); without the pipeline they are not
fed, with a warning. ``sinks`` (a sinks.SinkRegistry) replaces the
pprof ship: its primary is the same write path, its secondaries
(AutoFDO, series, alerts) read the prepared window and can never fail
the ship; a window that ships scalar profiles is counted as skipped.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import threading
import time
from typing import Callable, Protocol

import numpy as np

from parca_agent_tpu_torch.capture.formats import WindowSnapshot
from parca_agent_tpu_torch.pprof.builder import build_pprof
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline
from parca_agent_tpu_torch.runtime import device_telemetry as dtel
from parca_agent_tpu_torch.runtime.quarantine import (
    apply_ladder,
    scalar_profile,
)
from parca_agent_tpu_torch.runtime.trace import NULL_TRACE
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.bounded import bounded_call, device_wait
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("profiler")


class CaptureSource(Protocol):
    def poll(self) -> WindowSnapshot | None: ...


# How long the loop waits for the encode worker (a window's encode at the
# bench's 50,000 pids takes seconds; a stuck worker must not hang the
# loop forever).
FLUSH_TIMEOUT_S = 60.0


class DeviceHang(BaseException):
    """A guarded device call blew the device watchdog and was abandoned:
    the card is wedged. A BaseException, so that neither the supervisor
    (which restarts crashed actors on Exception) nor a caller's
    ``except Exception`` carries on past it: the run ends."""


@dataclasses.dataclass
class ProfilerMetrics:
    """parca_agent_tpu's ProfilerMetrics (the reference's
    pkg/profiler/cpu/metrics.go counters), moved where that package's
    loop moves them, and the port's scalar-window count."""

    attempts_total: int = 0
    # Windows whose poll or body raised (the supervisor restarts the
    # loop; the error was the iteration's last_error).
    errors_total: int = 0
    profiles_written: int = 0
    samples_aggregated: int = 0
    # The last window: poll to the end of its ticks, and its close span.
    last_attempt_duration_s: float = 0.0
    last_aggregate_duration_s: float = 0.0
    last_encode_duration_s: float = 0.0
    encode_backpressure_total: int = 0
    # Inline encodes abandoned at --encode-deadline, and the windows
    # shipped as per-pid scalar profiles (a deadline hit, or the next
    # window while the abandoned encode still owns the encoder).
    encode_deadline_hits_total: int = 0
    scalar_windows_total: int = 0
    # The last window's symbolize span (the path without --fast-encode).
    last_symbolize_duration_s: float = 0.0
    # Abandoned device calls that returned afterwards, by how they ended.
    device_abandoned_ok_total: int = 0
    device_abandoned_err_total: int = 0


class DeviceWatchdog:
    """The guard around a window's device call (the original's
    _watchdog_call and _inspect_abandoned): the call runs on an
    abandonable thread, each of its device waits bounded by
    ``timeout_s`` (None or 0: unbounded, on the caller's thread), behind
    the chaos site ``device.dispatch`` (itself a device wait),
    and its outcome goes to the device-health registry when one is
    given. ``call`` returns the call's value, raises its error, or raises
    DeviceHang when it was abandoned; the abandoned call's completion is
    inspected once, at the next call (and counted in ``metrics``, a
    ProfilerMetrics, when one is given), and until it returns every call
    raises DeviceHang without touching the device state."""

    def __init__(self, timeout_s: float | None = 60.0, health=None,
                 metrics=None):
        self.timeout_s = timeout_s or None
        self._health = health
        self._metrics = metrics
        self._inflight = None   # threading.Event of an abandoned call
        self._abandoned = None  # its result box
        self.stats = {"calls": 0, "errors": 0, "hangs": 0,
                      "abandoned_ok": 0, "abandoned_err": 0}

    def _inspect_abandoned(self) -> None:
        done = self._inflight
        if done is None:
            return
        if not done.is_set():
            raise DeviceHang("an abandoned device call is still in flight")
        box = self._abandoned or {}
        if "err" in box:
            self.stats["abandoned_err"] += 1
            if self._metrics is not None:
                self._metrics.device_abandoned_err_total += 1
            _log.warn("abandoned device call completed with an error",
                      error=repr(box["err"]))
        else:
            self.stats["abandoned_ok"] += 1
            if self._metrics is not None:
                self._metrics.device_abandoned_ok_total += 1
            _log.info("abandoned device call completed")
        self._inflight = None
        self._abandoned = None

    def _watchdog_call(self, thunk):
        """("ok", out) | ("err", exc) | ("hang", None); a hang leaves the
        call registered as in flight."""
        def site():
            with device_wait():
                faults.inject("device.dispatch")
            return thunk()

        if self.timeout_s is None:
            try:
                return "ok", site()
            except Exception as e:  # noqa: BLE001 - returned to the caller
                return "err", e
        status, out, done, box = bounded_call(
            site, self.timeout_s, thread_name="aggregate-device",
            waits_only=True)
        if status == "hang":
            self._inflight = done
            self._abandoned = box
        return status, out

    def call(self, thunk):
        self._inspect_abandoned()
        self.stats["calls"] += 1
        status, out = self._watchdog_call(thunk)
        if status == "ok":
            return out
        if status == "err":
            self.stats["errors"] += 1
            if self._health is not None:
                self._health.record_dispatch_error(out)
            raise out
        self.stats["hangs"] += 1
        _log.error("device call hung; abandoning it and ending the run",
                   timeout_s=self.timeout_s)
        if self._health is not None:
            self._health.record_hang()
        raise DeviceHang(f"device call hung past the {self.timeout_s} s "
                         "watchdog; the card is wedged")


@dataclasses.dataclass
class _PidTotal:
    """A pid's window mass, in the shape scalar_profile reads."""

    pid: int
    mass: int
    period_ns: int
    time_ns: int
    duration_ns: int

    def total(self) -> int:
        return self.mass


def window_objects(snapshot: WindowSnapshot) -> list[tuple[int, str, str]]:
    """(pid, path, build id) of each object file the window's mapping
    table names, with the first pid that maps it (the original's
    debuginfo hand-off)."""
    objs = []
    mt = snapshot.mappings
    for i, path in enumerate(mt.obj_paths):
        bid = mt.obj_buildids[i] if i < len(mt.obj_buildids) else ""
        rows = (mt.objs == i).nonzero()[0]
        if len(rows) and path:
            objs.append((int(mt.pids[rows[0]]), path, bid))
    return objs


def labels_for(pid: int) -> dict[str, str]:
    """The label set of a pid's profile without a labels manager."""
    return {"__name__": "parca_agent_cpu", "pid": str(pid)}


class WindowLoop:
    """The supervised window loop: one window each ``duration_s``, its
    body ``_window(snapshot, window, trace)``. Each window records a
    trace in the flight recorder when one is given and its snapshot goes
    to ``window_sink`` (a sink that raises is logged); each iteration
    ticks the quarantine registry, the device-health registry and
    device telemetry's window budget. With ``manage_gc`` (the process
    owner only: the CLI) the loop stewards CPython's collector as the
    original does: after the first window the warm state is frozen and
    the automatic scheduler disabled, and each window boundary collects
    what the window allocated (every _GC_REFREEZE windows a full
    collect and a refreeze); run() restores the default collector when
    it returns or raises. ``on_window(record)`` gets each
    window's record once its profiles are written; ``on_iteration(n)``
    is called after each window's ticks with the number of windows taken
    (the CLI feeds discovery's groups to the labels there). With
    ``identity`` (a
    ProcessIdentityTracker) each window's pids are observed before its
    body runs; with ``debuginfo`` (a DebuginfoManager) each window's
    object files are handed to ``ensure_uploaded`` after it; with
    ``labels_manager`` (a LabelsManager) each profile is written under
    its label set, and not at all when relabeling dropped its target."""

    # The loop's name on /metrics and the status page, and the parts the
    # HTTP server reads (each loop sets those it has).
    name = "cpu"
    aggregator = None
    pipeline = None
    encoder = None
    feeder = None
    symbolizer = None

    def __init__(self, source: CaptureSource, profile_writer=None,
                 on_window: Callable[[dict], None] | None = None,
                 window_sink: Callable[[WindowSnapshot], None] | None = None,
                 device_timeout_s: float | None = 60.0,
                 device_health=None, quarantine=None, trace_recorder=None,
                 duration_s: float = 10.0, identity=None, debuginfo=None,
                 labels_manager=None, manage_gc: bool = False,
                 on_iteration: Callable[[int], None] | None = None,
                 admission=None):
        self._source = source
        self._writer = profile_writer
        self._on_window = on_window
        self._on_iteration = on_iteration
        # Optional tee of each window's snapshot; its failures must not
        # fail the window.
        self._window_sink = window_sink
        self.metrics = ProfilerMetrics()
        # The device watchdog (None or 0: unbounded) and the registry its
        # outcomes go to.
        self.watchdog = DeviceWatchdog(device_timeout_s, device_health,
                                       self.metrics)
        self._health = device_health
        # Ingest containment: the loop owns the window clock and ticks
        # the registry once an iteration.
        self._quarantine = quarantine
        # Multi-tenant admission: each window's usage is charged before
        # the close and the controller ticks after it, on the loop's
        # window clock (both entry points are fail-open by the
        # controller's own contract).
        self._admission = admission
        # The window flight recorder (runtime/trace.py); tracing is
        # fail-open, so no call to it needs a guard.
        self._recorder = trace_recorder
        # Generation-stamped process identity, observed once a window
        # before the close (fail-open by the tracker's own contract).
        self._identity = identity
        self._debuginfo = debuginfo
        self._labels = labels_manager
        # Writes come from this thread (inline windows) AND the encode
        # pipeline's worker: one lock serializes the labels manager's
        # caches and the written counter.
        self._write_mu = threading.Lock()
        self._manage_gc_enabled = manage_gc
        self._duration = duration_s
        self._stop = threading.Event()
        self.crashed: BaseException | None = None
        # The last window's error (None once a window succeeds), and each
        # written pid's last write error, for the status page.
        self.last_error: Exception | None = None
        self.process_last_errors: dict[int, Exception | None] = {}

    @property
    def duration_s(self) -> float:
        return self._duration

    def _window(self, snapshot: WindowSnapshot, window: int, tr) -> None:
        raise NotImplementedError

    def _labels_for(self, pid: int) -> dict | None:
        """Label set for a pid; None when relabeling dropped the target."""
        if self._labels is not None:
            return self._labels.label_set("parca_agent_cpu", pid)
        return labels_for(pid)

    def _locked_labels_for(self, pid: int) -> dict | None:
        """Label lookup under the write lock, the serialization
        _write_one uses, so the rollup fold and the sinks (encode worker)
        never race the labels manager's caches."""
        with self._write_mu:
            return self._labels_for(pid)

    def _write_one(self, pid: int, payload) -> bool:
        """Labels lookup, write and count for one profile; False when
        relabeling dropped the target. `payload` is a zero-arg callable,
        so a dropped target never pays the serialization. The lock covers
        the label lookup and the counter only: the writer runs outside
        it (writers tolerate concurrent write())."""
        try:
            with self._write_mu:
                labels = self._labels_for(pid)
            if labels is not None:
                if self._writer is not None:
                    self._writer.write(labels, payload())
                with self._write_mu:
                    self.metrics.profiles_written += 1
            self.process_last_errors[pid] = None
            return labels is not None
        except Exception as e:
            self.process_last_errors[pid] = e
            raise

    def _before_window(self) -> None:
        """Raise what must stop the loop before the next window."""

    def run_iteration(self) -> bool:
        """One window: False when the source is exhausted. Raises what
        the window's body raises (DeviceHang when its device call was
        abandoned)."""
        t_iter0 = time.perf_counter()
        self._before_window()
        tr = (self._recorder.begin() if self._recorder is not None
              else NULL_TRACE)
        try:
            with tr.span("drain"):
                snapshot = self._source.poll()
            if snapshot is None:
                tr.discard()  # never a window: not ringed, not histogrammed
                return False
            self.metrics.attempts_total += 1
            if self._identity is not None:
                # Before the close: a recycled pid's stale state must be
                # invalidated before the new process's samples resolve
                # through it.
                self._identity.observe_window(snapshot.pids)
            if self._admission is not None:
                # Before the close: the ladder levels this window's
                # profiles ride were set by the last tick (admission
                # reacts one window behind, as quarantine cooldowns do).
                self._admission.account_window(snapshot.pids,
                                               snapshot.counts)
            tr.annotate(time_ns=snapshot.time_ns,
                        samples=int(snapshot.total_samples()))
            t_start = time.perf_counter()
            self._window(snapshot, self.metrics.attempts_total, tr)
            if self._debuginfo is not None:
                self._debuginfo.ensure_uploaded(window_objects(snapshot))
            if self._window_sink is not None:
                try:
                    self._window_sink(snapshot)
                except Exception as e:  # noqa: BLE001 - tee must not fail us
                    _log.warn("window sink failed", error=repr(e))
        except BaseException as e:
            if isinstance(e, Exception):
                self.last_error = e
                self.metrics.errors_total += 1
            tr.finish(error=repr(e)[:200])
            raise
        self.last_error = None
        # Pipelined windows detached their trace (the worker completes it
        # after the ship); everything else finishes here.
        tr.finish()
        if self._quarantine is not None:
            # Quarantine time is window time.
            self._quarantine.tick_window()
        if self._admission is not None:
            # The governor judges this window's close latency, registry
            # rows and encode backpressure.
            self._admission.tick_window(
                close_latency_s=self.metrics.last_aggregate_duration_s,
                registry_rows=int(
                    getattr(self.aggregator, "_next_id", 0) or 0),
                backlog=(self.pipeline.stats["backpressure_fallbacks"]
                         if self.pipeline is not None else 0))
        if self._health is not None:
            self._health.tick_window()
        self.metrics.last_attempt_duration_s = time.perf_counter() - t_start
        # Window-SLO accounting: this thread's busy wall for the window.
        dtel.tick_window(time.perf_counter() - t_iter0)
        self._manage_gc(self.metrics.attempts_total)
        if self._on_iteration is not None:
            self._on_iteration(self.metrics.attempts_total)
        return True

    # A gen-2 collection scans every tracked object, and the dictionary's
    # host mirror and a window's profiles hold millions (the symbolizer
    # alone makes a list a location): an automatic pass costs seconds and
    # lands inside a window. After the first window the warm state is
    # frozen (out of every collection), the scheduler disabled, and each
    # window boundary collects what the window allocated; every
    # _GC_REFREEZE windows (~1 h at 10 s) a full collect and refreeze
    # reclaims garbage that slipped into the frozen set.
    _GC_REFREEZE = 360
    _gc_modified = False

    def _manage_gc(self, window: int) -> None:
        if not self._manage_gc_enabled:
            return
        if not self._gc_modified:
            # The first managed window of this run (a supervised restart
            # re-arms here after run() restored the collector).
            gc.collect()
            gc.freeze()
            gc.disable()
            self._gc_modified = True
        elif window % self._GC_REFREEZE == 0:
            gc.unfreeze()
            gc.collect()
            gc.freeze()
        else:
            gc.collect()

    def _restore_gc(self) -> None:
        """The default collector back: the process may outlive the loop
        (a supervised restart, an in-process caller)."""
        if not self._gc_modified:
            return
        self._gc_modified = False
        gc.unfreeze()
        gc.enable()

    def run(self, max_windows: int = 0) -> None:
        """The loop as a supervised actor: one window each ``duration_s``
        until the source is exhausted, stop() is called, or (with
        ``max_windows``) that many windows were taken, restarts
        included. Re-runnable: a restart after a crash clears the crash
        record; only a real exit closes the loop."""
        self.crashed = None
        try:
            while not self._stop.is_set():
                if max_windows and self.metrics.attempts_total >= max_windows:
                    return
                t0 = time.monotonic()
                faults.inject("actor.profiler")
                if not self.run_iteration():
                    return
                if max_windows and self.metrics.attempts_total >= max_windows:
                    return
                elapsed = time.monotonic() - t0
                self._stop.wait(max(0.0, self._duration - elapsed))
        except BaseException as e:
            # Recorded so the CLI exits non-zero (and so the supervisor
            # can decide on a restart).
            self.crashed = e
            raise
        finally:
            self._restore_gc()
            if self.crashed is None:
                self.close()

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        """The loop's end (nothing to flush here)."""


class AggregateLoop(WindowLoop):
    """The window loop without --fast-encode: each window's profiles from
    ``aggregator.aggregate`` (under the device watchdog), down the
    quarantine ladder (quarantined pids lose their detail, level 1, or
    collapse to their scalar count), through the ``symbolizer`` when one
    is given (its own span; laddered pids are skipped), through
    build_pprof into the writer. The record holds the window's number,
    rows, samples, profiles, mass, aggregate ms, symbolize ms (with a
    symbolizer) and window ms."""

    def __init__(self, source: CaptureSource, aggregator, symbolizer=None,
                 **kw):
        super().__init__(source, **kw)
        self._aggregator = aggregator
        self._symbolizer = symbolizer

    @property
    def aggregator(self):
        return self._aggregator

    @property
    def symbolizer(self):
        return self._symbolizer

    def _window(self, snapshot: WindowSnapshot, window: int, tr) -> None:
        t0 = time.perf_counter()
        with tr.span("close") as sp_close:
            profiles = self.watchdog.call(
                lambda: self._aggregator.aggregate(snapshot))
        t_agg = time.perf_counter() - t0
        self.metrics.last_aggregate_duration_s = sp_close.duration_s
        self.metrics.samples_aggregated += snapshot.total_samples()
        # The ladder first (level-1 pids lose local symbols, level-2 pids
        # collapse to scalar counts), then symbolize, which skips
        # laddered pids: a degraded profile is never symbolized again.
        profiles = apply_ladder(profiles, self._quarantine,
                                self._admission)
        sym_ms = None
        if self._symbolizer is not None:
            with tr.span("symbolize") as sp_sym:
                self._symbolizer.symbolize(profiles)
            self.metrics.last_symbolize_duration_s = sp_sym.duration_s
            sym_ms = sp_sym.duration_s * 1e3
        with tr.span("ship"):
            written = sum(
                self._write_one(prof.pid,
                                lambda p=prof: build_pprof(p, compress=False))
                for prof in profiles)
        tr.annotate(pids=len(profiles), path="scalar")
        if self._on_window is not None:
            record = {"window": window, "rows": len(snapshot),
                      "samples": snapshot.total_samples(),
                      "profiles": written,
                      "mass": sum(p.total() for p in profiles),
                      "aggregate_ms": t_agg * 1e3,
                      "window_ms": (time.perf_counter() - t0) * 1e3}
            if sym_ms is not None:
                record["symbolize_ms"] = sym_ms
            self._on_window(record)


class CPUProfiler(WindowLoop):
    """Fast-path window loop: counts -> WindowEncoder -> writer.

    ``on_window(record)`` is called once a window's profiles are written:
    on this thread for an inline encode, on the pipeline's worker for a
    pipelined one. The record holds the window's number (from 1), its
    rows, samples, exact mass, the pids written, the aggregate ms, the
    encode ms, the path ("inline" or "pipeline") and, for the pipeline,
    the hand-off ms on this thread; with a streaming feeder also whether
    the window streamed and the feeder's per-window seconds (feed,
    dispatch, settle, hash, coalesce, carry, close).
    """

    def __init__(self, source: CaptureSource, aggregator,
                 profile_writer=None, encode_pipeline: bool = True,
                 statics_cache_bytes: int = 256 << 20,
                 on_window: Callable[[dict], None] | None = None,
                 streaming_feeder=None, statics_store=None,
                 statics_snapshot_every: int = 6,
                 window_sink: Callable[[WindowSnapshot], None] | None = None,
                 device_timeout_s: float | None = 60.0,
                 device_health=None,
                 encode_deadline_s: float | None = None,
                 quarantine=None, trace_recorder=None,
                 duration_s: float = 10.0, identity=None, debuginfo=None,
                 symbolizer=None, labels_manager=None,
                 manage_gc: bool = False,
                 on_iteration: Callable[[int], None] | None = None,
                 admission=None, hotspot_store=None, sinks=None,
                 regression=None):
        if symbolizer is not None:
            # Profiles ship unsymbolized on this path (the server
            # symbolizes, as with the reference agent).
            raise ValueError(
                "fast_encode ships unsymbolized profiles; it cannot be "
                "combined with a local symbolizer")
        if not hasattr(aggregator, "window_counts"):
            raise ValueError(
                "fast_encode requires a dict-style aggregator "
                "(window_counts/close_window protocol)")
        super().__init__(source, profile_writer=profile_writer,
                         on_window=on_window, window_sink=window_sink,
                         device_timeout_s=device_timeout_s,
                         device_health=device_health, quarantine=quarantine,
                         trace_recorder=trace_recorder,
                         duration_s=duration_s, identity=identity,
                         debuginfo=debuginfo, labels_manager=labels_manager,
                         manage_gc=manage_gc, on_iteration=on_iteration,
                         admission=admission)
        self._aggregator = aggregator
        # The inline encode's soft deadline, and its abandoned encode.
        self._encode_deadline = encode_deadline_s or None
        self._encode_inflight = None
        self._encode_abandoned = None
        self._encoder = WindowEncoder(
            aggregator, statics_cache_bytes=statics_cache_bytes)
        # The warm statics snapshot is written on the encode worker only:
        # it reads the encoder's statics, which that thread owns. (Its
        # adoption, store.adopt(aggregator, encoder, period_ns), runs
        # before the first window.)
        snapshot = None
        if statics_store is not None:
            if encode_pipeline:
                snapshot = (lambda period_ns: statics_store.save(
                    self._aggregator, self._encoder, period_ns))
            else:
                _log.warn("statics snapshotting needs the encode "
                          "pipeline; snapshots disabled (adoption still "
                          "works)")
        # The analytics read the labels through the write lock; the
        # sinks' primary is this loop's own write path.
        self._hotspots = hotspot_store
        self._regression = regression
        for rider in (hotspot_store, regression):
            if rider is not None and labels_manager is not None \
                    and rider.labels_for is None:
                rider.labels_for = self._locked_labels_for
        self._sinks = sinks
        self._sinks_closed = False
        self._primary_written = 0
        if sinks is not None:
            sinks.bind(ship=self._ship_primary,
                       labels_for=(self._locked_labels_for
                                   if labels_manager is not None else None))
            # The inline path's prep stash only when a secondary reads it.
            self._encoder.track_prep = sinks.has_secondary
        rolls = hotspot_store is not None or regression is not None
        self._pipeline = (EncodePipeline(
            self._encoder, ship=self._ship_encoded, snapshot=snapshot,
            snapshot_every=statics_snapshot_every if snapshot else 0,
            rollup=self._rollup_window if rolls else None,
            rollup_capture=self._rollup_capture if rolls else None,
            # The sinks read the same registry view the rollups do.
            sink_capture=(self._rollup_capture if sinks is not None
                          and sinks.has_secondary else None))
                          if encode_pipeline else None)
        if not encode_pipeline:
            if hotspot_store is not None:
                _log.warn("hotspot rollups need the encode pipeline; "
                          "windows will not be folded")
            if regression is not None:
                _log.warn("the regression sentinel needs the encode "
                          "pipeline; windows will not be judged")
        self._feeder = streaming_feeder
        if streaming_feeder is not None:
            # Statics amortization: the feeder prebuilds static sections
            # after each drain, on the worker when the pipeline owns the
            # encoder.
            streaming_feeder.attach_encoder(
                self._encoder,
                prebuild=(self._pipeline.request_prebuild
                          if self._pipeline is not None else None))
        # Records of the windows handed to the worker, oldest first: the
        # worker ships them in order, one at a time.
        self._handed = collections.deque()

    @property
    def aggregator(self):
        return self._aggregator

    @property
    def encoder(self) -> WindowEncoder:
        return self._encoder

    @property
    def pipeline(self) -> EncodePipeline | None:
        return self._pipeline

    @property
    def feeder(self):
        return self._feeder

    def _before_window(self) -> None:
        # The error of a pipelined encode that failed since the last
        # window.
        self._raise_pipeline_error()

    def _window(self, snapshot: WindowSnapshot, window: int, tr) -> None:
        self._aggregate_encode_write(snapshot, window, tr)

    def close(self) -> None:
        """Flush the in-flight window and stop the worker; raises if a
        pipelined encode failed or the flush timed out."""
        if self._pipeline is not None:
            ok = self._pipeline.close(FLUSH_TIMEOUT_S)
            self._raise_pipeline_error()
            if not ok:
                raise RuntimeError("encode pipeline did not flush its last "
                                   f"window in {FLUSH_TIMEOUT_S} s")
        if self._sinks is not None and not self._sinks_closed:
            # After the pipeline drained, once: the AutoFDO accumulator's
            # final flush persists the partial interval.
            self._sinks_closed = True
            self._sinks.close()

    def _raise_pipeline_error(self) -> None:
        p = self._pipeline
        if p is not None and p.disabled and p.last_error is not None:
            raise RuntimeError("a pipelined window's encode failed; the "
                               "window was not shipped") from p.last_error

    def _window_counts(self, snapshot: WindowSnapshot):
        """The window's counts from the card: the streamed close, or
        window_counts of the snapshot."""
        feeder = self._feeder
        if feeder is not None and feeder.device_blocked():
            # An abandoned feed (stuck in a device wait) may still be
            # executing inside the aggregator: wait for it, as a device
            # wait of this call, before touching the aggregator.
            with device_wait():
                feeder.wait_unblocked()
        counts = None
        if feeder is not None:
            # The streamed close (None: the feeder did not see the whole
            # window, and the snapshot is aggregated here instead).
            counts = feeder.take_window_if_complete(snapshot)
        if counts is None:
            counts = self._aggregator.window_counts(snapshot)
        return counts

    def _aggregate_encode_write(self, snapshot: WindowSnapshot,
                                window: int, tr=NULL_TRACE) -> None:
        t0 = time.perf_counter()
        # The close span is the guarded device call; its duration also
        # sets the aggregate gauge, so gauge and histogram agree.
        with tr.span("close") as sp_close:
            counts = self.watchdog.call(
                lambda: self._window_counts(snapshot))
        agg_s = sp_close.duration_s
        self.metrics.last_aggregate_duration_s = agg_s
        self.metrics.samples_aggregated += snapshot.total_samples()
        self._record_close_spans(tr)
        record = {"window": window, "rows": len(snapshot),
                  "samples": snapshot.total_samples(),
                  "mass": int(np.asarray(counts).sum()),
                  "aggregate_ms": agg_s * 1e3, "t0": t0}
        if self._feeder is not None:
            fs = self._feeder.stats
            record["streamed"] = bool(fs["last_window_streamed"])
            record["feeder_s"] = {
                k[len("last_window_"):-len("_s")]: fs[k] for k in fs
                if k.startswith("last_window_") and k.endswith("_s")}
            record["feeder_s"]["close"] = (
                fs["last_close_s"] if record["streamed"] else 0.0)
        if self._submit_to_pipeline(counts, snapshot, record, tr):
            return
        out = self._encode_inline(counts, snapshot)
        if out is None:
            # The soft deadline fired (or its abandoned encode still owns
            # the encoder): the window ships scalar profiles.
            tr.annotate(path="scalar-deadline")
            with tr.span("ship"):
                n = self._write_scalar(counts, snapshot)
            record.update(path="scalar",
                          encode_ms=self.metrics.last_encode_duration_s
                          * 1e3)
            self._finish(record, n)
            return
        tr.add_span("encode", self.metrics.last_encode_duration_s)
        tr.annotate(path="inline")
        try:
            with tr.span("ship"):
                n = self._write_encoded(out)
        finally:
            # The secondaries run even when the pprof write raised: a
            # store outage must not starve them.
            if self._sinks is not None:
                self._emit_sinks_inline(out, snapshot)
        record.update(path="inline",
                      encode_ms=self.metrics.last_encode_duration_s * 1e3)
        self._finish(record, n)

    def _record_close_spans(self, tr) -> None:
        """The close's sub-spans, from the numbers the feeder and the
        aggregator already keep (so spans and stats agree): the streamed
        window's feed work split into dispatch, hash, coalesce and carry,
        its fetch, and the close's buffer flip and delta fetch."""
        if self._feeder is not None:
            fs = self._feeder.stats
            for key, stage in (("last_window_feed_s", "feed"),
                               ("last_window_dispatch_s",
                                "feed_dispatch_overlap"),
                               ("last_window_hash_s", "feed_hash"),
                               ("last_window_coalesce_s", "feed_coalesce"),
                               ("last_window_carry_s", "feed_carry")):
                if fs.get(key, 0.0):
                    tr.add_span(stage, fs[key])
            if fs.get("last_window_streamed", 0):
                tr.add_span("fetch", fs.get("last_close_s", 0.0))
        tim = self._aggregator.timings
        for stage in ("buffer_flip", "delta_fetch"):
            if tim.get(stage, 0.0):
                tr.add_span(stage, tim[stage])

    def _encode_inline(self, counts, snapshot: WindowSnapshot):
        """Encode on this thread; with encode_deadline_s, on an
        abandonable thread instead. None when the deadline fired or an
        abandoned encode still owns the encoder (the caller ships scalar
        profiles)."""
        if self._encode_inflight is not None:
            if not self._encode_inflight.is_set():
                self.metrics.last_encode_duration_s = 0.0
                return None
            if "err" in (self._encode_abandoned or {}):
                # The abandoned encode died mid-flight: the template may
                # be half-mutated. Drop the mirrors first.
                _log.warn("abandoned encode failed; resetting encoder",
                          error=repr(self._encode_abandoned["err"]))
                self._encoder.reset()
            self._encode_inflight = None
            self._encode_abandoned = None
        args = (snapshot.time_ns, snapshot.window_ns, snapshot.period_ns)
        t0 = time.perf_counter()
        try:
            if self._encode_deadline is None:
                return self._encoder.encode(counts, *args)
            # The counts view is only valid through the next close; an
            # abandoned encode may still be reading after that.
            counts_copy = np.asarray(counts).copy()
            status, out, done, box = bounded_call(
                lambda: self._encoder.encode(counts_copy, *args),
                self._encode_deadline, thread_name="encode-deadline")
            if status == "hang":
                self._encode_inflight = done
                self._encode_abandoned = box
                self.metrics.encode_deadline_hits_total += 1
                _log.warn("encode exceeded the soft deadline; shipping "
                          "scalar profiles for this window",
                          deadline_s=self._encode_deadline)
                return None
            if status == "err":
                raise out
            return out
        finally:
            self.metrics.last_encode_duration_s = time.perf_counter() - t0

    def _write_scalar(self, counts, snapshot: WindowSnapshot) -> int:
        """Ship each pid's scalar profile: one sample holding the pid's
        exact mass in this window's counts."""
        if self._sinks is not None:
            # No prepared window on this path: counted, never seen.
            self._sinks.count_skipped()
        counts = np.asarray(counts)
        id_pid = np.asarray(self._aggregator._id_pid[:len(counts)],
                            np.int64)
        live = counts > 0
        pids, inv = np.unique(id_pid[live], return_inverse=True)
        mass = np.bincount(inv, weights=counts[live].astype(np.float64),
                           minlength=len(pids)).astype(np.int64)
        n = 0
        for pid, m in zip(pids.tolist(), mass.tolist()):
            prof = scalar_profile(_PidTotal(pid, m, snapshot.period_ns,
                                            snapshot.time_ns,
                                            snapshot.window_ns))
            if self._write_one(pid,
                               lambda p=prof: build_pprof(p, compress=False)):
                n += 1
        self.metrics.scalar_windows_total += 1
        return n

    def _submit_to_pipeline(self, counts, snapshot: WindowSnapshot,
                            record: dict, tr=NULL_TRACE) -> bool:
        """Hand the closed window to the worker; False when this thread
        must encode it inline: no pipeline, or backpressure (the worker
        is then waited out first, so the encoder is this thread's)."""
        if self._pipeline is None:
            return False
        self._raise_pipeline_error()
        t0 = time.perf_counter()
        record["path"] = "pipeline"
        # Queued before the hand-off: the worker may ship the window
        # before submit returns (it waits for the hand-off's time before
        # reporting the window). Taken back if the hand-off fails.
        timed = threading.Event()
        self._handed.append((record, timed))
        try:
            n = self._pipeline.submit(counts, snapshot.time_ns,
                                      snapshot.window_ns, snapshot.period_ns,
                                      trace=tr)
        except BaseException:
            self._handed.pop()
            raise
        if n is not None:
            record["handoff_ms"] = (time.perf_counter() - t0) * 1e3
            tr.annotate(path="pipeline")
            timed.set()
            return True
        self._handed.pop()
        # Backpressure: the worker still owns the encoder. Park it
        # (bounded), then this window goes inline.
        self.metrics.encode_backpressure_total += 1
        if not self._pipeline.quiesce(FLUSH_TIMEOUT_S):
            raise RuntimeError("encode pipeline busy past its flush bound "
                               "and no fallback aggregator is configured")
        self._raise_pipeline_error()
        return False

    def _finish(self, record: dict, written: int) -> None:
        t0 = record.pop("t0")
        record["profiles"] = written
        record["window_ms"] = (time.perf_counter() - t0) * 1e3
        if self._on_window is not None:
            self._on_window(record)

    def _write_encoded(self, out) -> int:
        """Ship [(pid, blob)] from the encoder through the writer."""
        n = 0
        for pid, blob in out:
            if self._write_one(pid, lambda b=blob: b):
                n += 1
        return n

    def _ship_primary(self, out) -> None:
        """The sink registry's primary ship: the write path itself."""
        self._primary_written = self._write_encoded(out)

    def _ship_encoded(self, out, prep) -> None:
        """EncodePipeline ship hook (worker thread): with sinks, the
        registry runs the primary pprof ship (the same write path, the
        same bytes) and fans the window out to the secondaries, whose
        failures are counted there and never reach the pipeline's ship
        guard."""
        record, timed = self._handed.popleft()
        enc_s = self._pipeline.stats["last_encode_s"]
        self.metrics.last_encode_duration_s = enc_s
        if self._sinks is not None:
            self._primary_written = 0
            self._sinks.emit_window(out, prep)
            n = self._primary_written
        else:
            n = self._write_encoded(out)
        timed.wait(FLUSH_TIMEOUT_S)
        record["encode_ms"] = enc_s * 1e3
        self._finish(record, n)

    def _rollup_capture(self, prep):
        """EncodePipeline rollup-capture hook (this thread, at the
        hand-off): the per-id mirror references the fold will read,
        taken before the next window's first feed can rotate or compact
        them. A failure here is counted by the pipeline's guard."""
        from parca_agent_tpu_torch.runtime.hotspots import RegistryView

        return RegistryView(self._aggregator)

    def _rollup_window(self, prep, ctx) -> None:
        """EncodePipeline rollup hook (worker thread): fold the shipped
        window's live (id, count) rows into the hotspot store through
        the hand-off's registry view, then hand the same view to the
        regression sentinel. The sentinel rides in the finally arm (its
        fold never raises), so a hotspot fold failure, which propagates
        to the pipeline's rollup_errors counter, cannot starve the
        window's judgment."""
        try:
            if self._hotspots is not None:
                self._hotspots.fold_from_aggregator(
                    ctx, prep.idx, prep.vals, prep.time_ns,
                    prep.duration_ns)
        finally:
            if self._regression is not None:
                self._regression.fold_from_prepared(ctx, prep)

    def _emit_sinks_inline(self, out, snapshot: WindowSnapshot) -> None:
        """The secondaries of an inline-encoded window (this thread: no
        pipeline, or the hand-off was refused). The pprof bytes already
        shipped; the secondaries read the same prepared rows through a
        registry view taken here, the thread that rotates. Fail-open: a
        sink bug costs the sinks one window, never the iteration."""
        try:
            if not self._sinks.has_secondary:
                return
            prep = getattr(self._encoder, "last_prep", None)
            if prep is None or prep.time_ns != snapshot.time_ns:
                # The encoder did not stash this window: skip rather
                # than misattribute.
                self._sinks.count_skipped()
                return
            from parca_agent_tpu_torch.runtime.hotspots import RegistryView

            prep.sink_ctx = RegistryView(self._aggregator)
            self._sinks.emit_secondary(out, prep)
        except Exception as e:  # noqa: BLE001 - sinks are best-effort
            self._sinks.count_capture_error()
            _log.warn("inline sink fan-out failed; window skipped for "
                      "secondary sinks", error=repr(e))
