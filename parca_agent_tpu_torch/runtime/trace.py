"""Window flight recorder: per-window lifecycle traces, streaming stage
histograms, and slow-window auto-capture.

The port's copy of parca_agent_tpu's runtime/trace.py, whole:

  * ``WindowTrace`` — one trace per window, trace id = window seq,
    carrying per-stage spans (drain, close, feed, fetch, prepare,
    statics, encode, ship, total) recorded by the profiler loop, the
    encode pipeline's worker, and the encoder.
  * ``FlightRecorder`` — a bounded ring of completed traces plus one
    streaming log-bucket histogram per stage (p50/p90/p99/max). Stages
    that are not per-window (the encoder's per-call statics builds) feed
    the same histograms through :func:`observe`.
  * A slow-window detector: a span whose duration exceeds
    ``slow_multiple`` x the stage's RUNNING p99 (with a sample-count
    gate and an absolute floor) auto-captures an incident — the
    offending trace and the current supervisor/device/quarantine state —
    into a crash-only tmp+rename JSON file, rate-limited and counted.
    The incident also bundles a self-pprof of the agent
    (profiler/selfprofile.py, sampled for ``self_profile_s``, or the
    caller's ``self_profile``; ``self_profile_error`` says why not when
    that fails).

Tracing is FAIL-OPEN by contract: every recorder entry point swallows
its own errors (counted in ``stats["record_errors"]``), so a broken or
chaos-injected tracing path can never stall or lose a window. The chaos
sites ``trace.record`` and ``incident.dump`` (utils/faults.py) exist to
prove exactly that.

Like ``utils/faults.py``, a process-global recorder can be installed so
deep components (the encoder) observe stage durations without plumbing:
each site pays one module-attribute read when tracing is off. Nothing
here touches the device.
"""

from __future__ import annotations

import base64
import collections
import json
import os
import threading
import time

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

_log = get_logger("trace")

# palint: persistence-root — incident files are read by operators post-crash.


# Log-spaced bucket upper bounds in seconds: 10 us doubling to ~671 s.
# 27 finite buckets + the implicit +Inf bucket cover everything from a
# sub-ms host-side stage to the >420 s device hangs on record.
BUCKET_BOUNDS = tuple(1e-5 * (2.0 ** i) for i in range(27))

# The spans every complete fast-path (dict aggregator + fast encode)
# window trace carries; `make trace-smoke` and the integration tests
# assert these. Scalar-path traces replace prepare/encode with
# symbolize-less builder work and still carry drain/close/ship.
MANDATORY_SPANS = ("drain", "close", "prepare", "encode", "ship")


class StageHistogram:
    """One streaming log-bucket histogram: fixed bounds, cumulative-free
    per-bucket counts (cumulated at export), running sum/count/max.
    Mutation is serialized by the owning recorder's lock."""

    __slots__ = ("counts", "count", "sum_s", "max_s")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def observe(self, dur_s: float) -> None:
        dur_s = max(0.0, float(dur_s))
        lo, hi = 0, len(BUCKET_BOUNDS)
        while lo < hi:  # first bound >= dur_s (inlined bisect: no import)
            mid = (lo + hi) // 2
            if BUCKET_BOUNDS[mid] < dur_s:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.count += 1
        self.sum_s += dur_s
        if dur_s > self.max_s:
            self.max_s = dur_s

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate. With log-spaced
        buckets the true value is within one bucket ratio (2x) of the
        estimate — good enough for budgets and dashboards, and the max
        is tracked exactly alongside."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i >= len(BUCKET_BOUNDS):
                    return self.max_s
                lo = BUCKET_BOUNDS[i - 1] if i else 0.0
                # Cap at the exact max (all-zero stages report 0, not
                # half a bucket bound); observations in bucket i are
                # strictly above lo, so max(hi, lo) only guards the
                # zero-bucket case.
                hi = min(BUCKET_BOUNDS[i], self.max_s)
                frac = (rank - (seen - c)) / c
                return lo + (max(hi, lo) - lo) * frac
        return self.max_s

    def export(self) -> dict:
        """Cumulative buckets + summary stats (the /metrics shape)."""
        cum, acc = [], 0
        for i, c in enumerate(self.counts[:-1]):
            acc += c
            cum.append((BUCKET_BOUNDS[i], acc))
        return {
            "buckets": cum,             # [(le_seconds, cumulative_count)]
            "count": self.count,        # == the +Inf cumulative bucket
            "sum_s": self.sum_s,
            "max_s": self.max_s,
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
        }


class _SpanCtx:
    """Context manager for one timed span. Always measures (the gauges
    that must stay in lockstep with the histograms read .duration_s even
    when tracing is disabled); recording is the trace's problem and is
    fail-open there. User exceptions are recorded and re-raised."""

    __slots__ = ("_trace", "_stage", "_t0", "duration_s")

    def __init__(self, trace, stage: str):
        self._trace = trace
        self._stage = stage
        self.duration_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.duration_s = time.perf_counter() - self._t0
        self._trace.add_span(
            self._stage, self.duration_s,
            error=(repr(ev)[:200] if ev is not None else None))
        return False


class _NullTrace:
    """The do-nothing trace: call sites never branch on whether tracing
    is enabled. Spans still measure (see _SpanCtx) but record nowhere."""

    seq = 0
    completed = True
    detached = False

    def span(self, stage: str) -> _SpanCtx:
        return _SpanCtx(self, stage)

    def add_span(self, stage, duration_s, error=None,
                 histogram=True) -> None:
        pass

    def annotate(self, **kv) -> None:
        pass

    def detach(self) -> None:
        pass

    def finish(self, error: str | None = None) -> None:
        pass

    def complete(self, error: str | None = None) -> None:
        pass

    def discard(self) -> None:
        pass


NULL_TRACE = _NullTrace()


class WindowTrace:
    """One window's lifecycle. Created by FlightRecorder.begin on the
    profiler thread; ownership may transfer to the encode pipeline's
    worker (detach) — the hand-off lock gives the happens-before edge,
    so spans never need their own lock. complete() is idempotent and
    routes through the recorder (ring + histograms + slow detector)."""

    __slots__ = ("seq", "time_ns", "t0_s", "spans", "meta", "error",
                 "completed", "detached", "_rec")

    def __init__(self, rec, seq: int, time_ns: int):
        self._rec = rec
        self.seq = seq
        self.time_ns = time_ns
        self.t0_s = time.perf_counter()
        self.spans: list[dict] = []
        self.meta: dict = {}
        self.error: str | None = None
        self.completed = False
        self.detached = False

    def span(self, stage: str) -> _SpanCtx:
        return _SpanCtx(self, stage)

    # palint: fail-open
    def add_span(self, stage: str, duration_s: float,
                 error: str | None = None,
                 histogram: bool = True) -> None:
        """Record one span; fail-open (a tracing fault must never cost
        the window — the trace.record chaos site injects exactly here).
        ``histogram=False`` keeps the span out of the stage histograms
        at completion: for stages whose histogram is fed elsewhere
        (the encoder observes each statics build per call; the worker's
        per-window statics span would double-count it)."""
        try:
            faults.inject("trace.record")
            now = time.perf_counter()
            self.spans.append({
                "stage": stage,
                "start_s": round(max(0.0, now - duration_s - self.t0_s), 6),
                "duration_s": round(float(duration_s), 6),
                "thread": threading.current_thread().name,
                **({} if histogram else {"nohist": True}),
                **({"error": error} if error else {}),
            })
        except Exception as e:  # noqa: BLE001 - tracing is fail-open
            self._rec._record_error(e)

    # palint: fail-open
    def annotate(self, **kv) -> None:
        try:
            # Rebind, don't mutate: a detached trace may already be in
            # the ring (the worker completed it) while the profiler
            # thread annotates a late iteration error — a concurrent
            # /debug/windows json.dumps must see the old dict or the
            # new one, never one resizing mid-iteration. The recorder
            # lock serializes against complete()'s slow_stage rebind —
            # two unlocked rebinds would lose one writer's keys.
            with self._rec._lock:
                self.meta = {**self.meta, **kv}
        except Exception as e:  # noqa: BLE001 - tracing is fail-open
            self._rec._record_error(e)

    def detach(self) -> None:
        """Ownership moved to another thread (the encode worker): the
        profiler loop's end-of-iteration complete() becomes a no-op."""
        self.detached = True

    def finish(self, error: str | None = None) -> None:
        """The profiler loop's end-of-iteration completion. Detached
        traces are NEVER completed from here — the encode worker owns
        them (completing one early would race the worker's span writes
        and drop its encode/ship samples from the histograms); an
        iteration error that co-occurs with a successful hand-off (e.g.
        a debuginfo upload failure) is annotated instead, so it still
        shows on /debug/windows without stealing the completion."""
        if self.detached:
            if error is not None:
                self.annotate(iteration_error=error)
            return
        self._rec.complete(self, error=error)

    def complete(self, error: str | None = None) -> None:
        self._rec.complete(self, error=error)

    def discard(self) -> None:
        self._rec.discard(self)

    def to_dict(self) -> dict:
        total = next((s["duration_s"] for s in self.spans
                      if s["stage"] == "total"), None)
        d = {
            "seq": self.seq,
            "time_ns": self.time_ns,
            "complete": self.completed,
            "duration_s": total if total is not None else round(
                sum(s["duration_s"] for s in self.spans), 6),
            "spans": list(self.spans),
        }
        if self.meta:
            d["meta"] = dict(self.meta)
        if self.error:
            d["error"] = self.error
        return d


class FlightRecorder:
    """The per-process window flight recorder (module docs above).

    ``context`` is a zero-arg callable returning a JSON-able dict of
    runtime state for incident files (the CLI wires supervisor/device/
    quarantine snapshots via set_context after those exist);
    ``self_profile`` a zero-arg callable returning gzipped pprof bytes
    (by default profiler/selfprofile.py's ``profile_self`` over
    ``self_profile_s``).
    ``incident_dir`` empty disables incident files (slow windows are
    still detected and counted)."""

    def __init__(self, ring: int = 512, slow_multiple: float = 5.0,
                 min_count: int = 8, min_duration_s: float = 0.05,
                 incident_dir: str = "", incident_interval_s: float = 300.0,
                 max_incidents: int = 64, self_profile_s: float = 1.0,
                 context=None, self_profile=None, clock=time.monotonic):
        self._lock = threading.Lock()
        # guarded-by: _lock (the next three + stats below): the profiler
        # thread, the encode worker and every reader meet here; two
        # unlocked writers would lose each other's updates.
        self._ring: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=max(1, ring))
        self._hists: dict[str, StageHistogram] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._slow_multiple = slow_multiple
        self._min_count = max(1, min_count)
        self._min_duration = min_duration_s
        self._incident_dir = incident_dir
        self._incident_interval = incident_interval_s
        self._max_incidents = max(1, max_incidents)
        self._last_incident_at: float | None = None
        self._dumping = False
        self._clock = clock
        self._context = context
        self._self_profile = self_profile
        self._self_profile_s = self_profile_s
        if incident_dir:
            os.makedirs(incident_dir, exist_ok=True)
        self.stats = {  # guarded-by: _lock
            "traces_started": 0,
            "traces_completed": 0,
            "traces_discarded": 0,
            "record_errors": 0,
            "slow_spans_total": 0,
            "incidents_written": 0,
            "incidents_suppressed": 0,
            "incidents_failed": 0,
        }

    # -- configuration -------------------------------------------------------

    def set_context(self, context) -> None:
        """Late-bind the incident context provider (the CLI builds the
        recorder before the supervisor exists)."""
        self._context = context

    # -- trace lifecycle -----------------------------------------------------

    # palint: fail-open
    def begin(self, time_ns: int | None = None):
        """Start the next window's trace. Fail-open: any internal error
        returns the NULL trace so the window proceeds untraced."""
        try:
            faults.inject("trace.record")
            with self._lock:
                self._seq += 1
                seq = self._seq
                self.stats["traces_started"] += 1
            return WindowTrace(self, seq,
                               time_ns if time_ns is not None
                               else time.time_ns())
        except Exception as e:  # noqa: BLE001 - tracing is fail-open
            self._record_error(e)
            return NULL_TRACE

    # palint: fail-open
    def complete(self, trace: WindowTrace, error: str | None = None) -> None:
        """Finish a trace: total span, ring append, histogram feed, slow
        detection. Idempotent; fail-open."""
        try:
            faults.inject("trace.record")
            with self._lock:
                if trace.completed:
                    return
                trace.completed = True
            if error:
                trace.error = error
            total_s = time.perf_counter() - trace.t0_s
            trace.spans.append({
                "stage": "total",
                "start_s": 0.0,
                "duration_s": round(total_s, 6),
                "thread": threading.current_thread().name,
            })
            worst = None  # (ratio, stage, duration, budget)
            with self._lock:
                for s in trace.spans:
                    stage, dur = s["stage"], s["duration_s"]
                    if s.pop("nohist", False):
                        # This stage's histogram AND slow detection are
                        # fed per-call elsewhere (encoder statics via
                        # observe()); the per-window aggregate span is
                        # display-only — a churn window summing N fast
                        # builds must not trip a budget derived from
                        # per-call samples.
                        continue
                    budget = self._budget_locked(stage)
                    if budget is not None and dur > budget:
                        self.stats["slow_spans_total"] += 1
                        s["slow"] = True
                        if worst is None or dur / budget > worst[0]:
                            worst = (dur / budget, stage, dur, budget)
                    self._hists.setdefault(
                        stage, StageHistogram()).observe(dur)
                if worst is not None:
                    # Rebind, don't mutate: the trace is already visible
                    # to /debug/windows serialization (see annotate(),
                    # which shares this lock so neither rebind is lost).
                    trace.meta = {**trace.meta, "slow_stage": worst[1]}
                self._ring.append(trace)
                self.stats["traces_completed"] += 1
            if worst is not None:
                self._capture_incident(trace, worst)
        except Exception as e:  # noqa: BLE001 - tracing is fail-open
            self._record_error(e)

    # palint: fail-open
    def discard(self, trace) -> None:
        """Drop a trace that never became a window (source exhausted):
        not ringed, not histogrammed."""
        try:
            with self._lock:
                if not getattr(trace, "completed", True):
                    trace.completed = True
                    self.stats["traces_discarded"] += 1
        except Exception as e:  # noqa: BLE001 - tracing is fail-open
            self._record_error(e)

    # palint: fail-open
    def observe(self, stage: str, duration_s: float) -> None:
        """Feed one non-per-window stage observation (batch flush, store
        ack, spool spill/replay) into its histogram + the slow detector.
        Fail-open."""
        try:
            faults.inject("trace.record")
            slow = None
            with self._lock:
                budget = self._budget_locked(stage)
                if budget is not None and duration_s > budget:
                    self.stats["slow_spans_total"] += 1
                    slow = (duration_s / budget, stage, duration_s, budget)
                self._hists.setdefault(
                    stage, StageHistogram()).observe(duration_s)
            if slow is not None:
                self._capture_incident(None, slow)
        except Exception as e:  # noqa: BLE001 - tracing is fail-open
            self._record_error(e)

    def _record_error(self, e: Exception) -> None:
        try:
            with self._lock:
                self.stats["record_errors"] += 1
            _log.debug("trace recording failed (fail-open)", error=repr(e))
        except Exception:  # noqa: BLE001 - never escalate from here
            pass

    # -- slow-window detection / incidents -----------------------------------

    def _budget_locked(self, stage: str) -> float | None:  # palint: holds=_lock
        """Stage budget = slow_multiple x running p99, floored at
        min_duration_s; None until min_count samples exist (a budget
        computed from two observations is noise, not a contract)."""
        h = self._hists.get(stage)
        if h is None or h.count < self._min_count:
            return None
        return max(self._slow_multiple * h.quantile(0.99),
                   self._min_duration)

    def _capture_incident(self, trace, worst) -> None:
        """Rate-limited, single-flight incident capture on a daemon
        thread (the self-profile samples for self_profile_s seconds —
        never on the window path)."""
        _ratio, stage, dur, budget = worst
        with self._lock:
            now = self._clock()
            if self._dumping or (
                    self._last_incident_at is not None
                    and now - self._last_incident_at
                    < self._incident_interval):
                self.stats["incidents_suppressed"] += 1
                return
            self._last_incident_at = now
            if not self._incident_dir:
                self.stats["incidents_suppressed"] += 1
                return
            self._dumping = True
        _log.warn("slow window detected; capturing incident",
                  stage=stage, duration_s=round(dur, 3),
                  budget_s=round(budget, 3),
                  seq=getattr(trace, "seq", None))
        threading.Thread(
            target=self._dump_incident, args=(trace, stage, dur, budget),
            name="trace-incident", daemon=True).start()

    def capture_event(self, kind: str, stage: str, detail: dict) -> bool:
        """External incident capture — the device flight recorder routes
        recompile storms here (runtime/device_telemetry.py). Same rate
        limiter, single-flight daemon thread, context/self-profile
        bundle, and pruning as slow-window capture; the incident file
        carries the caller's ``kind`` and ``detail`` payload. Returns
        False when suppressed (rate limit, capture in flight, no
        incident dir)."""
        with self._lock:
            now = self._clock()
            if self._dumping or (
                    self._last_incident_at is not None
                    and now - self._last_incident_at
                    < self._incident_interval):
                self.stats["incidents_suppressed"] += 1
                return False
            self._last_incident_at = now
            if not self._incident_dir:
                self.stats["incidents_suppressed"] += 1
                return False
            self._dumping = True
        _log.warn("external incident; capturing", kind=kind, stage=stage)
        threading.Thread(
            target=self._dump_incident, args=(None, stage, 0.0, 0.0),
            kwargs={"kind": kind, "detail": detail},
            name="trace-incident", daemon=True).start()
        return True

    def flush_incident(self, kind: str, stage: str, detail: dict):
        """Write one incident file NOW, on this thread, with the ring's
        newest trace: for a run about to end (a device hang), where the
        rate-limited daemon-thread capture could be cut by the exit. Not
        rate-limited. Returns the file's path, or None (no incident dir,
        or the write failed: counted)."""
        if not self._incident_dir:
            return None
        with self._lock:
            self._dumping = True
            trace = self._ring[-1] if self._ring else None
        return self._dump_incident(trace, stage, 0.0, 0.0, kind=kind,
                                   detail=detail)

    def _dump_incident(self, trace, stage: str, dur: float,
                       budget: float, kind: str = "slow_window",
                       detail: dict | None = None) -> None:
        try:
            faults.inject("incident.dump")
            body = {
                "kind": kind,
                "stage": stage,
                "duration_s": round(dur, 6),
                "budget_s": round(budget, 6),
                "slow_multiple": self._slow_multiple,
                "captured_at_ns": time.time_ns(),
                "trace": trace.to_dict() if trace is not None else None,
                "stage_percentiles": self.percentiles(),
            }
            if detail is not None:
                body["detail"] = detail
            if self._context is not None:
                try:
                    body["context"] = self._context()
                except Exception as e:  # noqa: BLE001 - partial > none
                    body["context_error"] = repr(e)[:200]
            try:
                prof = self._self_profile_bytes()
                body["self_profile_pprof_gz_b64"] = \
                    base64.b64encode(prof).decode()
            except Exception as e:  # noqa: BLE001 - partial > none
                body["self_profile_error"] = repr(e)[:200]
            seq = getattr(trace, "seq", 0) or 0
            path = os.path.join(
                self._incident_dir,
                f"incident-{time.strftime('%Y%m%dT%H%M%S')}"
                f"-w{seq:06d}-{stage}.json")
            atomic_write_bytes(
                path, json.dumps(body, indent=1).encode())
            self._prune_incidents()
            with self._lock:
                self.stats["incidents_written"] += 1
            _log.warn("incident captured", path=path)
            return path
        except Exception as e:  # noqa: BLE001 - incidents are best-effort
            with self._lock:
                self.stats["incidents_failed"] += 1
            _log.warn("incident capture failed", error=repr(e))
            return None
        finally:
            with self._lock:
                self._dumping = False

    def _self_profile_bytes(self) -> bytes:
        if self._self_profile is not None:
            return self._self_profile()
        from parca_agent_tpu_torch.profiler.selfprofile import profile_self

        return profile_self(self._self_profile_s)

    def _prune_incidents(self) -> None:
        """Keep the newest max_incidents files: an agent stuck slow must
        not fill the disk with its own forensics."""
        try:
            names = sorted(n for n in os.listdir(self._incident_dir)
                           if n.startswith("incident-")
                           and n.endswith(".json"))
            for n in names[:-self._max_incidents]:
                os.unlink(os.path.join(self._incident_dir, n))
        except OSError:  # pragma: no cover - prune is best-effort
            pass

    # -- read side (HTTP thread) ---------------------------------------------

    def traces(self, limit: int | None = None) -> list[dict]:
        """The ring, oldest first, as wide-event dicts (/debug/windows)."""
        with self._lock:
            out = [t.to_dict() for t in self._ring]
        return out[-limit:] if limit else out

    def trace(self, seq: int) -> dict | None:
        with self._lock:
            for t in self._ring:
                if t.seq == seq:
                    return t.to_dict()
        return None

    def export_histograms(self) -> dict[str, dict]:
        """{stage: StageHistogram.export()} for /metrics rendering."""
        with self._lock:
            return {stage: h.export()
                    for stage, h in sorted(self._hists.items())}

    def percentiles(self) -> dict[str, dict]:
        """{stage: {p50_ms, p90_ms, p99_ms, max_ms, count}} — the compact
        distribution stamp (bench JSON, incident files)."""
        with self._lock:
            return {
                stage: {
                    "p50_ms": round(h.quantile(0.50) * 1e3, 3),
                    "p90_ms": round(h.quantile(0.90) * 1e3, 3),
                    "p99_ms": round(h.quantile(0.99) * 1e3, 3),
                    "max_ms": round(h.max_s * 1e3, 3),
                    "count": h.count,
                }
                for stage, h in sorted(self._hists.items())
            }


# -- process-global installation (the faults.py pattern) ----------------------

_active: FlightRecorder | None = None


def install(recorder: FlightRecorder | None) -> None:
    """Install (or with None, remove) the process-wide recorder. The CLI
    calls this once at startup; tests install/uninstall around cases."""
    global _active
    _active = recorder


def get() -> FlightRecorder | None:
    return _active


def observe(stage: str, duration_s: float) -> None:
    """The deep-component hook (batch client, spool, gRPC client,
    encoder): free when no recorder is installed."""
    if _active is not None:
        _active.observe(stage, duration_s)
