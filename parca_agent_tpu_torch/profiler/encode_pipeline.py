"""Double-buffered background pprof encode pipeline.

The port's copy of parca_agent_tpu's profiler/encode_pipeline.py. Run
on one thread, aggregate -> encode -> ship lets the encoder's slow
transients (a cold statics build, a first template layout, a rebuild
after a compaction at 50k pids) stall the capture loop. This pipeline
moves encode + ship onto a dedicated worker thread:

  * Window close hands the aggregated counts over via submit() — the only
    profiler-thread work is WindowEncoder.prepare() (mirror sync + live
    filter + registry caps), a bounded slice of the old inline cost — and
    capture of window N+1 then overlaps encoding/shipping of window N.
  * The hand-off queue is two slots deep: the window the worker is
    encoding plus the shutdown sentinel. There is deliberately NO deeper
    backlog — a second pending window would need its mirrors synced while
    the worker still reads them. If the worker is still busy at the next
    close, submit() refuses (backpressure), counted and observable, and
    the caller ships that window itself.
  * A drain-tick statics prebuild is routed here too (request_prebuild),
    so ALL encoder-state touches outside prepare()
    happen on the worker thread — the encoder's thread-ownership
    contract (pprof/window_encoder.py module docs). A prebuild in
    progress yields at its next budget batch when a hand-off (or
    shutdown) needs the worker parked.
  * A worker exception ships the failed window through the caller's
    fallback, resets the encoder's mirrors, and disables the pipeline —
    the profiler reverts to its inline path; with a fallback no window
    is lost (without one the loss is counted in windows_lost). The
    port's fast loop passes none: profiler/cpu.py raises the error.
  * A warm statics snapshot hook may ride this worker too: every
    snapshot_every-th shipped window, the worker calls it, so a restart
    can adopt instead of rebuilding. Worker-thread-only by design — the
    snapshot reads the same encoder state prebuilds do, and must never
    stall capture. (No snapshot store is ported yet; the hook defaults
    to None.)
  * close() flushes the in-flight window before stopping the worker, so
    a draining agent ships everything it aggregated.
"""

from __future__ import annotations

import threading
import time

from parca_agent_tpu_torch.runtime.trace import NULL_TRACE
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("encode-pipeline")

THREAD_NAME = "encode-pipeline"


class EncodePipeline:
    """One worker thread + a two-slot hand-off around a WindowEncoder.

    `ship(out, prep)` is called on the worker thread with the encoded
    [(pid, blob)] list and the _PreparedWindow; blobs are zero-copy
    memoryviews into the template buffer (valid until the next encode —
    i.e. for the whole ship call) unless ship_views=False.
    """

    def __init__(self, encoder, ship, ship_views: bool = True,
                 name: str = THREAD_NAME, snapshot=None,
                 snapshot_every: int = 0, rollup=None,
                 rollup_capture=None, sink_capture=None):
        self._enc = encoder
        self._ship = ship
        self._views = ship_views
        self._name = name
        # Output-backend capture hook: `sink_capture(prep)` runs
        # on the PROFILER thread at hand-off and its result rides the
        # prepared window as `prep.sink_ctx` — the rotation-consistent
        # registry view the secondary sinks read on this worker during
        # the ship fan-out. Best-effort: a capture failure is counted
        # and the window ships with sink_ctx=None (frame-reading sinks
        # skip it, the pprof ship is unaffected).
        self._sink_capture = sink_capture
        # Hotspot rollup hook: a `rollup(prep, ctx)`
        # callable run on THIS worker thread after every shipped window.
        # `ctx` is whatever `rollup_capture(prep)` returned on the
        # PROFILER thread at hand-off — a rotation-consistent registry
        # view; the fold must read per-id mirrors through it, because a
        # cold-stack rotation (profiler thread, next window's first
        # feed) compacts the live arrays under a still-running fold.
        # Errors are counted, never fatal: a rollup bug costs query
        # freshness, not a window.
        self._rollup = rollup
        self._rollup_capture = rollup_capture
        # Warm statics snapshot hook: a
        # `snapshot(period_ns)` callable run on THIS worker thread after
        # every snapshot_every-th shipped window — the one thread that
        # may read the encoder's statics map, and by construction never
        # the capture thread. A snapshot failure is counted, never fatal
        # (the agent just stays cold-restartable one interval longer).
        self._snapshot = snapshot
        self._snapshot_every = snapshot_every
        self._cond = threading.Condition()
        self._window = None   # pending (prep, ctx, fallback, trace) hand-off
        self._prebuild = None        # latest coalesced (period_ns, budget_s)
        self._state = "idle"         # idle | encode | prebuild
        self._handoff = False        # profiler parked the worker
        self._interrupt = threading.Event()  # yields a running prebuild
        self._stopping = False
        self._thread: threading.Thread | None = None
        self.disabled = False
        self.last_error: Exception | None = None
        self.stats = {
            "windows_pipelined": 0,
            "windows_lost": 0,
            "ship_errors": 0,
            "backpressure_fallbacks": 0,
            "prebuilds": 0,
            "encoder_exceptions": 0,
            "last_handoff_s": 0.0,
            "last_encode_s": 0.0,
            "last_ship_s": 0.0,
            "overlap_s_total": 0.0,
            "snapshots_written": 0,
            "snapshot_errors": 0,
            "last_snapshot_s": 0.0,
            "windows_rolled": 0,
            "rollup_errors": 0,
            "last_rollup_s": 0.0,
            "sink_capture_errors": 0,
        }

    # -- profiler-thread API -------------------------------------------------

    def submit(self, counts, time_ns: int, duration_ns: int, period_ns: int,
               fallback=None, trace=NULL_TRACE) -> int | None:
        """Hand one closed window to the worker. Returns the number of
        live pids handed off, or None when the pipeline is disabled or
        still busy with the previous window (backpressure — the caller
        must ship the window itself).
        `fallback`, a zero-arg callable, re-aggregates and ships the
        window if the worker dies on it. `trace`, the window's
        WindowTrace, detaches on a successful hand-off: the worker
        records the encode/ship spans and completes it after the ship.
        Profiler thread only."""
        if self.disabled or self._stopping:
            return None
        t0 = time.perf_counter()
        with self._cond:
            if self._state == "encode" or self._window is not None:
                self.stats["backpressure_fallbacks"] += 1
                return None
            # Park the worker: a budgeted prebuild yields at its next
            # batch boundary; nothing new starts while _handoff is set.
            self._handoff = True
            self._interrupt.set()
            while self._state != "idle":
                self._cond.wait()
        try:
            with trace.span("prepare"):
                prep = self._enc.prepare(counts, time_ns, duration_ns,
                                         period_ns)
        except BaseException:
            with self._cond:
                self._handoff = False
                self._interrupt.clear()
                self._cond.notify_all()
            raise
        trace.detach()
        if self._sink_capture is not None:
            # Still the profiler thread (rotation cannot interleave):
            # the captured view brackets the prepared ids exactly, same
            # reasoning as the rollup capture below.
            try:
                prep.sink_ctx = self._sink_capture(prep)
            except Exception as e:  # noqa: BLE001 - sinks are best-effort
                self.stats["sink_capture_errors"] += 1
                _log.warn("sink context capture failed; secondary sinks "
                          "skip this window", error=repr(e))
        rollup_ctx = None
        if self._rollup is not None and self._rollup_capture is not None:
            if self._rollup_capture is self._sink_capture \
                    and prep.sink_ctx is not None:
                # The profiler registers the SAME capture hook for both
                # consumers (one definition of "safe to read
                # off-thread"): reuse the view captured above instead of
                # building an identical one on the hand-off path.
                rollup_ctx = prep.sink_ctx
            else:
                # Still the profiler thread: rotation cannot interleave,
                # so the captured view brackets the prepared ids exactly.
                try:
                    rollup_ctx = self._rollup_capture(prep)
                except Exception as e:  # noqa: BLE001 - best-effort
                    self.stats["rollup_errors"] += 1
                    _log.warn("hotspot rollup capture failed; window "
                              "will ship unfolded", error=repr(e))
        with self._cond:
            # Enqueue and unpark in ONE lock acquisition: clearing
            # _handoff first would let a pending prebuild slip in ahead
            # of the window (with _interrupt already cleared, nothing
            # would yield it) and delay the encode by a whole budget.
            self._window = (prep, rollup_ctx, fallback, trace)
            self._handoff = False
            self._interrupt.clear()
            self._cond.notify_all()
        self._ensure_thread()
        self.stats["last_handoff_s"] = time.perf_counter() - t0
        return len(prep.caps)

    def request_prebuild(self, period_ns: int,
                         budget_s: float = 0.25) -> None:
        """Ask the worker to run one budgeted statics prebuild pass when
        it is next free (a drain tick). Coalescing:
        only the latest request is kept. Never blocks."""
        if self.disabled or self._stopping or not period_ns:
            return
        with self._cond:
            self._prebuild = (int(period_ns), float(budget_s))
            self._cond.notify_all()
        self._ensure_thread()

    @property
    def busy(self) -> bool:
        with self._cond:
            return self._window is not None or self._state == "encode"

    def flush(self, timeout_s: float = 60.0) -> bool:
        """Block until no window is pending or being encoded (pending
        prebuilds are not waited for). False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._window is not None or self._state == "encode":
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def quiesce(self, timeout_s: float = 60.0) -> bool:
        """flush() plus drain any pending prebuild: the worker is fully
        parked on return (tests/bench sequencing). False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while (self._window is not None or self._prebuild is not None
                    or self._state != "idle"):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def close(self, timeout_s: float = 60.0) -> bool:
        """Flush the in-flight window, then stop the worker. False if the
        flush or join timed out."""
        ok = self.flush(timeout_s)
        with self._cond:
            self._stopping = True
            self._interrupt.set()
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
            ok = ok and not t.is_alive()
        return ok

    # -- worker --------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run,
                                            name=self._name, daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while (not self._stopping and self._window is None
                        and (self._prebuild is None or self._handoff)):
                    self._cond.wait()
                if self._window is not None:
                    job, self._window = ("window", self._window), None
                    self._state = "encode"
                elif self._stopping:
                    return
                else:
                    job, self._prebuild = ("prebuild", self._prebuild), None
                    self._state = "prebuild"
                self._cond.notify_all()
            try:
                if job[0] == "window":
                    self._do_window(*job[1])
                else:
                    period_ns, budget_s = job[1]
                    self._enc.build_statics(period_ns, budget_s=budget_s,
                                            stop=self._interrupt,
                                            prepare_order=True)
                    self.stats["prebuilds"] += 1
            except Exception as e:  # noqa: BLE001 - surfaced via disable
                if job[0] == "window":
                    self._fail_window(e, job[1][2], job[1][3])
                    with self._cond:
                        self._state = "idle"
                        self._cond.notify_all()
                    return  # disabled: the worker's work here is done
                # A prebuild failure is non-fatal: staleness guards still
                # trip, the next pass (or encode) retries the build.
                _log.warn("statics prebuild failed on the encode worker",
                          error=repr(e))
            finally:
                with self._cond:
                    if self._state != "idle":
                        self._state = "idle"
                        self._cond.notify_all()

    def revive(self, reset: bool = False) -> None:
        """Re-arm a pipeline disabled by a worker death: clear the
        disabled latch so the next submit() restarts the worker thread.
        The encoder's mirrors were already reset by _fail_window;
        ``reset=True`` forces another reset for callers reviving after
        external encoder surgery. Fail-open: a reset that raises leaves
        the pipeline disabled."""
        try:
            if reset:
                self._enc.reset()
            self.disabled = False
            self.last_error = None
            _log.info("encode pipeline revived")
        except Exception as e:  # noqa: BLE001 - revive contract
            _log.warn("encoder reset failed during revive; pipeline "
                      "stays disabled until the next probe tick",
                      error=repr(e))

    def _do_window(self, prep, rollup_ctx, fallback,
                   trace=NULL_TRACE) -> None:
        t0 = time.perf_counter()
        # Chaos site: an injected crash here is a worker death — the
        # pipeline disables and counts the window, and a supervisor's
        # probe revives it (cli.py).
        faults.inject("actor.encode")
        # Statics work that runs inside this encode (a cold build, a
        # post-rotation rebuild) is the latency cliff the trace exists
        # for: span it from the encoder's own accumulated-build clock so
        # the span and the encoder's stats can never disagree.
        statics0 = getattr(self._enc, "stats", {}).get(
            "statics_build_s_total", 0.0)
        out = self._enc.encode_prepared(prep, views=self._views)
        enc_s = time.perf_counter() - t0
        self.stats["last_encode_s"] = enc_s
        self.stats["overlap_s_total"] += enc_s
        statics_s = getattr(self._enc, "stats", {}).get(
            "statics_build_s_total", 0.0) - statics0
        if statics_s > 0:
            # histogram=False: the encoder already observed each build
            # call into the "statics" stage histogram; this span is the
            # per-window wide-event view only (double-feeding the same
            # seconds would distort the distribution).
            trace.add_span("statics", statics_s, histogram=False)
        trace.add_span("encode", enc_s)
        t0 = time.perf_counter()
        try:
            self._ship(out, prep)
        except Exception as e:  # noqa: BLE001 - ship != encoder failure
            # A writer error is NOT an encoder failure: the template is
            # healthy, re-shipping via the fallback would duplicate the
            # profiles already written, and disabling the pipeline over a
            # transient I/O error would be self-harm. Mirror the inline
            # path's behavior (a writer raise there loses the rest of the
            # window as an iteration error): log, count, carry on.
            self.stats["ship_errors"] += 1
            _log.warn("pipelined ship failed; window partially shipped",
                      error=repr(e))
            trace.add_span("ship", time.perf_counter() - t0,
                           error=repr(e)[:200])
            trace.complete(error=f"ship failed: {e!r}"[:200])
            return
        ship_s = time.perf_counter() - t0
        self.stats["last_ship_s"] = ship_s
        trace.add_span("ship", ship_s)
        self.stats["windows_pipelined"] += 1
        trace.complete()
        if self._rollup is not None and (rollup_ctx is not None
                                         or self._rollup_capture is None):
            # Hotspot fold on the window clock, after the ship: a fold
            # failure can neither delay nor lose the window, and the
            # capture thread never sees this work at all. A window whose
            # hand-off capture failed (ctx None with a capture hook
            # configured) ships unfolded — folding it off the live
            # aggregator would reopen the rotation race.
            t0 = time.perf_counter()
            try:
                self._rollup(prep, rollup_ctx)
                self.stats["windows_rolled"] += 1
            except Exception as e:  # noqa: BLE001 - rollup is best-effort
                self.stats["rollup_errors"] += 1
                _log.warn("hotspot rollup failed on the encode worker",
                          error=repr(e))
            self.stats["last_rollup_s"] = time.perf_counter() - t0
        if self._snapshot is not None and self._snapshot_every > 0 \
                and self.stats["windows_pipelined"] \
                % self._snapshot_every == 0:
            # Warm statics snapshot on the window clock, on this worker
            # thread, AFTER the ship — so a failed snapshot can neither
            # delay nor duplicate the window. Errors are contained here:
            # letting one escape would read as an encoder death and
            # disable the pipeline over a disk hiccup.
            t0 = time.perf_counter()
            try:
                # The store's save() reports failure as False and a
                # clean skip (disk already current) as "skipped" — only
                # a real write counts as written, so this gauge stays in
                # lockstep with the store's own snapshots_written. The
                # except arm covers custom callables.
                r = self._snapshot(prep.period_ns)
                if r is False:
                    self.stats["snapshot_errors"] += 1
                elif r != "skipped":
                    self.stats["snapshots_written"] += 1
            except Exception as e:  # noqa: BLE001 - snapshot is best-effort
                self.stats["snapshot_errors"] += 1
                _log.warn("statics snapshot failed on the encode worker",
                          error=repr(e))
            self.stats["last_snapshot_s"] = time.perf_counter() - t0

    def _fail_window(self, e: Exception, fallback,
                     trace=NULL_TRACE) -> None:
        """Worker died on a window: disable the pipeline (the profiler
        reverts to its inline path), reset the encoder's possibly
        half-mutated state, and ship the window via the caller's
        fallback so it is not lost. The window's trace completes with
        the error either way — a lost window must be visible in the
        flight recorder, not just in a counter."""
        self.stats["encoder_exceptions"] += 1
        self.last_error = e
        self.disabled = True
        _log.warn("encode pipeline failed; disabling and falling back to "
                  "inline encode", error=repr(e))
        try:
            self._enc.reset()
        except Exception as e2:  # noqa: BLE001 - reset is best-effort
            _log.warn("encoder reset failed after pipeline error",
                      error=repr(e2))
        try:
            if fallback is None:
                self.stats["windows_lost"] += 1
                _log.warn("no fallback for the failed window; window lost")
                trace.annotate(window_lost=True)
                return
            try:
                with trace.span("ship"):
                    fallback()
                trace.annotate(path="fallback-pipeline-fail")
            except Exception as e2:  # noqa: BLE001 - like an iteration error
                self.stats["windows_lost"] += 1
                trace.annotate(window_lost=True)
                _log.warn("the fallback for the failed window also "
                          "failed", error=repr(e2))
        finally:
            trace.complete(error=repr(e)[:200])
