"""SinkRegistry: fan one shipped window out to N backends, fail-open.

The contract (docs/sinks.md, enforced by palint's fail-open checker and
the sink.emit chaos drill in tests/test_sinks.py):

  * the pprof sink is PRIMARY: it is the agent's contract with the
    store, it runs first, and its failure propagates to the caller
    exactly as the pre-sink ship hook's did (the encode pipeline counts
    it as a ship_error; the inline path treats it as an iteration
    error) — byte-identical behavior, not just byte-identical output;
  * every other sink is SECONDARY: its emit is wrapped in a counted
    broad try/except (``_emit_one``), so one sink's failure never
    delays, drops, or reorders the pprof ship — and the secondaries
    still run when the pprof ship itself failed (a writer outage must
    not starve the PGO loop);
  * per-sink windows/bytes/errors are surfaced on /metrics and /healthz
    (web.py renders ``metrics()``/``snapshot()``).

Thread model: emit_window runs on the encode-pipeline worker,
emit_secondary on the profiler thread (inline-fallback windows), and
metrics()/snapshot() on HTTP threads. TWO lock tiers, deliberately
separate: a registry-held lock PER SINK serializes that sink's
emit/flush/close (the Sink contract), and one counter lock guards the
stats — so a secondary wedged in disk I/O can stall only itself, never
the profiler thread's count_skipped or an HTTP scrape. The primary
pprof ship runs outside both (its writer path has its own lock) so a
slow secondary can never stall a fallback write behind the registry.
"""

from __future__ import annotations

import threading
import time

from parca_agent_tpu_torch.sinks.base import SinkWindow
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("sinks")


class SinkRegistry:
    def __init__(self, sinks):
        self._primary = None
        self._secondary = []
        for s in sinks:
            if s.name == "pprof":
                if self._primary is not None:
                    raise ValueError("duplicate pprof sink")
                self._primary = s
            else:
                self._secondary.append(s)
        if self._primary is None:
            raise ValueError("the sink registry requires the pprof sink: "
                             "it is the agent's ship path")
        self._mu = threading.Lock()
        # One lock PER SINK serializes that sink's emit/flush/close (the
        # Sink thread contract) — deliberately NOT self._mu: a sink
        # stuck in disk I/O must never block the counter lock, which the
        # profiler thread (count_skipped on the backpressure-fallback
        # route) and the HTTP /metrics//healthz threads also take.
        self._sink_mu = {s.name: threading.Lock() for s in sinks}
        self._stats = {s.name: {"windows": 0,  # guarded-by: _mu
                                "errors": 0,
                                "last_emit_s": 0.0}
                       for s in sinks}
        # Scalar-path windows no sink could see, and failed profiler-
        # thread RegistryView captures.
        self.windows_skipped = 0   # guarded-by: _mu
        self.capture_errors = 0    # guarded-by: _mu

    def bind(self, ship=None, labels_for=None) -> None:
        """Late wiring from the profiler: the pprof sink's ship callable
        (CPUProfiler._write_encoded — the pre-sink path, bound not
        copied, so bytes stay identical) and the pid->labels hook the
        series sink joins on."""
        if ship is not None:
            self._primary.bind(ship)
        for s in self._secondary:
            if labels_for is not None \
                    and getattr(s, "labels_for", object()) is None:
                s.labels_for = labels_for

    @property
    def has_secondary(self) -> bool:
        return bool(self._secondary)

    @property
    def sinks(self):
        return [self._primary, *self._secondary]

    def sink(self, name: str):
        for s in self.sinks:
            if s.name == name:
                return s
        return None

    # -- emit paths ----------------------------------------------------------

    def emit_window(self, out, prep) -> None:
        """EncodePipeline ship hook (worker thread): primary pprof ship,
        then the secondary fan-out. ``prep.sink_ctx`` carries the
        RegistryView captured on the profiler thread at hand-off. A
        primary failure propagates (the pipeline's ship guard owns it)
        but never starves the secondaries."""
        win = SinkWindow(out, prep, view=getattr(prep, "sink_ctx", None))
        try:
            self._emit_primary(win)
        finally:
            for s in self._secondary:
                self._emit_one(s, win)

    def emit_secondary(self, out, prep) -> None:
        """Inline-fallback fan-out (profiler thread): the pprof bytes
        already shipped through the classic inline path; only the
        secondaries consume the window here."""
        win = SinkWindow(out, prep, view=getattr(prep, "sink_ctx", None))
        for s in self._secondary:
            self._emit_one(s, win)

    # palint: fail-open=caller — the primary's raise IS the pre-sink
    # ship contract: the encode pipeline's ship guard (or the inline
    # path's iteration guard) counts and contains it.
    def _emit_primary(self, win: SinkWindow) -> None:
        t0 = time.perf_counter()
        try:
            self._primary.emit(win)
        except Exception:
            with self._mu:
                self._stats[self._primary.name]["errors"] += 1
            raise
        with self._mu:
            st = self._stats[self._primary.name]
            st["windows"] += 1
            st["last_emit_s"] = time.perf_counter() - t0

    # palint: fail-open
    def _emit_one(self, sink, win: SinkWindow) -> None:
        """One secondary sink's emit, counted and contained: an injected
        (or real) failure here costs that sink's window, never the pprof
        ship — the sink.emit chaos site fires inside the guard so the
        drill proves exactly that. The emit runs under the SINK's own
        lock (the Sink serialization contract, true by construction);
        the counter lock is taken only after, so a sink wedged in disk
        I/O can never stall the profiler thread or /metrics behind its
        backend."""
        try:
            t0 = time.perf_counter()
            faults.inject("sink.emit")
            with self._sink_mu[sink.name]:
                sink.emit(win)
            dt = time.perf_counter() - t0
            with self._mu:
                st = self._stats[sink.name]
                st["windows"] += 1
                st["last_emit_s"] = dt
        except Exception as e:  # noqa: BLE001 - fail-open contract
            with self._mu:
                self._stats[sink.name]["errors"] += 1
            _log.warn("sink emit failed; window skipped for this sink",
                      sink=sink.name, error=repr(e))

    # -- bookkeeping hooks ---------------------------------------------------

    def count_skipped(self) -> None:
        """A window shipped through the scalar path: no prepared window
        exists, so no sink (primary included) saw it — counted so the
        PGO/series coverage gap is observable."""
        with self._mu:
            self.windows_skipped += 1

    def count_capture_error(self) -> None:
        """The profiler-thread RegistryView capture failed; secondaries
        that need frame data will skip the window (their own counters)
        — this counts the capture failures themselves."""
        with self._mu:
            self.capture_errors += 1

    def flush(self) -> None:
        """Flush every sink, serialized against emits by each sink's own
        lock. Errors are counted per sink, never raised."""
        for s in self.sinks:
            self._flush_one(s)

    # palint: fail-open
    def _flush_one(self, sink) -> None:
        try:
            with self._sink_mu[sink.name]:
                sink.flush()
        except Exception as e:  # noqa: BLE001 - fail-open contract
            with self._mu:
                self._stats[sink.name]["errors"] += 1
            _log.warn("sink flush failed", sink=sink.name, error=repr(e))

    def close(self) -> None:
        for s in self.sinks:
            self._close_one(s)

    # palint: fail-open
    def _close_one(self, sink) -> None:
        try:
            with self._sink_mu[sink.name]:
                sink.close()
        except Exception as e:  # noqa: BLE001 - fail-open contract
            with self._mu:
                self._stats[sink.name]["errors"] += 1
            _log.warn("sink close failed", sink=sink.name, error=repr(e))

    # -- observability (HTTP threads) ----------------------------------------

    def metrics(self) -> dict:
        """{sink name: merged registry + backend stats}, plus registry-
        level counters under the pseudo-entry ``_registry``."""
        with self._mu:
            out = {name: dict(st) for name, st in self._stats.items()}
            skipped = self.windows_skipped
            cap_errs = self.capture_errors
        for s in self.sinks:
            for k, v in s.stats.items():
                if k not in out[s.name]:  # registry counters win
                    out[s.name][k] = v
        out["_registry"] = {"windows_skipped": skipped,
                            "capture_errors": cap_errs}
        return out

    def snapshot(self) -> dict:
        """/healthz section: per-sink health summary. By contract this
        can never turn readiness red — a sink failure degrades one
        output, never the agent."""
        m = self.metrics()
        reg = m.pop("_registry")
        return {
            "sinks": {
                name: {
                    "windows": st.get("windows", 0),
                    "errors": st.get("errors", 0),
                    "bytes": st.get("bytes", 0),
                }
                for name, st in m.items()
            },
            **reg,
        }
