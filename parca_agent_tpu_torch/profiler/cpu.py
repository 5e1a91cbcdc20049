"""The window loop of the fast write path (``--fast-encode``).

The part of parca_agent_tpu's CPUProfiler (profiler/cpu.py there) that
its --fast-encode path runs: each window, the dictionary's counts (on
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

There is no fallback: no CPU aggregator stands behind the card and no
scalar pprof builder behind the encoder. So, as in the original's loop
when it has no fallback aggregator:

  * an inline encode that raises propagates (the window is not shipped
    by another path);
  * a window the pipeline refuses because its worker is still busy
    (backpressure, counted) waits the worker out, bounded, and is then
    encoded inline on this thread;
  * a pipelined window whose encode raised disables the pipeline (its
    loss is counted in the pipeline's windows_lost) and the loop raises
    that error at the next window or at close.

Left out of this port (parca_agent_tpu has them): the CPU fallback
aggregator and the device hang watchdog, quarantine, admission, process
identity, sinks, hotspots, the regression sentinel, the feeder's
watchdog and cooldown, the inline soft deadline (--encode-deadline,
which ships through a scalar fallback), symbolization, and the flight
recorder.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Protocol

import numpy as np

from parca_agent_tpu_torch.capture.formats import WindowSnapshot
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("profiler")


class CaptureSource(Protocol):
    def poll(self) -> WindowSnapshot | None: ...


# How long the loop waits for the encode worker (a window's encode at the
# bench's 50,000 pids takes seconds; a stuck worker must not hang the
# loop forever).
FLUSH_TIMEOUT_S = 60.0


@dataclasses.dataclass
class ProfilerMetrics:
    """The counters of parca_agent_tpu's ProfilerMetrics that this loop
    moves."""

    attempts_total: int = 0
    profiles_written: int = 0
    last_encode_duration_s: float = 0.0
    encode_backpressure_total: int = 0


def labels_for(pid: int) -> dict[str, str]:
    """The label set of a pid's profile (the CLI's)."""
    return {"__name__": "parca_agent_cpu", "pid": str(pid)}


class CPUProfiler:
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

    name = "cpu"

    def __init__(self, source: CaptureSource, aggregator,
                 profile_writer=None, encode_pipeline: bool = True,
                 statics_cache_bytes: int = 256 << 20,
                 on_window: Callable[[dict], None] | None = None,
                 streaming_feeder=None, statics_store=None,
                 statics_snapshot_every: int = 6,
                 window_sink: Callable[[WindowSnapshot], None] | None = None):
        if not hasattr(aggregator, "window_counts"):
            raise ValueError(
                "fast_encode requires a dict-style aggregator "
                "(window_counts/close_window protocol)")
        self._source = source
        self._aggregator = aggregator
        self._writer = profile_writer
        self._on_window = on_window
        # Optional tee of each window's snapshot; its failures must not
        # fail the window.
        self._window_sink = window_sink
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
        self._pipeline = (EncodePipeline(
            self._encoder, ship=self._ship_encoded, snapshot=snapshot,
            snapshot_every=statics_snapshot_every if snapshot else 0)
                          if encode_pipeline else None)
        self._feeder = streaming_feeder
        if streaming_feeder is not None:
            # Statics amortization: the feeder prebuilds static sections
            # after each drain, on the worker when the pipeline owns the
            # encoder.
            streaming_feeder.attach_encoder(
                self._encoder,
                prebuild=(self._pipeline.request_prebuild
                          if self._pipeline is not None else None))
        # Writes come from this thread (inline windows) AND the
        # pipeline's worker: one lock serializes the written counter.
        self._write_mu = threading.Lock()
        # Records of the windows handed to the worker, oldest first: the
        # worker ships them in order, one at a time.
        self._handed = collections.deque()
        self.metrics = ProfilerMetrics()

    @property
    def encoder(self) -> WindowEncoder:
        return self._encoder

    @property
    def pipeline(self) -> EncodePipeline | None:
        return self._pipeline

    def run_iteration(self) -> bool:
        """One window: False when the source is exhausted. Raises what
        the aggregator or an inline encode raises, and the error of a
        pipelined encode that failed since the last window."""
        self._raise_pipeline_error()
        snapshot = self._source.poll()
        if snapshot is None:
            return False
        self.metrics.attempts_total += 1
        self._aggregate_encode_write(snapshot, self.metrics.attempts_total)
        if self._window_sink is not None:
            try:
                self._window_sink(snapshot)
            except Exception as e:  # noqa: BLE001 - tee must not fail us
                _log.warn("window sink failed", error=repr(e))
        return True

    def close(self) -> None:
        """Flush the in-flight window and stop the worker; raises if a
        pipelined encode failed or the flush timed out."""
        if self._pipeline is not None:
            ok = self._pipeline.close(FLUSH_TIMEOUT_S)
            self._raise_pipeline_error()
            if not ok:
                raise RuntimeError("encode pipeline did not flush its last "
                                   f"window in {FLUSH_TIMEOUT_S} s")

    def _raise_pipeline_error(self) -> None:
        p = self._pipeline
        if p is not None and p.disabled and p.last_error is not None:
            raise RuntimeError("a pipelined window's encode failed; the "
                               "window was not shipped") from p.last_error

    def _aggregate_encode_write(self, snapshot: WindowSnapshot,
                                window: int) -> None:
        t0 = time.perf_counter()
        counts = None
        if self._feeder is not None:
            # The streamed close (None: the feeder did not see the whole
            # window, and the snapshot is aggregated here instead).
            counts = self._feeder.take_window_if_complete(snapshot)
        if counts is None:
            counts = self._aggregator.window_counts(snapshot)
        agg_s = time.perf_counter() - t0
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
        if self._submit_to_pipeline(counts, snapshot, record):
            return
        t1 = time.perf_counter()
        out = self._encoder.encode(counts, snapshot.time_ns,
                                   snapshot.window_ns, snapshot.period_ns)
        self.metrics.last_encode_duration_s = time.perf_counter() - t1
        n = self._write_encoded(out)
        record.update(path="inline",
                      encode_ms=self.metrics.last_encode_duration_s * 1e3)
        self._finish(record, n)

    def _submit_to_pipeline(self, counts, snapshot: WindowSnapshot,
                            record: dict) -> bool:
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
                                      snapshot.window_ns, snapshot.period_ns)
        except BaseException:
            self._handed.pop()
            raise
        if n is not None:
            record["handoff_ms"] = (time.perf_counter() - t0) * 1e3
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
            if self._writer is not None:
                self._writer.write(labels_for(pid), blob)
            n += 1
        with self._write_mu:
            self.metrics.profiles_written += n
        return n

    def _ship_encoded(self, out, prep) -> None:
        """EncodePipeline ship hook (worker thread)."""
        record, timed = self._handed.popleft()
        enc_s = self._pipeline.stats["last_encode_s"]
        self.metrics.last_encode_duration_s = enc_s
        n = self._write_encoded(out)
        timed.wait(FLUSH_TIMEOUT_S)
        record["encode_ms"] = enc_s * 1e3
        self._finish(record, n)
