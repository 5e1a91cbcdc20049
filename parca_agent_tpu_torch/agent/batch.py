"""Batching remote-write client: bounded, spill-backed, crash-only.

Role of the reference's pkg/agent/batch_remote_write_client.go: buffer
RawProfileSeries in memory, merging samples into an existing series when
the label sets are equal (:144-184); a loop flushes every interval
(:88-142). The reference retries forever with an UNBOUNDED in-memory
buffer — an hours-long store outage costs either the host's profile
history or the agent's RSS (one recorded outage: 491 dead probes
over 11.1 h). This client deviates deliberately (docs/robustness.md):

  * The buffer has byte/sample caps. On overflow the whole buffered
    batch spills to the disk spool (agent/spool.py) — or, with no spool
    configured, is dropped and counted.
  * Repeated flush failure (``spill_after_failures`` consecutive) also
    spills instead of re-buffering, so RSS stays bounded for the entire
    outage; the spool's own byte cap + oldest-eviction bounds the disk.
  * Retry backoff is full-jitter exponential (AWS-style: sleep ~
    U(0, min(cap, base·2^attempt))) — after a store restart, a fleet of
    agents with synchronized fixed-doubling backoff is a thundering
    herd; jitter decorrelates them. Retries spend a per-interval budget
    SHARED between the live flush and spool replay, so recovery can
    never starve live windows.
  * On the first successful flush after an outage, spilled segments
    replay oldest-first, at most ``replay_per_interval`` segments per
    interval (bounded-rate catch-up).

The capture path still never blocks: write_raw only appends to the
locked buffer (and at worst pays one spool file write on overflow).

The port's copy of parca_agent_tpu's agent/batch.py.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Protocol

from parca_agent_tpu_torch.agent.profilestore import RawSeries
from parca_agent_tpu_torch.runtime import trace as window_trace
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("batch")


class StoreClient(Protocol):
    def write_raw(self, series: list[RawSeries], normalized: bool) -> None: ...


class NoopStoreClient:
    """Default when no remote store is configured (reference agent.go:23-31)."""

    def write_raw(self, series: list[RawSeries], normalized: bool) -> None:
        pass


def _series_bytes(labels: dict[str, str], sample: bytes) -> int:
    """Buffer accounting: payload plus a small label overhead term."""
    return len(sample) + sum(len(k) + len(v) for k, v in labels.items())


class BatchWriteClient:
    def __init__(self, client: StoreClient, interval_s: float = 10.0,
                 initial_backoff_s: float = 0.5, clock=time.monotonic,
                 sleep=None, rng: random.Random | None = None,
                 max_buffer_bytes: int = 64 << 20,
                 max_buffer_samples: int = 100_000,
                 spool=None, spill_after_failures: int = 2,
                 retry_budget: int = 8,
                 replay_per_interval: int = 4):
        self._client = client
        self._interval = interval_s
        self._initial_backoff = initial_backoff_s
        self._clock = clock
        self._stop = threading.Event()
        self._sleep = sleep or (lambda s: self._stop.wait(s))
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._buffer: dict[tuple, RawSeries] = {}
        self._buffer_bytes = 0
        self._buffer_samples = 0
        self._max_bytes = max_buffer_bytes
        self._max_samples = max_buffer_samples
        self._spool = spool
        self._spill_after = max(1, spill_after_failures)
        self._retry_budget = max(0, retry_budget)
        self._replay_per_interval = max(1, replay_per_interval)
        self._consec_failures = 0
        self.sent_batches = 0
        self.send_errors = 0
        self.stats = {  # guarded-by: _lock
            "samples_dropped": 0,
            "bytes_dropped": 0,
            "overflow_spills": 0,
            "failure_spills": 0,
            "segments_replayed": 0,
            "samples_replayed": 0,
            "replay_errors": 0,
            "retry_budget_exhausted": 0,
        }

    # -- capture-side API ----------------------------------------------------

    def write_raw(self, labels: dict[str, str], sample: bytes) -> None:
        """Append one gzipped pprof for a label set (merge by label-set
        equality, batch_remote_write_client.go:167-184). Lock-protected:
        the encode pipeline ships from its worker thread while the flush
        loop drains from its own. Past the buffer caps the OLD buffer
        spills to disk (or is dropped, counted) so this call never grows
        memory unboundedly and never blocks on the network."""
        s = RawSeries(dict(labels), [sample])
        cost = _series_bytes(labels, sample)
        spill = None
        with self._lock:
            if (self._buffer_bytes + cost > self._max_bytes
                    or self._buffer_samples + 1 > self._max_samples) \
                    and self._buffer:
                spill = list(self._buffer.values())
                spill_bytes = self._buffer_bytes
                self._buffer = {}
                self._buffer_bytes = 0
                self._buffer_samples = 0
            existing = self._buffer.get(s.key())
            if existing is not None:
                existing.samples.append(sample)
            else:
                self._buffer[s.key()] = s
            self._buffer_bytes += cost
            self._buffer_samples += 1
        if spill is not None:
            with self._lock:
                self.stats["overflow_spills"] += 1
            self._spill(spill, spill_bytes, why="buffer overflow")

    def buffered(self) -> tuple[int, int]:
        """(series, samples) currently awaiting flush — the observable
        depth of the encode→ship boundary now that encoding is
        pipelined ahead of the flush loop."""
        with self._lock:
            return (len(self._buffer), self._buffer_samples)

    def buffer_bytes(self) -> int:
        """Approximate bytes held in the in-memory buffer (the RSS-proxy
        gauge; spool bytes are the disk half)."""
        with self._lock:
            return self._buffer_bytes

    # -- internal buffer plumbing --------------------------------------------

    def _swap(self) -> list[RawSeries]:
        with self._lock:
            batch = list(self._buffer.values())
            self._buffer = {}
            self._buffer_bytes = 0
            self._buffer_samples = 0
        return batch

    def _restore(self, batch: list[RawSeries]) -> None:
        """Failed batch goes back first so order survives a retry window."""
        with self._lock:
            merged: dict[tuple, RawSeries] = {s.key(): s for s in batch}
            for s in self._buffer.values():
                ex = merged.get(s.key())
                if ex is not None:
                    ex.samples.extend(s.samples)
                else:
                    merged[s.key()] = s
            self._buffer = merged
            self._buffer_samples = sum(
                len(s.samples) for s in merged.values())
            self._buffer_bytes = sum(
                _series_bytes(s.labels, b)
                for s in merged.values() for b in s.samples)

    def _spill(self, batch: list[RawSeries], batch_bytes: int,
               why: str) -> None:
        """Move a batch out of memory: to the spool when configured (its
        cap/eviction accounting then owns the data), else counted drop.
        Runs on whichever thread overflowed the buffer (capture thread,
        encode worker) as well as the flush thread, so every stats
        read-modify-write here is under the lock."""
        n_samples = sum(len(s.samples) for s in batch)
        if self._spool is not None:
            if self._spool.append(batch):
                _log.warn("batch spilled to disk", reason=why,
                          samples=n_samples)
            # On a failed spool write the spool counted the drop itself
            # (its stats are exported too) — counting it here as well
            # would double every loss number downstream.
            return
        with self._lock:
            self.stats["samples_dropped"] += n_samples
            self.stats["bytes_dropped"] += batch_bytes
        _log.warn("batch dropped", reason=why, samples=n_samples,
                  spool="none")

    # -- flush / retry / replay ----------------------------------------------

    def _jitter(self, attempt: int) -> float:
        """Full-jitter exponential backoff delay ~ U(0, min(interval,
        initial_backoff · 2^attempt)). Decorrelates a fleet of agents
        retrying against a restarting store."""
        cap = min(self._initial_backoff * (2 ** attempt), self._interval)
        return self._rng.uniform(0.0, cap)

    def flush(self, drain: bool = False) -> bool:
        """One batch attempt with budgeted full-jitter retries; True on
        success or empty batch. On success, replays spilled segments
        (bounded) with whatever retry budget the live flush left over.
        ``drain=True`` (final flush on stop) spills to disk on failure
        regardless of the consecutive-failure threshold, so a shutdown
        during an outage loses nothing that a spool could hold."""
        budget = [self._retry_budget]
        batch = self._swap()
        if not batch:
            # An empty interval still replays: with no live traffic the
            # first replay send doubles as the store-recovery probe (an
            # idle agent must not strand its spilled history).
            self._replay(budget)
            return True
        attempt = 0
        # Flight-recorder stages (runtime/trace.py, free when no recorder
        # is installed): batch_flush is the whole attempt loop — retries,
        # backoff, and terminal spill included, the end-to-end latency of
        # getting one batch out of memory — store_ack one successful
        # WriteRaw round trip.
        t_flush0 = time.perf_counter()
        # Retries stop at whichever comes first: the per-interval budget
        # (herd control) or the interval deadline (the reference's cap —
        # a flush never runs past its own interval).
        deadline = self._clock() + self._interval
        while True:
            try:
                # Chaos site for ONE send attempt: an injected error here
                # rides the same retry/spill machinery as a store failure
                # (an actor-killing crash is the actor.flush site's job).
                faults.inject("batch.flush")
                t_ack0 = time.perf_counter()
                self._client.write_raw(batch, normalized=True)
                window_trace.observe("store_ack",
                                     time.perf_counter() - t_ack0)
                self.sent_batches += 1
                self._consec_failures = 0
                window_trace.observe("batch_flush",
                                     time.perf_counter() - t_flush0)
                self._replay(budget)
                return True
            except Exception as e:
                self.send_errors += 1
                # The deadline is checked BEFORE sleeping (like the old
                # fixed-doubling loop): a jittered sleep that would end
                # past the deadline is never taken, so one flush cannot
                # overrun its interval by a backoff.
                delay = self._jitter(attempt)
                if budget[0] <= 0 or self._clock() + delay >= deadline \
                        or self._stop.is_set():
                    if budget[0] <= 0:
                        # Stats RMWs ride the lock everywhere (palint
                        # lock-discipline): the capture/encode threads'
                        # overflow path increments concurrently.
                        with self._lock:
                            self.stats["retry_budget_exhausted"] += 1
                    self._consec_failures += 1
                    if self._spool is not None and \
                            (drain or self._consec_failures
                             >= self._spill_after):
                        batch_bytes = sum(
                            _series_bytes(s.labels, b)
                            for s in batch for b in s.samples)
                        with self._lock:
                            self.stats["failure_spills"] += 1
                        self._spill(batch, batch_bytes,
                                    why="repeated flush failure"
                                    if not drain else "final drain")
                    else:
                        self._restore(batch)
                    _log.warn("batch write failed; will retry next interval",
                              series=len(batch), error=repr(e),
                              consec_failures=self._consec_failures)
                    window_trace.observe("batch_flush",
                                         time.perf_counter() - t_flush0)
                    return False
                budget[0] -= 1
                self._sleep(delay)
                attempt += 1

    def _replay(self, budget: list[int]) -> None:
        """Replay spilled segments oldest-first after a successful live
        flush, bounded per interval AND by the shared retry budget, so
        outage recovery cannot starve live windows of their send slots."""
        if self._spool is None:
            return
        for _ in range(self._replay_per_interval):
            if budget[0] <= 0 or self._stop.is_set():
                return
            t_seg0 = time.perf_counter()
            got = self._spool.read_oldest()
            if got is None:
                return
            seq, series = got
            budget[0] -= 1
            try:
                t_ack0 = time.perf_counter()
                self._client.write_raw(series, normalized=True)
                window_trace.observe("store_ack",
                                     time.perf_counter() - t_ack0)
            except Exception as e:
                # Store flapped again mid-replay: the segment stays for
                # the next interval (replay is at-least-once; the store
                # dedups nothing, so a duplicate costs bytes, not
                # correctness of the history).
                with self._lock:
                    self.stats["replay_errors"] += 1
                _log.warn("spool replay failed; segment retained",
                          seq=seq, error=repr(e))
                return
            self._spool.pop(seq)
            self._consec_failures = 0  # the store took data: recovered
            with self._lock:
                self.stats["segments_replayed"] += 1
                self.stats["samples_replayed"] += sum(
                    len(s.samples) for s in series)
            # One replayed segment end-to-end: decode + send + delete.
            window_trace.observe("spool_replay",
                                 time.perf_counter() - t_seg0)

    def replay_backlog(self) -> tuple[int, int]:
        """(segments, bytes) still spilled on disk (0, 0 without a spool)."""
        if self._spool is None:
            return (0, 0)
        return self._spool.pending()

    def replay_lag_s(self) -> float:
        return self._spool.oldest_age_s() if self._spool is not None else 0.0

    def spool_stats(self) -> dict:
        """The spool's own counters (evictions, disk errors, corruption
        — the disk-side loss accounting); {} without a spool."""
        return dict(self._spool.stats) if self._spool is not None else {}

    # -- actor ---------------------------------------------------------------

    def run(self) -> None:
        """Flush loop (one actor of the run group; supervised in the CLI).
        The ``actor.flush`` fault site lets the chaos layer kill this
        actor to exercise supervisor restarts."""
        while not self._stop.is_set():
            self._stop.wait(self._interval)
            if self._stop.is_set():
                break
            faults.inject("actor.flush")
            self.flush()
        self.flush(drain=True)  # final drain

    def stop(self) -> None:
        self._stop.set()
