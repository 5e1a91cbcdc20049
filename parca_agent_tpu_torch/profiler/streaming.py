"""Streaming window feeder: ship capture drains to the card DURING the
window.

The port's copy of parca_agent_tpu's profiler/streaming.py. The
reference's BPF map absorbs samples in the kernel as they happen
(bpf/cpu/cpu.bpf.c:110-116), so its window close never re-ships the
window; here each once-a-second drain is fed to the dictionary
aggregator as it lands (H2D and the probe/accumulate kernel ride the
otherwise idle window), and the profiler's window close is just
close_window(): one pack kernel, one packed fetch.

Exactness: at the window boundary the fed mass is checked against the
snapshot's total. On any mismatch (a drain raced the boundary, a drain
was never teed, a feed failed) the fed window is discarded and the
profiler re-aggregates the snapshot with window_counts on the SAME
aggregator, on the same card — counted in windows_fallback. No other
aggregator stands behind this feeder.

Safety (the original's model, with no CPU path): every feed runs under
an abandonable watchdog with a SHORT timeout (the polling thread is
stalled while a feed runs, and a long stall wraps the perf rings). The
timeout bounds each of the feed's waits on the card
(utils/bounded.py device_wait: the upload, the miss count and rows),
not the feed: a cold drain's host miss settle takes seconds at the bench
width and is not a hang. The process's first feed gets the long
first-feed budget: its first upload pays the CUDA context. A failure or
a hang disables the feeder for a
capped-exponential number of WINDOWS (2, 4, ... 32): mid-window it never
retries (a wedged card would stall the polling thread again next drain);
at a window boundary it re-probes by streaming the next window, once any
abandoned feed has returned. An abandoned feed may still be EXECUTING
inside the aggregator: until it returns, device_blocked() says so and
the profiler waits for it under its own device watchdog before it
touches the aggregator (profiler/cpu.py). A drain whose mapping table
cannot be built is skipped (its window re-aggregates); with a
quarantine registry a poisoned pid is charged and the drain goes on.

With an encoder attached, each fed drain is followed by a budgeted
statics prebuild (WindowEncoder.build_statics), on the encode pipeline's
worker when one is given (request_prebuild: the encoder is owned by one
thread), so the pid population discovered during the window is warm by
its close.
"""

from __future__ import annotations

import time

import numpy as np

from parca_agent_tpu_torch.capture.formats import WindowSnapshot
from parca_agent_tpu_torch.capture.live import (
    columns_to_snapshot,
    mapping_table_for_pids,
)
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.bounded import bounded_call
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("streaming")

# Wall-time budget of one drain's statics prebuild (the original's
# default).
_PREBUILD_BUDGET_S = 0.25

# The aggregator timings a drain's feed leaves behind, and the per-window
# stats key each one sums into.
_SPLIT = (("feed_dispatch", "dispatch"), ("feed_settle", "settle"),
          ("feed_hash", "hash"), ("feed_coalesce", "coalesce"),
          ("feed_carry", "carry"))


class StreamingWindowFeeder:
    """Per-drain feed glue between a capture source and a DictAggregator:
    call on_drain(columns) for each drain and pass the feeder to
    CPUProfiler(streaming_feeder=...), which closes the window through
    take_window_if_complete.

    ``maps_cache.executable_mappings(pid)`` and ``objs_cache`` (with
    ``build_ids(per_pid)`` and ``get(pid, mapping)``) give each drain's
    mapping table (capture/live.py mapping_table_for_pids), charging
    poisoned pids to ``quarantine`` when one is given.

    ``feed_timeout_s`` bounds each device wait of a feed and
    ``first_feed_timeout_s`` those of the process's first (its upload
    creates the CUDA context); ``reprobe_base_windows`` and
    ``reprobe_max_windows`` are the cooldown's first and largest length
    in windows."""

    def __init__(self, aggregator, maps_cache, objs_cache,
                 prebuild_period_ns: int = 0, quarantine=None,
                 feed_timeout_s: float = 3.0,
                 first_feed_timeout_s: float = 60.0,
                 reprobe_base_windows: int = 2,
                 reprobe_max_windows: int = 32):
        self._agg = aggregator
        self._maps = maps_cache
        self._objs = objs_cache
        self._quarantine = quarantine
        self._timeout = feed_timeout_s
        # The long budget applies exactly once: if the first attempt
        # hangs (a card wedged from boot), every re-probe runs under the
        # short timeout, so a dead card costs one long stall, not one a
        # cooldown.
        self._first_timeout = max(feed_timeout_s, first_feed_timeout_s)
        self._first_attempted = False
        self._inflight = None        # threading.Event of an abandoned feed
        self.disabled = False        # not feeding (cooling down)
        self._cooldown = 0           # windows until re-probe
        self._backoff_base = max(1, reprobe_base_windows)
        self._backoff_max = max(self._backoff_base, reprobe_max_windows)
        self._backoff = self._backoff_base  # next cooldown length
        self._fed_total = 0          # mass fed into the open window
        self._encoder = None
        self._prebuild_fn = None
        self._prebuild_period = prebuild_period_ns
        self.stats = {"drains_fed": 0, "windows_streamed": 0,
                      "windows_fallback": 0, "statics_prebuilt": 0,
                      "prebuild_errors": 0, "last_close_s": 0.0,
                      # The watchdog's counts: feeds that raised, feeds
                      # abandoned at their timeout, drains skipped for
                      # their mapping table, cooldowns entered, re-probes.
                      "feed_errors": 0, "feed_hangs": 0,
                      "drain_map_errors": 0, "cooldowns": 0,
                      "reprobes": 0,
                      # Capture-thread seconds of the last window: its
                      # drain tees in all, and of them the feeds'
                      # dispatch (the device work overlaps capture), the
                      # deferred miss settles, the row hash, the coalesce
                      # fold and the carry match; whether it streamed.
                      "last_window_feed_s": 0.0,
                      "last_window_streamed": 0,
                      "last_window_dispatch_s": 0.0,
                      "last_window_settle_s": 0.0,
                      "last_window_hash_s": 0.0,
                      "last_window_coalesce_s": 0.0,
                      "last_window_carry_s": 0.0}
        self._window_feed_s = 0.0
        self._window = dict.fromkeys((k for _, k in _SPLIT), 0.0)

    def attach_encoder(self, encoder, prebuild=None) -> None:
        """Wire the profiler's WindowEncoder for statics amortization.
        `prebuild(period_ns, budget_s)` overrides where the budgeted build
        runs: the encode pipeline passes request_prebuild so the drain
        tick only enqueues and the build lands on the encoder's thread;
        by default it runs inline on the calling thread."""
        self._encoder = encoder
        self._prebuild_fn = prebuild

    # -- drain tee -----------------------------------------------------------

    # palint: capture-path — runs synchronously inside the sampler's
    # poll() on the profiler thread; feed work here must be dispatch-
    # only (the aggregator's seeded feed carries the same contract).
    def on_drain(self, cols) -> None:
        """Feed one drain. ``cols`` is (pids, tids, user_len, kernel_len,
        stacks, counts), optionally followed by a capture-carried (h1, h2,
        h3) triple. Nothing raises out of here: a failed or hung feed
        enters the cooldown."""
        if self.disabled:
            return
        try:
            # Chaos site: the drain tick runs synchronously inside the
            # sampler's poll(), so an injected crash must degrade (the
            # cooldown), never escape into capture.
            faults.inject("actor.feeder")
        except Exception:  # noqa: BLE001 - injected crash -> cooldown
            self._enter_cooldown("injected feeder crash")
            return
        pids, tids, ulen, klen, stacks, counts = cols[:6]
        hashes = tuple(cols[6:9]) if len(cols) >= 9 else None
        if not len(pids):
            return
        t_feed0 = time.perf_counter()
        try:
            try:
                table = mapping_table_for_pids(
                    self._maps, self._objs, np.unique(pids).tolist(),
                    quarantine=self._quarantine)
            except Exception as e:  # noqa: BLE001 - costs this drain only
                # A poisoned maps file (PoisonInput without a registry)
                # costs this DRAIN's feed, never the capture loop: the
                # fed mass then differs and the window re-aggregates.
                self.stats["drain_map_errors"] += 1
                _log.warn("drain mapping build failed; skipping feed",
                          error=repr(e))
                return
            mini = columns_to_snapshot(pids, tids, ulen, klen, stacks,
                                       table, 0, 0, weights=counts,
                                       hashes=hashes)
            if hashes is not None:
                mini, hashes = mini
            if len(mini) == 0:
                return
            tim = self._agg.timings
            if self._fed_total == 0:
                # First feed of a new window: a re-aggregated window ran
                # window_counts on this aggregator between the boundary
                # and now, leaving its feed timings behind — drop them so
                # they are not credited to this window.
                for key, _ in _SPLIT:
                    tim.pop(key, None)
                if self._agg._fed_total or self._agg._pending:
                    # Residual open-window state (a feed dispatched and
                    # never closed): discard it all, as window_counts
                    # does at its entry, so it cannot ride into this
                    # window's close.
                    self._agg.discard_open_window()
            if not self._feed_guarded(mini, hashes):
                # Not again this window: a wedged card would stall the
                # capture loop on every later drain.
                self._enter_cooldown("streaming feed failed")
                return
            # Popped, not read: a timing is only written when its stage
            # ran, and a stale value must not count twice.
            for key, name in _SPLIT:
                self._window[name] += tim.pop(key, 0.0)
            self._fed_total += mini.total_samples()
            self.stats["drains_fed"] += 1
            if self._encoder is not None and self._prebuild_period:
                try:
                    if self._prebuild_fn is not None:
                        self._prebuild_fn(self._prebuild_period,
                                          _PREBUILD_BUDGET_S)
                    else:
                        self._encoder.build_statics(
                            self._prebuild_period,
                            budget_s=_PREBUILD_BUDGET_S)
                    self.stats["statics_prebuilt"] += 1
                except Exception as e:  # noqa: BLE001 - counted; the
                    # encode's own staleness guards build what is left.
                    self.stats["prebuild_errors"] += 1
                    _log.warn("statics prebuild failed", error=repr(e))
        finally:
            self._window_feed_s += time.perf_counter() - t_feed0

    def _feed_guarded(self, mini: WindowSnapshot, hashes=None) -> bool:
        """One feed under the abandonable watchdog (utils/bounded.py),
        its device waits bounded: False when it raised or was
        abandoned."""
        timeout = (self._timeout if self._first_attempted
                   else self._first_timeout)
        self._first_attempted = True
        status, out, done, _box = bounded_call(
            lambda: self._agg.feed(mini, hashes=hashes), timeout,
            thread_name="stream-feed", waits_only=True)
        if status == "hang":
            # Abandoned: the call may still be mutating the aggregator.
            self._inflight = done
            self.stats["feed_hangs"] += 1
            _log.error("streaming feed hung; abandoning", timeout_s=timeout)
            return False
        if status == "err":
            self.stats["feed_errors"] += 1
            _log.warn("streaming feed error", error=repr(out))
            return False
        return True

    def _enter_cooldown(self, why: str) -> None:
        """Stop feeding for a capped-exponential number of windows (the
        one degradation path for feed errors, hangs and injected crashes
        alike)."""
        self.disabled = True
        self._cooldown = self._backoff
        self._backoff = min(self._backoff * 2, self._backoff_max)
        self.stats["cooldowns"] += 1
        _log.warn(why + "; re-aggregating the next windows at their close",
                  cooldown_windows=self._cooldown)

    def device_blocked(self) -> bool:
        """True while an abandoned feed may still be executing inside the
        aggregator (nothing else may touch it until then)."""
        if self._inflight is None:
            return False
        if self._inflight.is_set():
            self._inflight = None
            return False
        return True

    def wait_unblocked(self, timeout_s: float | None = None) -> bool:
        """Wait for an abandoned feed to return; True once none is in
        flight."""
        done = self._inflight
        if done is not None and not done.wait(timeout_s):
            return False
        return not self.device_blocked()

    # -- window boundary -----------------------------------------------------

    def take_window_if_complete(self, snapshot: WindowSnapshot):
        """If the fed mass equals the snapshot's, close the window and
        return its exact counts (a view valid through the next close);
        else None (counted; the caller re-aggregates the snapshot). Either
        way the feeder is reset for the next window."""
        fed = self._fed_total
        self._fed_total = 0
        self.stats["last_window_feed_s"] = self._window_feed_s
        self._window_feed_s = 0.0
        for name in self._window:
            self.stats[f"last_window_{name}_s"] = self._window[name]
            self._window[name] = 0.0
        self.stats["last_window_streamed"] = 0
        if snapshot.period_ns:
            self._prebuild_period = snapshot.period_ns
        if self.disabled:
            self.stats["windows_fallback"] += 1
            self._cooldown -= 1
            # Re-probe here, at the boundary — never mid-window — and
            # only once any abandoned feed has returned.
            if self._cooldown <= 0 and not self.device_blocked():
                self.disabled = False
                self.stats["reprobes"] += 1
                self._agg.discard_open_window()
                _log.info("streaming feeder re-enabled; probing next "
                          "window")
            return None
        if fed != snapshot.total_samples():
            # A drain raced the boundary or was never teed: discard the
            # whole partial window (including any deferred miss check,
            # which would otherwise settle into the NEXT window).
            self.stats["windows_fallback"] += 1
            self._agg.discard_open_window()
            return None
        t0 = time.perf_counter()
        counts = self._agg.close_window(copy=False)
        self.stats["windows_streamed"] += 1
        self.stats["last_window_streamed"] = 1
        self.stats["last_close_s"] = time.perf_counter() - t0
        # The close settled the window's last feed after the reset above:
        # its timings belong to the window that just closed.
        tim = self._agg.timings
        for key, name in _SPLIT:
            self.stats[f"last_window_{name}_s"] += tim.pop(key, 0.0)
        self._backoff = self._backoff_base  # healthy again
        return counts
