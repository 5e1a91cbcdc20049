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
was never teed) the fed window is discarded and the profiler
re-aggregates the snapshot with window_counts on the SAME aggregator —
counted in windows_fallback. That is the only re-aggregation: there is
no device watchdog, no cooldown and no other aggregator behind this
feeder, so a feed that raises propagates out of on_drain.

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
    mapping table (capture/live.py mapping_table_for_pids)."""

    def __init__(self, aggregator, maps_cache, objs_cache,
                 prebuild_period_ns: int = 0):
        self._agg = aggregator
        self._maps = maps_cache
        self._objs = objs_cache
        self._fed_total = 0          # mass fed into the open window
        self._encoder = None
        self._prebuild_fn = None
        self._prebuild_period = prebuild_period_ns
        self.stats = {"drains_fed": 0, "windows_streamed": 0,
                      "windows_fallback": 0, "statics_prebuilt": 0,
                      "prebuild_errors": 0, "last_close_s": 0.0,
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

    def on_drain(self, cols) -> None:
        """Feed one drain. ``cols`` is (pids, tids, user_len, kernel_len,
        stacks, counts), optionally followed by a capture-carried (h1, h2,
        h3) triple. A feed that raises propagates."""
        pids, tids, ulen, klen, stacks, counts = cols[:6]
        hashes = tuple(cols[6:9]) if len(cols) >= 9 else None
        if not len(pids):
            return
        t_feed0 = time.perf_counter()
        try:
            table = mapping_table_for_pids(self._maps, self._objs,
                                           np.unique(pids).tolist())
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
            self._agg.feed(mini, hashes=hashes)
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
        return counts
