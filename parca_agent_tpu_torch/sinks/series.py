"""Series sink: scalar OTLP-style per-label-set sample-count series.

Dashboards rarely want profiles; they want "how much CPU is this
label set burning" at scrape rates. This sink reduces every shipped
window to one scalar per label set — the window's sample mass per pid,
joined to the pid's relabeled label set — and maintains OTLP-metric-
shaped cumulative sums: monotonic ``value`` with a ``start_time_ns``
fixed at the series' first point and ``time_ns`` advancing per window
(the cumulative-temporality sum of OTLP's data model). The web layer
exports them as ``parca_agent_sink_series_samples_total{...}`` on
/metrics; ``series()`` hands the raw points to anything else.

Bounded memory: at most ``max_sets`` label sets, least-recently-updated
evicted first (counted) — a pid churn storm degrades dashboard
coverage, never the agent.

Thread contract: emit() is registry-serialized (sinks/registry.py holds
its lock across secondary emits); series() is called from HTTP threads,
so the point state is additionally guarded by a sink-local lock — a
scrape never sees a half-updated point.
"""

from __future__ import annotations

import threading


class SeriesSink:
    name = "series"

    def __init__(self, max_sets: int = 4096, labels_for=None):
        self._max_sets = max_sets
        # pid -> labels hook; the profiler binds its (lock-guarded)
        # labels manager at construction time. None -> pid-only labels.
        self.labels_for = labels_for
        # key (sorted label tuple) -> point dict; insertion order is
        # update recency (move_to_end on touch) for the eviction scan.
        self._series: dict[tuple, dict] = {}
        # HTTP snapshot lock: the registry serializes emits, but a
        # /metrics scrape reads concurrently.
        self._mu = threading.Lock()
        self.stats = {
            "windows": 0,
            "samples": 0,
            "sets": 0,
            "sets_evicted": 0,
            "targets_dropped": 0,  # relabeling dropped the pid
            "bytes": 0,            # rendered point bytes emitted
        }

    def emit(self, win) -> None:
        mass: dict[int, int] = {}
        pids = win.pids_live
        vals = win.vals
        for i in range(len(pids)):
            pid = int(pids[i])
            mass[pid] = mass.get(pid, 0) + int(vals[i])
        t_ns = win.time_ns + win.duration_ns
        with self._mu:
            for pid, v in mass.items():
                labels = None
                if self.labels_for is not None:
                    labels = self.labels_for(pid)
                    if labels is None:
                        # Relabeling dropped this target — same verdict
                        # the pprof write path reaches.
                        self.stats["targets_dropped"] += 1
                        continue
                if not labels:
                    labels = {"pid": str(pid)}
                key = tuple(sorted(
                    (k, str(val)) for k, val in labels.items()
                    if not k.startswith("__")))
                pt = self._series.get(key)
                if pt is None:
                    if len(self._series) >= self._max_sets:
                        # Evict the least-recently-updated set.
                        oldest = next(iter(self._series))
                        del self._series[oldest]
                        self.stats["sets_evicted"] += 1
                    pt = self._series[key] = {
                        "labels": dict(key),
                        "start_time_ns": win.time_ns,
                        "time_ns": t_ns,
                        "value": 0,
                        "windows": 0,
                    }
                else:
                    # Re-insert for LRU recency.
                    del self._series[key]
                    self._series[key] = pt
                pt["value"] += v
                pt["time_ns"] = t_ns
                pt["windows"] += 1
                self.stats["samples"] += v
                # One rendered OTLP-style number point per touched set
                # per window: label bytes + the three scalar fields.
                self.stats["bytes"] += (
                    sum(len(k) + len(val) for k, val in key) + 24)
            self.stats["windows"] += 1
            self.stats["sets"] = len(self._series)

    def series(self) -> list[dict]:
        """Current points, snapshot-consistent, for /metrics and
        embedders. Points are copies — callers may hold them across
        emits."""
        with self._mu:
            return [dict(pt) for pt in self._series.values()]

    def flush(self) -> None:
        pass  # nothing buffered: state IS the product

    def close(self) -> None:
        pass
