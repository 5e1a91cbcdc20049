"""Sink interface: one shipped window, N output backends.

The encode path used to end in a single hardwired pprof writer; the
papers the roadmap tracks ("From Profiling to Optimization", arxiv
2507.16649; "Hardware Counted Profile-Guided Optimization", arxiv
1411.6361) both argue the same data should close the loop back into
compilers and dashboards. A Sink is one such consumer; the registry
(sinks/registry.py) fans each shipped window out to all of them under
the fail-open contract docs/sinks.md specifies.

A sink sees a :class:`SinkWindow` — the already-prepared window exactly
as the pprof encode consumed it, NOT a re-aggregation:

  * ``out``            [(pid, blob)] from the window encoder. Blobs may
                       be zero-copy memoryviews into the template buffer,
                       valid only for the duration of emit() — a sink
                       that keeps bytes must copy them.
  * ``idx``/``vals``   live stack ids and their window counts (the
                       prepared window's rows, uint64 counts).
  * ``pids_live``      the owning pid per row.
  * ``caps``           pid -> (registry, n_mappings, n_locs): per-pid
                       location/mapping registries frozen at hand-off
                       (the window encoder's concurrent-reader caps).
  * ``view``           a rotation-consistent RegistryView of the
                       aggregator's per-id mirrors (loc_off/loc_flat/
                       id_pid), captured on the profiler thread at
                       hand-off — or None when the capture failed; a
                       sink that needs frame data must then skip the
                       window (counted), never touch the live arrays.

Thread contract: emit() runs on the encode-pipeline worker (pipelined
windows) or the profiler thread (inline-fallback windows). SECONDARY
sinks' emit/flush/close all run under a registry-held PER-SINK lock,
so a secondary never sees concurrent calls and needs no locking of its
own (state read by HTTP threads — the series sink's points — still
needs a sink-local lock). The PRIMARY pprof sink's emit deliberately
runs outside any registry lock (its writer path has its own) and is
serialized by the ship-path discipline: at most one window is ever in
flight.
"""

from __future__ import annotations

from typing import Protocol


class SinkWindow:
    """One shipped window, frozen for sink consumption."""

    __slots__ = ("out", "idx", "vals", "pids_live", "time_ns",
                 "duration_ns", "period_ns", "caps", "view")

    def __init__(self, out, prep, view=None):
        self.out = out
        self.idx = prep.idx
        self.vals = prep.vals
        self.pids_live = prep.pids_live
        self.time_ns = prep.time_ns
        self.duration_ns = prep.duration_ns
        self.period_ns = prep.period_ns
        self.caps = prep.caps
        self.view = view


class Sink(Protocol):
    """One output backend. ``name`` keys the registry's per-sink stats
    (and the ``{sink="..."}`` label on /metrics); ``stats`` is a flat
    dict of numeric backend-specific gauges/counters the web layer
    exports verbatim."""

    name: str
    stats: dict

    def emit(self, win: SinkWindow) -> None:
        """Consume one shipped window. May raise: the registry counts
        and contains the failure (docs/sinks.md fail-open contract)."""
        ...

    def flush(self) -> None:
        """Persist buffered state (crash-only where applicable). The
        registry calls this at close; cadence-driven backends also
        flush themselves from emit()."""
        ...

    def close(self) -> None:
        """Final flush + release resources."""
        ...
