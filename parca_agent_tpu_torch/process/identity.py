"""Generation-stamped process identity: detect pid reuse, invalidate
stale per-pid state.

Linux recycles pids; a profiler keyed on bare pid will hand a recycled
pid its dead predecessor's everything — mapping tables, perf-map and
unwind-table caches, tenant resolution, quarantine strikes, and (worst)
the aggregator's per-pid location registry, which silently attributes
the NEW process's samples to the OLD binary (the workload zoo's
pid-reuse scenario reproduces this end to end). The reference agent is
immune by construction: its BPF stack maps are keyed per-attach and
torn down with the process, so reuse can't alias. A procfs sampler has
no such teardown signal, so we
stamp identity the way the kernel does — ``(pid, starttime)``, where
starttime is field 22 of ``/proc/<pid>/stat`` (clock ticks since boot
at fork, unique per pid incarnation).

The tracker observes each window's pid set once per window-loop
iteration (profiler/cpu.py run_iteration, BEFORE admission accounting
and aggregation), remembers each pid's starttime, and on a mismatch
fires registered invalidators — aggregator.invalidate_pid,
quarantine.forget_pid, resolver.forget, map/perf/unwind cache evicts —
so every layer drops the dead generation's state before the new
generation's first sample resolves. Everything is fail-open: an
unreadable stat, a raising invalidator, or an injected fault
(``process.identity``) is counted and the window proceeds unhardened
rather than lost.

``PARCA_NO_PID_GENERATION=1`` pins the hardening off — the bench zoo's
misattribution control arm, same idiom as PARCA_NO_CAPTURE_HASH.

The port's copy of parca_agent_tpu's process/identity.py.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterable

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.poison import read_bounded
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

# /proc/<pid>/stat is one short line; anything larger is not procfs.
_STAT_CAP = 1 << 16
# Bound on remembered generations: entries for pids absent from the
# current window are trimmed once the table grows past this (a dead,
# never-reused pid must not leak memory forever).
_MAX_TRACKED = 1 << 20


def read_starttime(fs: VFS, pid: int) -> int:
    """Starttime (field 22 of /proc/<pid>/stat) in clock ticks since
    boot. Raises on unreadable/absent/garbled stat — callers own the
    fail-open. Parsed after the last ``)`` (comm may embed spaces and
    parens), same as capture/procfs.py's cpu-tick read: field N of the
    stat line is index N-3 of the post-comm split."""
    data = read_bounded(fs, f"/proc/{int(pid)}/stat", _STAT_CAP,
                        site="process.identity")
    rp = data.rfind(b")")
    if rp < 0:
        raise ValueError(f"garbled stat for pid {pid}")
    fields = data[rp + 1:].split()
    return int(fields[19])


class ProcessIdentityTracker:
    """Per-window pid-generation check with pluggable invalidation.

    ``starttime_of`` defaults to the procfs read; tests and the bench
    zoo inject a callable backed by their scenario's world state.
    Invalidators are ``(name, fn(pid))`` pairs registered by the wiring
    layer (cli.py / the zoo runner); each fires under its own guard so
    one raising layer never blocks the others from dropping stale
    state."""

    def __init__(self, starttime_of: Callable[[int], int] | None = None,
                 fs: VFS | None = None, enabled: bool | None = None):
        fs = fs if fs is not None else RealFS()
        self._start_of = (starttime_of if starttime_of is not None
                          else lambda pid: read_starttime(fs, pid))
        if enabled is None:
            enabled = os.environ.get("PARCA_NO_PID_GENERATION", "") != "1"
        self.enabled = enabled
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._gens: dict[int, int] = {}   # pid -> last observed starttime
        self._invalidators: list[tuple[str, Callable[[int], None]]] = []
        # guarded-by: _lock
        self.stats = {
            "checks_total": 0,
            "reuse_detected_total": 0,
            "invalidations_total": 0,
            "invalidation_errors_total": 0,
            "errors_total": 0,
            "trims_total": 0,
        }
        # guarded-by: _lock — last detected reuse, for /healthz.
        self._last_reuse: dict | None = None

    def add_invalidator(self, name: str,
                        fn: Callable[[int], None]) -> None:
        with self._lock:
            self._invalidators.append((name, fn))

    def forget(self, pid: int) -> None:
        """Drop a pid's remembered generation (process exit observed by
        a layer with better signal, e.g. cache eviction sweeps)."""
        with self._lock:
            self._gens.pop(int(pid), None)

    # palint: fail-open
    def observe_window(self, pids: Iterable[int]) -> list[int]:
        """Check every pid in this window's capture against its
        remembered starttime; fire invalidators for recycled pids.
        Returns the reused pids. Fail-open end to end: any error —
        including the injected ``process.identity`` fault — is counted
        and the window proceeds with whatever hardening landed."""
        reused: list[int] = []
        try:
            if not self.enabled:
                return reused
            faults.inject("process.identity")
            seen: set[int] = set()
            for pid in pids:
                pid = int(pid)
                if pid in seen or pid < 0:
                    continue  # kernel pseudo-pids have no /proc identity
                seen.add(pid)
                try:
                    start = int(self._start_of(pid))
                except Exception:
                    # Exited mid-window (or unreadable): keep the
                    # remembered generation — if the pid comes back it
                    # is BY DEFINITION a new incarnation and the stale
                    # entry is what lets us detect it.
                    with self._lock:
                        self.stats["errors_total"] += 1
                    continue
                with self._lock:
                    self.stats["checks_total"] += 1
                    prev = self._gens.get(pid)
                    self._gens[pid] = start
                if prev is not None and prev != start:
                    reused.append(pid)
                    with self._lock:
                        self.stats["reuse_detected_total"] += 1
                        self._last_reuse = {
                            "pid": pid, "old_starttime": prev,
                            "new_starttime": start}
                    self._invalidate(pid)
            self._trim(seen)
        except Exception:
            with self._lock:
                self.stats["errors_total"] += 1
        return reused

    def _invalidate(self, pid: int) -> None:
        with self._lock:
            hooks = list(self._invalidators)
        for _name, fn in hooks:
            # palint: fail-open
            try:
                fn(pid)
                with self._lock:
                    self.stats["invalidations_total"] += 1
            except Exception:
                with self._lock:
                    self.stats["invalidation_errors_total"] += 1

    def _trim(self, live: set[int]) -> None:
        """Bound the generation table: past _MAX_TRACKED, keep only the
        pids seen in the current window (held under the lock — the table
        swap must not interleave with a concurrent forget)."""
        with self._lock:
            if len(self._gens) <= max(_MAX_TRACKED, 4 * len(live)):
                return
            self._gens = {p: s for p, s in self._gens.items() if p in live}
            self.stats["trims_total"] += 1

    def metrics(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def snapshot(self) -> dict:
        """Observability view for /healthz (never turns readiness red)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "tracked_pids": len(self._gens),
                "invalidators": [n for n, _ in self._invalidators],
                "last_reuse": dict(self._last_reuse)
                               if self._last_reuse else None,
                "stats": dict(self.stats),
            }
