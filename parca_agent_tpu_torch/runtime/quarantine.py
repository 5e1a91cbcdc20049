"""Per-pid error budget, quarantine registry, and the degradation ladder.

The port's copy of parca_agent_tpu's runtime/quarantine.py. On the
ingest side the unit of failure must be ONE PID, not one window. Every
ingest-side consumer of untrusted per-process input — the mapping-table
builder, the streaming feeder, the unwind-table builder and the
symbolizer — reports per-pid faults here, and routes a faulty pid's samples down a
degradation ladder instead of dropping them:

    level 0  FULL        normal processing (symbolization, unwind, maps)
    level 1  ADDRESSES   addresses-only profile: no local symbolization,
                         no unwind-table build, but normalized address +
                         build id still travel (the reference's
                         server-side-symbolization contract,
                         symbol.go:55-139 — the profile stays useful)
    level 2  SCALAR      one scalar count sample; the pid still shows up
                         in aggregate CPU accounting, nothing else

Budget semantics mirror the supervisor's crash budget
(runtime/supervisor.py): a pid accumulating more than ``max_strikes``
input faults (or per-pid processing-deadline overruns) within its budget
window is QUARANTINED for a capped-exponential number of windows
(doubling per trip, like actor restart backoff), then enters PROBATION:
full processing resumes, but one more fault re-trips immediately with a
longer cooldown and — past ``escalate_after`` trips — a deeper ladder
level. ``probation_windows`` clean windows recover the pid fully, and a
sustained healthy run decays accumulated strikes (the supervisor's
healthy_after refresh), so an always-on agent only degrades pids that
are ACTIVELY feeding it poison.

All mutation is lock-protected: errors are recorded from the profiler
thread, the streaming feeder's tee, and (metrics reads) the HTTP thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from parca_agent_tpu_torch.utils.window_clock import (
    REFERENCE_WINDOW_S,
    check_window_s,
    windows_for,
)
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("quarantine")

LEVEL_FULL = 0
LEVEL_ADDRESSES = 1
LEVEL_SCALAR = 2

_LEVEL_NAMES = {LEVEL_FULL: "full", LEVEL_ADDRESSES: "addresses",
                LEVEL_SCALAR: "scalar"}


@dataclasses.dataclass
class _PidState:
    strikes: int = 0            # faults within the current budget window
    trips: int = 0              # times quarantined (escalation + backoff)
    state: str = "healthy"      # healthy | quarantined | probation
    level: int = LEVEL_FULL
    cooldown: int = 0           # quarantine windows left
    probation_left: int = 0     # clean windows needed for full recovery
    ok_windows: int = 0         # consecutive clean windows (strike decay)
    errored_this_window: bool = False
    last_error: str = ""
    last_site: str = ""
    tenant: str = ""            # resolved once at insert (tenant_of set)


class QuarantineRegistry:
    """The shared per-pid fault-containment state machine.

    trip → quarantined (ladder level ≥ 1, cooldown windows)
         → probation (full processing, watched)
         → recovered (clean) | re-tripped (instant, doubled cooldown)
    """

    def __init__(self, max_strikes: int = 3,
                 quarantine_windows: int = 3,
                 max_quarantine_windows: int = 60,
                 probation_windows: int = 2,
                 escalate_after: int = 2,
                 healthy_after_windows: int = 6,
                 deadline_s: float | None = None,
                 clock=time.perf_counter,
                 window_s: float = REFERENCE_WINDOW_S):
        self._max_strikes = max_strikes
        # Window-count knobs are wall-time commitments expressed at the
        # reference 10 s cadence (runtime/window_clock.py): a 3-window
        # cooldown means ~30 s of quarantine whatever the window length.
        # Strike counts (max_strikes, escalate_after) are per-FAULT, not
        # per-window, and stay unconverted. At the reference cadence the
        # conversion is an exact identity.
        check_window_s(window_s)
        self._base_cooldown = windows_for(quarantine_windows, window_s)
        self._max_cooldown = max(self._base_cooldown, windows_for(
            max_quarantine_windows, window_s))
        self._probation = windows_for(probation_windows, window_s)
        # 0 = straight to scalar on the first trip; N = N trips ride the
        # addresses-only level first.
        self._escalate_after = max(0, escalate_after)
        self._healthy_after = windows_for(healthy_after_windows, window_s)
        self.deadline_s = deadline_s
        self._clock = clock
        # Optional pid -> tenant hook (runtime/admission.py's resolver):
        # with it set, tracked-pid-cap eviction is scoped PER TENANT, so
        # a pid-churn storm from one tenant can only flush that tenant's
        # own quarantine history, never another's. Set once at wiring
        # time (cli.py), before any recording.
        self.tenant_of = None
        self._lock = threading.Lock()
        self._pids: dict[int, _PidState] = {}  # guarded-by: _lock
        self.stats = {  # guarded-by: _lock
            "errors_total": 0,
            "deadline_trips_total": 0,
            "trips_total": 0,
            "recoveries_total": 0,
            "samples_degraded_total": 0,
            "windows_salvaged_total": 0,
            "pids_forgotten_total": 0,
        }

    def forget_pid(self, pid: int) -> None:
        """Generation-stamped identity invalidation (process/identity.py):
        the pid was RECYCLED, so its tracked strikes/trips/ladder state
        belongs to a dead predecessor — a fresh innocent process must
        start with a clean budget, and a fresh hostile one must re-earn
        its quarantine (the tick_window docstring has always named this
        exact hazard). Dropping under the lock is the whole operation;
        unknown pids are a no-op."""
        with self._lock:
            if self._pids.pop(int(pid), None) is not None:
                self.stats["pids_forgotten_total"] += 1

    # -- fault reporting -----------------------------------------------------

    # Hard bound on tracked pids: a hostile workload spawning erroring
    # short-lived processes must not grow the registry without limit
    # (oldest healthy entries are evicted first; quarantined ones never).
    _MAX_TRACKED = 65536

    def record_error(self, pid: int, site: str, exc: BaseException) -> int:
        """One attributable input fault for ``pid``; returns the pid's
        ladder level after recording."""
        tenant = self._tenant_for(pid)
        with self._lock:
            if int(pid) not in self._pids \
                    and len(self._pids) >= self._MAX_TRACKED \
                    and not self._evict_one_locked(tenant):
                # Every tracked entry is quarantined: refuse the insert
                # rather than exceed the bound (or flush containment
                # state); the fault is still counted.
                self.stats["errors_total"] += 1
                return LEVEL_FULL
            st = self._pids.setdefault(int(pid), _PidState(tenant=tenant))
            self.stats["errors_total"] += 1
            st.errored_this_window = True
            st.ok_windows = 0
            st.last_error = repr(exc)[:200]
            st.last_site = site
            if st.state == "quarantined":
                # Inputs should not be parsed while quarantined; a stray
                # report just refreshes the record.
                return st.level
            if st.state == "probation":
                # Still poisonous: re-trip immediately, doubled cooldown.
                self._trip(st, pid)
                return st.level
            st.strikes += 1
            if st.strikes > self._max_strikes:
                self._trip(st, pid)
            return st.level

    def record_deadline(self, pid: int, elapsed_s: float) -> int:
        """Per-pid processing-deadline overrun — a fault like any other
        (a pathological input that parses *slowly* poisons the window as
        surely as one that throws)."""
        level = self.record_error(
            pid, "deadline",
            TimeoutError(f"pid processing exceeded deadline "
                         f"({elapsed_s:.3f}s > {self.deadline_s}s)"))
        with self._lock:
            self.stats["deadline_trips_total"] += 1
        return level

    def _tenant_for(self, pid: int) -> str:
        """Tenant of a pid about to be tracked; "" without a resolver or
        on a resolver failure (eviction then falls back to the global
        rule — the resolver is itself fail-open, this is belt-and-
        braces). Called OUTSIDE the registry lock: the resolver takes
        its own lock and may touch /proc."""
        if self.tenant_of is None:
            return ""
        try:
            return str(self.tenant_of(int(pid)))
        except Exception:  # noqa: BLE001 - eviction scoping is best-effort
            return ""

    def _evict_one_locked(self, tenant: str = "") -> bool:  # palint: holds=_lock
        """Make room at the tracked-pid cap: evict the least-incriminated
        non-quarantined entry (fewest trips, then strikes, oldest first),
        so a churn of one-error pids can never flush a persistently
        poisonous pid's accumulated state. With a tenant resolved for the
        INCOMING pid, the victim is drawn from that pid's OWN tenant
        first — a pid-churn storm from one tenant then recycles its own
        slots and other tenants' quarantine history survives; only a
        tenant with nothing evictable falls back to the global scan.
        False when every candidate entry is quarantined (nothing
        evictable)."""
        scopes = ([lambda st: st.tenant == tenant, lambda st: True]
                  if tenant else [lambda st: True])
        for in_scope in scopes:
            victim = None
            victim_key = None
            for old, st in self._pids.items():
                if st.state == "quarantined" or not in_scope(st):
                    continue
                key = (st.trips, st.strikes)
                if victim is None or key < victim_key:
                    victim, victim_key = old, key
                    if key == (0, 0):
                        break  # nothing beats a clean watched entry
            if victim is not None:
                del self._pids[victim]
                return True
        return False

    def check_deadline(self, pid: int, t0: float) -> None:
        """Caller-timed deadline check: ``t0`` from ``registry.clock()``."""
        if self.deadline_s is None:
            return
        elapsed = self._clock() - t0
        if elapsed > self.deadline_s:
            self.record_deadline(pid, elapsed)

    def clock(self) -> float:
        return self._clock()

    # There is deliberately NO record_ok/ship-receipt API: clean-window
    # credit is granted by tick_window to every watched pid that did not
    # error, so strikes decay (and exited pids are forgotten) even on
    # paths that never report successes — an error-free window is the
    # absence of faults, not a ship receipt.

    # -- queries (lock-free reads of immutable snapshots are fine; these
    #    take the lock because dict mutation can race resize) ---------------

    def level(self, pid: int) -> int:
        with self._lock:
            st = self._pids.get(int(pid))
            return st.level if st is not None else LEVEL_FULL

    def is_quarantined(self, pid: int) -> bool:
        with self._lock:
            st = self._pids.get(int(pid))
            return st is not None and st.state == "quarantined"

    def quarantined_pids(self) -> list[int]:
        with self._lock:
            return sorted(p for p, st in self._pids.items()
                          if st.state == "quarantined")

    # -- window boundary -----------------------------------------------------

    def tick_window(self) -> None:
        """Advance every pid's state machine by one window; the profiler
        calls this once per iteration (quarantine time is WINDOW time —
        a stalled agent must not silently serve out cooldowns)."""
        with self._lock:
            salvaged = False
            drop = []
            for pid, st in self._pids.items():
                if st.state == "quarantined":
                    salvaged = True
                    st.cooldown -= 1
                    if st.cooldown <= 0:
                        st.state = "probation"
                        st.probation_left = self._probation
                        st.level = LEVEL_FULL  # probation = full, watched
                        _log.info("pid entering probation", pid=pid,
                                  trips=st.trips)
                elif st.state == "probation":
                    if not st.errored_this_window:
                        st.probation_left -= 1
                        if st.probation_left <= 0:
                            st.state = "healthy"
                            st.strikes = 0
                            st.ok_windows = 0
                            self.stats["recoveries_total"] += 1
                            _log.info("pid recovered from quarantine",
                                      pid=pid, trips=st.trips)
                else:  # healthy, but watched
                    if not st.errored_this_window:
                        # Clean-window credit is granted HERE, not via
                        # record_ok: a pid that exited (or a fast-encode
                        # run that never reports ship successes) must
                        # still decay its strikes and eventually be
                        # forgotten, or pid reuse hands an innocent new
                        # process a stale budget.
                        st.ok_windows += 1
                        if st.ok_windows >= self._healthy_after:
                            if st.strikes or st.trips:
                                # Sustained clean run refreshes the
                                # budget (supervisor healthy_after
                                # semantics).
                                st.strikes = 0
                                st.trips = 0
                                st.ok_windows = 0
                            else:
                                drop.append(pid)  # nothing to remember
                st.errored_this_window = False
            for pid in drop:
                del self._pids[pid]
            if salvaged:
                self.stats["windows_salvaged_total"] += 1

    def _trip(self, st: _PidState, pid: int) -> None:  # palint: holds=_lock
        # Lock held by caller.
        st.trips += 1
        st.state = "quarantined"
        st.level = (LEVEL_ADDRESSES if st.trips <= self._escalate_after
                    else LEVEL_SCALAR)
        st.cooldown = min(self._base_cooldown * (2 ** (st.trips - 1)),
                          self._max_cooldown)
        st.strikes = 0
        self.stats["trips_total"] += 1
        _log.warn("pid quarantined", pid=pid, trips=st.trips,
                  ladder=_LEVEL_NAMES[st.level],
                  cooldown_windows=st.cooldown,
                  site=st.last_site, error=st.last_error)

    # -- observability -------------------------------------------------------

    def counts(self) -> dict[str, int]:
        with self._lock:
            return self._counts_locked()

    def _counts_locked(self) -> dict[str, int]:  # palint: holds=_lock
        out = {"quarantined": 0, "probation": 0, "watched": 0,
               "level_addresses": 0, "level_scalar": 0}
        for st in self._pids.values():
            if st.state == "quarantined":
                out["quarantined"] += 1
                key = ("level_addresses"
                       if st.level == LEVEL_ADDRESSES
                       else "level_scalar")
                out[key] += 1
            elif st.state == "probation":
                out["probation"] += 1
            else:
                out["watched"] += 1
        return out

    def snapshot(self, limit: int = 100) -> dict:
        """JSON-shaped view for /healthz (bounded: a poisoned fleet must
        not turn the health endpoint into a megabyte dump)."""
        with self._lock:
            pids = {}
            for pid, st in sorted(self._pids.items())[:limit]:
                pids[str(pid)] = {
                    "state": st.state,
                    "level": _LEVEL_NAMES[st.level],
                    "strikes": st.strikes,
                    "trips": st.trips,
                    "cooldown_windows": st.cooldown,
                    "last_site": st.last_site,
                    "last_error": st.last_error,
                }
            return {"counts": self._counts_locked(),
                    "stats": dict(self.stats), "pids": pids}


# -- the degradation ladder over aggregated profiles -------------------------


def scalar_profile(prof):
    """Collapse one PidProfile to its scalar count: one depth-1 sample at
    (unmapped, unsymbolized) address 0 carrying the pid's total. The
    window's aggregate CPU accounting stays exact; everything else about
    the pid is withheld."""
    from parca_agent_tpu_torch.aggregator.base import PidProfile

    return PidProfile(
        pid=prof.pid,
        stack_loc_ids=np.array([[1]], np.int32),
        stack_depths=np.array([1], np.int32),
        values=np.array([prof.total()], np.int64),
        loc_address=np.zeros(1, np.uint64),
        loc_normalized=np.zeros(1, np.uint64),
        loc_mapping_id=np.zeros(1, np.int32),
        loc_is_kernel=np.zeros(1, bool),
        mappings=[],
        period_ns=prof.period_ns,
        time_ns=prof.time_ns,
        duration_ns=prof.duration_ns,
    )


def apply_ladder(profiles, registry: QuarantineRegistry | None,
                 admission=None):
    """Route each profile down its pid's ladder level — the max of the
    quarantine registry's (poison containment) and the admission
    controller's (quota/overload fairness, runtime/admission.py) when
    both are wired. Level 0 passes through untouched; level 1 strips
    local symbolization artifacts (normalized addresses + build ids
    still travel — byte-identical to an unsymbolized profile through
    the pprof builder); level 2 becomes the scalar count. Never drops a
    profile, and degraded mass is charged to whichever layer demanded
    the deeper level."""
    if registry is None and admission is None:
        return list(profiles)
    out = []
    degraded_samples = 0
    admission_samples = 0
    for prof in profiles:
        q_lvl = registry.level(prof.pid) if registry is not None \
            else LEVEL_FULL
        a_lvl = admission.level_for(prof.pid) if admission is not None \
            else LEVEL_FULL
        lvl = max(q_lvl, a_lvl)
        if lvl == LEVEL_FULL:
            out.append(prof)
            continue
        if a_lvl > q_lvl:
            admission_samples += prof.total()
        else:
            degraded_samples += prof.total()
        if lvl == LEVEL_ADDRESSES:
            prof.functions = []
            prof.loc_lines = None
            out.append(prof)
        else:
            out.append(scalar_profile(prof))
    if degraded_samples:
        with registry._lock:
            registry.stats["samples_degraded_total"] += degraded_samples
    if admission_samples:
        admission.count_degraded(admission_samples)
    return out
