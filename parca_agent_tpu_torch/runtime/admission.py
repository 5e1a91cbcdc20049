"""Multi-tenant admission control: fair overload shedding on the pid axis.

The port's copy of parca_agent_tpu's runtime/admission.py. A
whole-machine profiler under fleet traffic faces hundreds of thousands
of short-lived pids (kube pods, CI sandboxes, serverless), and without
admission ONE noisy tenant can evict everyone else's registry state or
blow the close-latency budget — the quarantine registry contains
*poisonous* pids, not *greedy* ones. This module is the
fairness twin (docs/robustness.md "multi-tenant admission"; Atys,
arxiv 2506.15523, makes the same per-service-fairness argument one
layer up):

  * :class:`TenantResolver` maps pid -> tenant identity from the
    `/proc/<pid>/cgroup` path (the parse lives in
    metadata/providers.py:parse_cgroup_path, bounded and PoisonInput-
    disciplined like every other /proc reader). Resolution is FAIL-OPEN:
    anything going wrong lands the pid in the "unknown" tenant, counted,
    never costing a window.
  * :class:`AdmissionController` accounts per-tenant sample/pid usage
    against token buckets refilled on the WINDOW clock and, when a
    tenant runs dry, rides its pids down the existing QuarantineRegistry
    degradation ladder (full -> addresses-only -> scalar,
    runtime/quarantine.py) — fidelity is shed, samples NEVER are, and
    in-quota tenants are untouched by construction (their level is
    simply never raised).
  * A global overload governor watches close latency, registry size,
    and encode-pipeline backlog; when the whole agent is over budget
    for `shed_after` consecutive windows it sheds proportionally from
    the HEAVIEST tenants first (largest last-window sample mass, enough
    of them to cover about half the window), one ladder step per shed
    window, and releases the sheds stepwise once the agent has been
    back in budget for `recover_after` windows.
  * :meth:`AdmissionController.shard_of` keys pid -> shard routing for
    the mesh-sharded dict aggregator (aggregator/sharded.py:route_h2)
    by tenant, so one tenant's registry growth concentrates on its home
    shard instead of polluting every sub-table.

Enforcement scope, by write path (the same shape the quarantine ladder
has always had): on the scalar/symbolized path, ``apply_ladder``
and the symbolizer enforce every rung (addresses-only strip, scalar
collapse). Under ``--fast-encode`` the agent already ships
unsymbolized, addresses-only profiles for EVERY pid by design (the
reference's server-side-symbolization wire contract), so the ladder's
level-1 fidelity is the fast path's baseline and the scalar rung is
not applied there — admission still accounts, routes shards by
tenant, scopes quarantine eviction, drives the governor, and exports
per-tenant state; what it does not do on that path is further reduce
already-addresses-only output. The CLI logs this scope at startup.

Chaos sites (utils/faults.py): ``admission.resolve`` (one pid's tenant
resolution) and ``admission.shed`` (one governor shed step) — both
fail-open by contract: an injected fault is counted and costs at most
tenant attribution ("unknown") or one shed step, never a window.

Thread contract: account_window/tick_window/level_for run on the
profiler thread; metrics/snapshot on the HTTP thread; shard_of on
whatever thread feeds the aggregator. All shared state is behind one
lock.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
import zlib

import numpy as np

from parca_agent_tpu_torch.metadata.providers import (
    CGROUP_MAX_BYTES,
    parse_cgroup_path,
)
from parca_agent_tpu_torch.runtime.quarantine import (
    LEVEL_ADDRESSES,
    LEVEL_FULL,
    LEVEL_SCALAR,
)
from parca_agent_tpu_torch.utils.window_clock import (
    REFERENCE_WINDOW_S,
    check_window_s,
    per_window,
    windows_for,
)
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.poison import read_bounded
from parca_agent_tpu_torch.utils.vfs import RealFS

_log = get_logger("admission")

# The label key the TenantProvider attaches and the /query + /hotspots
# `tenant=` selector shorthand expands to: ONE identity from cgroup to
# quota to read path (metadata/providers.py keeps the literal in sync).
TENANT_LABEL = "tenant"

# Tenant ids are derived from cgroup paths but travel as metric labels
# and HTTP selector values; the validator is the shared gate.
_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:@/-]{0,127}$")

UNKNOWN_TENANT = "unknown"


def validate_tenant(value: str) -> str:
    """A well-formed tenant selector value, or ValueError (the HTTP
    handlers turn it into a 400)."""
    if not isinstance(value, str) or not _TENANT_RE.match(value):
        raise ValueError(f"malformed tenant value {str(value)[:64]!r}")
    return value


_POD_RE = re.compile(r"pod([0-9a-fA-F][0-9a-fA-F_-]{7,63})")
_CTR_RE = re.compile(r"(?:docker|cri-containerd|crio)[/:-]([0-9a-f]{12,64})")
_USER_RE = re.compile(r"/user\.slice/user-(\d+)\.slice")


def tenant_from_cgroup(path: str | None) -> str:
    """Tenant identity out of a primary cgroup path. Recognized shapes,
    most specific first: kube pod uid, container id, user slice, systemd
    unit, else the first path component; root/empty is "system". The
    result always passes validate_tenant (hostile path bytes collapse
    to the unknown tenant rather than poisoning a metric label)."""
    if not path or path == "/":
        return "system"
    m = _POD_RE.search(path)
    if m:
        tenant = "pod:" + m.group(1).replace("_", "-").lower()
    else:
        m = _CTR_RE.search(path)
        if m:
            tenant = "ctr:" + m.group(1)[:12]
        else:
            m = _USER_RE.search(path)
            if m:
                tenant = "user:" + m.group(1)
            else:
                unit = None
                for comp in path.split("/"):
                    if comp:
                        unit = comp
                        if comp != "system.slice":
                            break
                if unit is None:
                    return "system"
                tenant = ("svc:" + unit if unit.endswith(
                    (".service", ".scope", ".slice")) else "grp:" + unit)
    try:
        return validate_tenant(tenant)
    except ValueError:
        return UNKNOWN_TENANT


class TenantResolver:
    """pid -> tenant, from `/proc/<pid>/cgroup`, LRU-cached and
    fail-open. The cache is bounded (pid churn must not grow it without
    limit) and entries carry a TTL: pid REUSE would otherwise hand a
    recycled pid its dead predecessor's tenant forever (an actively
    profiled pid is a cache hit every window, so pure recency never
    ages it out) — past ``ttl_s`` a hit re-resolves, bounding any
    reuse mis-attribution to one TTL. Sized for a few hundred thousand
    live pids (~100 B/entry); past the cap the oldest entries recycle,
    which with a cyclic 500k+ pid scan degrades to one bounded cgroup
    read per pid per window — correct, observable via
    ``cache_hits_total`` flatlining, and the TTL re-read cost's upper
    bound anyway."""

    _MAX_CACHED = 1 << 18

    def __init__(self, fs=None, ttl_s: float = 300.0,
                 clock=time.monotonic):
        self._fs = fs if fs is not None else RealFS()
        self._ttl = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        # pid -> (tenant, resolved_at); dict order = recency.
        self._cache: dict[int, tuple[str, float]] = {}  # guarded-by: _lock
        self.stats = {  # guarded-by: _lock
            "resolves_total": 0,
            "cache_hits_total": 0,
            "cache_expired_total": 0,
            "resolve_errors_total": 0,
        }

    def resolve(self, pid: int) -> str:
        pid = int(pid)
        now = self._clock()
        with self._lock:
            got = self._cache.pop(pid, None)
            if got is not None:
                if now - got[1] <= self._ttl:
                    self._cache[pid] = got  # re-insert: recency order
                    self.stats["cache_hits_total"] += 1
                    return got[0]
                self.stats["cache_expired_total"] += 1
        tenant = self._resolve_uncached(pid)
        with self._lock:
            self.stats["resolves_total"] += 1
            if len(self._cache) >= self._MAX_CACHED:
                self._cache.pop(next(iter(self._cache)))  # oldest
            self._cache[pid] = (tenant, now)
        return tenant

    # palint: fail-open
    def _resolve_uncached(self, pid: int) -> str:
        """One bounded cgroup read + parse. Fail-open by contract: a
        missing file (pid exited), poison (row/byte bomb), or an
        injected fault is counted and lands the pid in the unknown
        tenant — admission is a fairness layer, never a window risk."""
        try:
            faults.inject("admission.resolve")
            data = read_bounded(self._fs, f"/proc/{pid}/cgroup",
                                CGROUP_MAX_BYTES, site="admission.resolve")
            return tenant_from_cgroup(parse_cgroup_path(data))
        except Exception as e:  # noqa: BLE001 - counted, fail-open
            with self._lock:
                self.stats["resolve_errors_total"] += 1
            _log.debug("tenant resolution failed; pid joins the unknown "
                       "tenant", pid=pid, error=repr(e)[:120])
            return UNKNOWN_TENANT

    def forget(self, pid: int) -> None:
        with self._lock:
            self._cache.pop(int(pid), None)

    def shard_of(self, pid: int, n_shards: int) -> int:
        """Stable tenant -> shard placement for the sharded aggregator's
        pid routing (aggregator/sharded.py:route_h2): every pid of a
        tenant lands on one home shard, so registry growth parallelizes
        across tenants instead of spraying every sub-table."""
        tenant = self.resolve(pid)
        return zlib.crc32(tenant.encode()) % max(1, int(n_shards))


@dataclasses.dataclass
class OverloadPolicy:
    """Global overload budget for the governor. A signal with a zero
    threshold is disabled; the agent is "over budget" in a window when
    ANY enabled signal exceeds its threshold."""

    close_latency_s: float = 0.0   # window close slower than this
    registry_rows: int = 0         # dict-registry unique stacks above this
    backlog: int = 0               # encode backpressure fallbacks/window
    shed_after: int = 3            # consecutive over-budget windows to shed
    recover_after: int = 6         # consecutive in-budget windows to release

    def enabled(self) -> bool:
        return (self.close_latency_s > 0 or self.registry_rows > 0
                or self.backlog > 0)


@dataclasses.dataclass
class _TenantState:
    tokens_samples: float = 0.0
    tokens_pids: float = 0.0
    level: int = LEVEL_FULL        # quota ladder level
    shed_level: int = LEVEL_FULL   # governor overlay (max of both applies)
    over_windows: int = 0
    clean_windows: int = 0
    idle_windows: int = 0
    samples_window: int = 0        # usage accumulating THIS window
    pids_window: int = 0
    samples_last: int = 0          # previous window (governor ranking)
    pids_last: int = 0
    samples_total: int = 0
    over_quota_windows_total: int = 0


class AdmissionController:
    """Per-tenant token-bucket quotas + the global overload governor.

    Quota semantics, on the window clock (tick_window is called by the
    profiler once per iteration, like the quarantine registry's):

      * each tenant's buckets refill by `quota` per window, capped at
        `burst_windows * quota` (a quiet tenant banks a short burst);
      * a window whose usage drains a bucket below zero is OVER QUOTA:
        after `degrade_after` consecutive over windows the tenant's
        pids ride the ladder at addresses-only, after `escalate_after`
        more at scalar — samples always travel (scalar_profile keeps
        the mass exact), fidelity is what's shed;
      * `recover_windows` consecutive in-quota windows step the level
        back DOWN one rung, so recovery is full -> addresses -> full
        fidelity, mirroring how it was lost.

    In-quota tenants are untouched by construction: nothing in the
    quota path ever raises another tenant's level, and the governor's
    shed order (heaviest first) can only reach a light tenant after
    every heavier one is already shed.
    """

    _MAX_TENANTS = 4096
    _IDLE_FORGET_WINDOWS = 60
    # Bound on the fork-storm seen-pid set; past it the set restarts
    # from the current window (a long-lived fleet cycling through the
    # pid space must not hold every pid ever observed).
    _MAX_SEEN_PIDS = 1 << 20

    def __init__(self, resolver: TenantResolver,
                 quota_samples: int = 0, quota_pids: int = 0,
                 burst_windows: int = 3, degrade_after: int = 2,
                 escalate_after: int = 3, recover_windows: int = 3,
                 overload: OverloadPolicy | None = None,
                 top_n: int = 10, storm_new_pids: int = 0,
                 window_s: float = REFERENCE_WINDOW_S):
        if quota_samples < 0 or quota_pids < 0:
            raise ValueError("tenant quotas must be >= 0")
        self.resolver = resolver
        # Every knob is expressed at the reference 10 s window and
        # converted here (runtime/window_clock.py): quotas are
        # per-window REFILLS (same samples/second at any cadence),
        # window-count knobs are wall-time commitments (same seconds of
        # patience at any cadence). At the reference cadence both
        # conversions are exact identities.
        self._window_s = check_window_s(window_s)
        self._quota_samples = per_window(quota_samples, window_s)
        self._quota_pids = per_window(quota_pids, window_s)
        self._burst = windows_for(burst_windows, window_s)
        self._degrade_after = windows_for(degrade_after, window_s)
        self._escalate_after = windows_for(escalate_after, window_s)
        self._recover = windows_for(recover_windows, window_s)
        self._idle_forget = windows_for(self._IDLE_FORGET_WINDOWS,
                                        window_s)
        self._overload = overload or OverloadPolicy()
        self._shed_after = windows_for(self._overload.shed_after, window_s)
        self._recover_after = windows_for(self._overload.recover_after,
                                          window_s)
        self._top_n = max(1, int(top_n))
        # Fork/exec-storm detection: a window introducing more than
        # `storm_new_pids` never-seen pids (0 = off) degrades via the
        # governor's shed step — discovery cost (maps parses, unwind
        # builds, registry inserts) is per NEW pid, paid before any
        # quota sees a sample.
        self._storm_threshold = per_window(
            max(0.0, float(storm_new_pids)), window_s)
        self._seen_pids: set[int] = set()   # guarded-by: _lock
        self._storm_new_window = 0          # guarded-by: _lock
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}  # guarded-by: _lock
        self._over_streak = 0       # guarded-by: _lock
        self._calm_streak = 0       # guarded-by: _lock
        self._last_backlog = 0      # guarded-by: _lock (cumulative diff)
        self.stats = {  # guarded-by: _lock
            "windows_total": 0,
            "tenants_tracked": 0,
            "tenants_degraded": 0,
            "tenants_evicted_total": 0,
            "over_quota_windows_total": 0,
            "overload_windows_total": 0,
            "shed_steps_total": 0,
            "shed_releases_total": 0,
            "shed_errors_total": 0,
            "samples_degraded_total": 0,
            "account_errors_total": 0,
            "fork_storm_windows_total": 0,
            "fork_storm_sheds_total": 0,
        }

    # -- per-window accounting (profiler thread) -----------------------------

    # palint: fail-open
    def account_window(self, pids, counts) -> None:
        """Charge one window's snapshot usage to its tenants. Fail-open:
        an accounting failure is counted and the window proceeds
        unadmitted — fairness enforcement degrades, profiles never do."""
        try:
            pids = np.asarray(pids, np.int64)
            if len(pids) == 0:
                return
            counts = np.asarray(counts, np.int64)
            upids, inverse = np.unique(pids, return_inverse=True)
            sums = np.bincount(inverse, weights=counts).astype(np.int64)
            per_tenant: dict[str, list[int]] = {}
            for i, pid in enumerate(upids.tolist()):
                agg = per_tenant.setdefault(
                    self.resolver.resolve(pid), [0, 0])
                agg[0] += int(sums[i])
                agg[1] += 1
            with self._lock:
                for tenant, (samples, n_pids) in per_tenant.items():
                    st = self._state_locked(tenant)
                    st.samples_window += samples
                    st.pids_window += n_pids
                    st.samples_total += samples
                    st.idle_windows = 0
                if self._storm_threshold > 0:
                    pid_list = upids.tolist()
                    self._storm_new_window += sum(
                        1 for p in pid_list if p not in self._seen_pids)
                    self._seen_pids.update(pid_list)
                    if len(self._seen_pids) > self._MAX_SEEN_PIDS:
                        self._seen_pids = set(pid_list)
        except Exception as e:  # noqa: BLE001 - counted, fail-open
            with self._lock:
                self.stats["account_errors_total"] += 1
            _log.warn("admission accounting failed for this window",
                      error=repr(e)[:200])

    def _state_locked(self, tenant: str) -> _TenantState:  # palint: holds=_lock
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= self._MAX_TENANTS:
                self._evict_tenant_locked()
            st = _TenantState(
                tokens_samples=float(self._quota_samples * self._burst),
                tokens_pids=float(self._quota_pids * self._burst))
            self._tenants[tenant] = st
        return st

    def _evict_tenant_locked(self) -> None:  # palint: holds=_lock
        """Room at the tenant cap: drop the idlest fully-recovered
        tenant (an over-quota or shed tenant's state is containment
        history and survives, mirroring the quarantine registry's
        eviction discipline)."""
        victim, victim_key = None, None
        for name, st in self._tenants.items():
            if st.level != LEVEL_FULL or st.shed_level != LEVEL_FULL:
                continue
            key = (-st.idle_windows, st.samples_total)
            if victim is None or key < victim_key:
                victim, victim_key = name, key
        if victim is None:  # every tenant degraded: drop the idlest anyway
            for name, st in self._tenants.items():
                if victim is None \
                        or st.idle_windows > victim_key:
                    victim, victim_key = name, st.idle_windows
        del self._tenants[victim]
        self.stats["tenants_evicted_total"] += 1

    # -- the window boundary (profiler thread) -------------------------------

    # palint: fail-open
    def tick_window(self, close_latency_s: float = 0.0,
                    registry_rows: int = 0, backlog: int = 0) -> None:
        """Advance every tenant's bucket + ladder by one window, then run
        the governor over this window's overload signals (`backlog` is
        the encode pipeline's CUMULATIVE backpressure counter; the diff
        is taken here). Fail-open like account_window: a tick failure is
        counted, never raised into the profiler loop."""
        try:
            with self._lock:
                self.stats["windows_total"] += 1
                drop = []
                for tenant, st in self._tenants.items():
                    self._tick_tenant_locked(tenant, st)
                    if st.idle_windows >= self._idle_forget \
                            and st.level == LEVEL_FULL \
                            and st.shed_level == LEVEL_FULL:
                        drop.append(tenant)
                for tenant in drop:
                    del self._tenants[tenant]
                self._govern_locked(close_latency_s, registry_rows,
                                    backlog)
                self._storm_tick_locked()
                self.stats["tenants_tracked"] = len(self._tenants)
                self.stats["tenants_degraded"] = sum(
                    1 for st in self._tenants.values()
                    if max(st.level, st.shed_level) > LEVEL_FULL)
        except Exception as e:  # noqa: BLE001 - counted, fail-open
            with self._lock:
                self.stats["account_errors_total"] += 1
            _log.warn("admission tick failed for this window",
                      error=repr(e)[:200])

    def _tick_tenant_locked(self, tenant: str,
                            st: _TenantState) -> None:  # palint: holds=_lock
        over = False
        if self._quota_samples > 0:
            st.tokens_samples = min(
                st.tokens_samples + self._quota_samples,
                float(self._quota_samples * self._burst))
            st.tokens_samples -= st.samples_window
            if st.tokens_samples < 0:
                over = True
                st.tokens_samples = 0.0  # no debt past the window
        if self._quota_pids > 0:
            st.tokens_pids = min(
                st.tokens_pids + self._quota_pids,
                float(self._quota_pids * self._burst))
            st.tokens_pids -= st.pids_window
            if st.tokens_pids < 0:
                over = True
                st.tokens_pids = 0.0
        if over:
            st.over_windows += 1
            st.clean_windows = 0
            st.over_quota_windows_total += 1
            self.stats["over_quota_windows_total"] += 1
            if st.over_windows >= self._degrade_after + self._escalate_after:
                new = LEVEL_SCALAR
            elif st.over_windows >= self._degrade_after:
                new = LEVEL_ADDRESSES
            else:
                new = st.level
            if new > st.level:
                st.level = new
                _log.warn("tenant over quota; degrading its pids",
                          tenant=tenant, ladder=st.level,
                          over_windows=st.over_windows)
        else:
            st.clean_windows += 1
            st.over_windows = 0
            if st.level > LEVEL_FULL \
                    and st.clean_windows >= self._recover:
                st.level -= 1  # one rung at a time: scalar->addresses->full
                st.clean_windows = 0
                _log.info("tenant back in quota; easing its ladder level",
                          tenant=tenant, ladder=st.level)
        if st.samples_window == 0 and st.pids_window == 0:
            st.idle_windows += 1
        st.samples_last = st.samples_window
        st.pids_last = st.pids_window
        st.samples_window = 0
        st.pids_window = 0

    # -- the global overload governor ----------------------------------------

    def _govern_locked(self, close_latency_s: float, registry_rows: int,
                       backlog: int) -> None:  # palint: holds=_lock
        if not self._overload.enabled():
            return
        backlog_delta = max(0, int(backlog) - self._last_backlog)
        self._last_backlog = int(backlog)
        over = (
            (self._overload.close_latency_s > 0
             and close_latency_s > self._overload.close_latency_s)
            or (self._overload.registry_rows > 0
                and registry_rows > self._overload.registry_rows)
            or (self._overload.backlog > 0
                and backlog_delta >= self._overload.backlog))
        if over:
            self.stats["overload_windows_total"] += 1
            self._over_streak += 1
            self._calm_streak = 0
            if self._over_streak >= self._shed_after:
                self._shed_locked()
        else:
            self._over_streak = 0
            self._calm_streak += 1
            if self._calm_streak >= self._recover_after:
                self._calm_streak = 0
                self._release_locked()

    def _storm_tick_locked(self) -> None:  # palint: holds=_lock
        """Fork/exec-storm admission: when one window introduced more
        never-seen pids than the threshold (container churn, serverless
        cold-start bursts), degrade via the EXISTING governor shed step
        — heaviest tenants ride the ladder one rung, samples still
        travel — instead of letting per-new-pid discovery work blow the
        window. Recovery rides the governor's normal calm-streak
        release; a quiet fleet pays nothing (threshold 0 = off)."""
        if self._storm_threshold <= 0:
            return
        n_new = self._storm_new_window
        self._storm_new_window = 0
        if n_new <= self._storm_threshold:
            return
        self.stats["fork_storm_windows_total"] += 1
        self._shed_locked()
        self.stats["fork_storm_sheds_total"] += 1
        _log.warn("fork storm: shedding one ladder rung",
                  new_pids=n_new, threshold=self._storm_threshold)

    def _shed_locked(self) -> None:  # palint: holds=_lock
        """One shed step: degrade the heaviest SHEDDABLE tenants (by
        last-window sample mass, descending) one ladder rung each,
        taking tenants until ~half the sheddable mass is covered —
        proportional shedding that reaches a light tenant only after
        every heavier one is already at the ladder's floor. Tenants
        already at LEVEL_SCALAR are excluded from both the target and
        the coverage (counting them would make later shed steps no-ops
        once the head of the distribution is fully shed, and starve
        the mid-weight tenants the step exists to reach). Fail-open:
        an injected/real fault here is counted and costs this window's
        shed step, nothing else."""
        try:
            faults.inject("admission.shed")
            ranked = []
            total = 0
            for tenant, st in self._tenants.items():
                if st.shed_level < LEVEL_SCALAR and st.samples_last > 0:
                    ranked.append((tenant, st))
                    total += st.samples_last
            ranked.sort(key=lambda kv: kv[1].samples_last, reverse=True)
            target = total / 2
            covered = 0
            for tenant, st in ranked:
                if covered >= target:
                    break
                covered += st.samples_last
                st.shed_level += 1
                self.stats["shed_steps_total"] += 1
                _log.warn("overload governor shedding tenant",
                          tenant=tenant, shed_level=st.shed_level,
                          window_samples=st.samples_last)
        except Exception as e:  # noqa: BLE001 - counted, fail-open
            self.stats["shed_errors_total"] += 1
            _log.warn("overload shed step failed; skipped",
                      error=repr(e)[:200])

    def _release_locked(self) -> None:  # palint: holds=_lock
        for tenant, st in self._tenants.items():
            if st.shed_level > LEVEL_FULL:
                st.shed_level -= 1
                self.stats["shed_releases_total"] += 1
                _log.info("overload cleared; releasing shed tenant",
                          tenant=tenant, shed_level=st.shed_level)

    # -- queries -------------------------------------------------------------

    def level_for(self, pid: int) -> int:
        """The pid's admission ladder level (max of its tenant's quota
        level and the governor's shed overlay); FULL for anything
        unresolvable — degradation must be a positive decision."""
        try:
            tenant = self.resolver.resolve(pid)
            with self._lock:
                st = self._tenants.get(tenant)
                if st is None:
                    return LEVEL_FULL
                return max(st.level, st.shed_level)
        except Exception:  # noqa: BLE001 - never degrade by accident
            return LEVEL_FULL

    def tenant_level(self, tenant: str) -> int:
        with self._lock:
            st = self._tenants.get(tenant)
            return max(st.level, st.shed_level) if st is not None \
                else LEVEL_FULL

    def count_degraded(self, samples: int) -> None:
        """Sample mass that rode the ladder because of ADMISSION (the
        quarantine registry counts its own); fed by apply_ladder."""
        with self._lock:
            self.stats["samples_degraded_total"] += int(samples)

    def shard_of(self, pid: int, n_shards: int) -> int:
        return self.resolver.shard_of(pid, n_shards)

    # -- observability (HTTP thread) -----------------------------------------

    def metrics(self) -> dict:
        """Bounded-cardinality view for /metrics: the top-N tenants by
        last-window mass, every DEGRADED tenant (the ones an operator is
        debugging), and one "other" rollup for the rest — a 100k-tenant
        host must not emit 100k label sets."""
        with self._lock:
            ranked = sorted(self._tenants.items(),
                            key=lambda kv: kv[1].samples_last,
                            reverse=True)
            rows = []
            other = {"tenant": "other", "samples": 0, "window_samples": 0,
                     "pids": 0, "level": 0, "over_quota": 0, "tenants": 0}
            for i, (tenant, st) in enumerate(ranked):
                lvl = max(st.level, st.shed_level)
                if i < self._top_n or lvl > LEVEL_FULL:
                    rows.append({
                        "tenant": tenant,
                        "samples": st.samples_total,
                        "window_samples": st.samples_last,
                        "pids": st.pids_last,
                        "level": lvl,
                        "over_quota": int(st.over_windows > 0),
                    })
                else:
                    other["samples"] += st.samples_total
                    other["window_samples"] += st.samples_last
                    other["pids"] += st.pids_last
                    other["tenants"] += 1
            if other["tenants"]:
                rows.append(other)
            return {"tenants": rows, "stats": dict(self.stats),
                    "resolver": dict(self.resolver.stats)}

    def snapshot(self, limit: int = 50) -> dict:
        """JSON view for /healthz (bounded like the quarantine one).
        By contract this section NEVER turns readiness red: shedding is
        the agent doing its job under load, not failing at it."""
        with self._lock:
            tenants = {}
            ranked = sorted(self._tenants.items(),
                            key=lambda kv: kv[1].samples_last,
                            reverse=True)
            for tenant, st in ranked[:limit]:
                tenants[tenant] = {
                    "level": max(st.level, st.shed_level),
                    "quota_level": st.level,
                    "shed_level": st.shed_level,
                    "over_windows": st.over_windows,
                    "window_samples": st.samples_last,
                    "window_pids": st.pids_last,
                    "samples_total": st.samples_total,
                }
            return {
                "quota_samples": self._quota_samples,
                "quota_pids": self._quota_pids,
                "over_streak": self._over_streak,
                "tenants": tenants,
                "stats": dict(self.stats),
                "resolver": dict(self.resolver.stats),
            }
