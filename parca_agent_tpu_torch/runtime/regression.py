"""Regression sentinel: continuous baseline-diff drift detection.

The agent aggregates (encode pipeline), indexes (hotspot store), and
exports (sinks, incl. AutoFDO profdata) profiles — this module is the
first subsystem that COMPARES them across time. A deploy that doubles a
function's cost, or drift that silently invalidates an emitted PGO
profile, should be a verdict on `/diff` and a marker beside the
profdata file, not a human staring at dashboards ("From Profiling to
Optimization", arxiv 2507.16649: stale profiles actively hurt PGO
builds; Atys, arxiv 2506.15523: fleet-scale hotspot analysis must ride
hierarchical aggregates, not raw profiles).

The unit of judgment is a 1-minute ROLLUP per (build-id, tenant) group:
every shipped window's rows are attributed by leaf binary (the same
build-id keying the AutoFDO sink uses, so staleness verdicts address
the same profdata files) and tenant label, then folded into the group's
open rollup — an exact bounded top-key table plus a count-min sketch
backstop, the hotspot store's candidate/cut design one level down. When
a rollup seals it is diffed against the group's BASELINE:

  * the baseline is a frozen merge of the group's first
    ``baseline_rollups`` sealed rollups, content-addressed (its id is a
    digest of its own bytes) and persisted with the statics_store
    crash-only tmp+rename discipline, adopted at startup;
  * the diff is sketch subtraction (ops/sketch.cm_sub) with the
    propagated two-sided count-min error bound
    ``eps * (total_cur + total_base)`` plus EXACT deltas on the tracked
    top keys;
  * a per-key noise floor is learned from historical rollup-to-rollup
    variance (EWMA of |delta|); unlearned keys default to a Poisson-ish
    ``sqrt(base)`` floor;
  * a verdict (``new_hotspot`` / ``regressed`` / ``improved``) fires
    only when the shift clears BOTH the noise floor (times ``k_sigma``)
    and the sketch error bound, plus an absolute ``min_count`` and a
    relative ``min_ratio`` — four gates, so 30 clean windows produce
    zero verdicts (the bench bar) while a genuine 2x shift clears all
    four within two rollup intervals;
  * a group whose normalized distribution distance vs its baseline
    exceeds ``drift_threshold`` (EWMA-smoothed, edge-triggered) emits a
    ``drifted`` verdict and calls the staleness hook — the AutoFDO sink
    marks that binary's profdata stale so downstream PGO refreshes.

Where the work runs: :meth:`fold_from_prepared` is the encode-pipeline
WORKER's rider, beside the hotspot rollup and statics snapshot hooks —
fail-open by contract (``regression.fold`` chaos site): an injected or
real failure is counted (``fold_errors``) and costs judgment freshness,
never a window, and can never delay the pprof ship (the fold runs after
it). Persistence rides the same worker (``regression.baseline`` site):
a failed save/adopt is counted and the sentinel stays warm-less, agent
unharmed. Queries (/diff) run on HTTP threads under one lock.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import struct
import threading
import time

import numpy as np

from parca_agent_tpu_torch.ops.sketch import CountMinSpec, cm_add, cm_query, cm_sub
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

# palint: persistence-root — frozen baselines are adopted at startup.

_log = get_logger("regression")

VERDICT_KINDS = ("new_hotspot", "regressed", "improved", "drifted")

_MAGIC = b"PAREGR1"
_FMARK = b"PRRC"                # per-frame marker (resync anchor)
_FRAME = struct.Struct("<II")   # payload len, crc32(payload)
_U32 = struct.Struct("<I")


@dataclasses.dataclass(frozen=True)
class RegressionSpec:
    """Sizing and sensitivity of the sentinel. The defaults detect a 2x
    shift on a hot binary within two rollup intervals while holding 30+
    clean windows verdict-free (the bench-regress acceptance bars)."""

    interval_s: float = 60.0        # rollup bucket span
    baseline_rollups: int = 5       # sealed rollups frozen into a baseline
    k_sigma: float = 4.0            # noise-floor multiplier
    min_count: int = 16             # absolute per-verdict count floor
    min_ratio: float = 1.5          # relative shift a verdict must clear
    drift_threshold: float = 0.5    # EWMA distribution distance -> stale
    max_groups: int = 256           # (build, tenant) groups tracked
    max_keys: int = 4096            # exact keys tracked per group
    fold_rows: int = 8192           # rows attributed per window (top by count)
    max_verdicts_per_rollup: int = 16
    repeat_every: int = 10          # rollups before re-emitting a held verdict
    verdict_ring: int = 1024
    save_every: int = 5             # baseline saves at most every N seals
    cm: CountMinSpec = CountMinSpec(depth=4, width=1 << 10)

    def __post_init__(self):
        if not (self.interval_s > 0):
            raise ValueError("interval_s must be > 0")
        if self.baseline_rollups < 1:
            raise ValueError("baseline_rollups must be >= 1")
        if self.k_sigma <= 0 or self.min_ratio < 1.0:
            raise ValueError("k_sigma must be > 0 and min_ratio >= 1.0")
        if not (0 < self.drift_threshold <= 1.0):
            raise ValueError("drift_threshold must be in (0, 1]")
        if self.max_groups < 1 or self.max_keys < 16:
            raise ValueError("max_groups >= 1 and max_keys >= 16 required")


class _Baseline:
    """A frozen merge of the group's first rollups: exact per-key totals
    plus the merged count-min table. Content-addressed: ``ident`` is a
    digest of the serialized content, so two agents that froze the same
    traffic agree on the id and a corrupted record can never adopt."""

    __slots__ = ("counts", "cm", "total", "rollups", "created_ns", "ident")

    def __init__(self, counts, cm_table, total, rollups, created_ns):
        self.counts: dict[int, int] = counts
        self.cm = cm_table
        self.total = int(total)
        self.rollups = int(rollups)
        self.created_ns = int(created_ns)
        self.ident = self._digest()

    def _digest(self) -> str:
        h = hashlib.sha256()
        h.update(struct.pack("<QQ", self.total, self.rollups))
        for k in sorted(self.counts):
            h.update(struct.pack("<Qq", k, self.counts[k]))
        h.update(np.ascontiguousarray(self.cm).tobytes())
        return h.hexdigest()[:16]

    def rate(self, key: int) -> float:
        """Per-rollup baseline rate for one stack key (exact for tracked
        keys, 0 for untracked — the cm upper bound rides separately)."""
        return self.counts.get(key, 0) / self.rollups


class _Group:
    """One (build-id, tenant) judgment stream: the open rollup, the
    learned noise floors, the frozen baseline, and the drift latch."""

    __slots__ = ("build", "tenant", "synthetic",
                 "open_counts", "open_cm", "open_total", "open_windows",
                 "open_t0_ns", "open_until_ns",
                 "pending_counts", "pending_cm", "pending_total",
                 "pending_rollups", "baseline",
                 "floor", "last_counts", "last_total",
                 "drift", "stale_marked", "rollups_sealed", "active")

    def __init__(self, build: str, tenant: str, spec: RegressionSpec):
        self.build = build
        self.tenant = tenant
        # Kernel/unmapped leaves are judged like any binary but have no
        # profdata file to mark stale.
        self.synthetic = build in ("kernel", "unmapped")
        self.open_counts: dict[int, int] = {}
        self.open_cm = np.zeros((spec.cm.depth, spec.cm.width), np.int64)
        self.open_total = 0
        self.open_windows = 0
        self.open_t0_ns = 0
        self.open_until_ns = 0
        self.pending_counts: dict[int, int] = {}
        self.pending_cm = np.zeros((spec.cm.depth, spec.cm.width), np.int64)
        self.pending_total = 0
        self.pending_rollups = 0
        self.baseline: _Baseline | None = None
        self.floor: dict[int, float] = {}      # key -> EWMA |rollup delta|
        self.last_counts: dict[int, int] | None = None
        self.last_total = 0
        self.drift = 0.0
        self.stale_marked = False
        self.rollups_sealed = 0
        self.active: dict[int, tuple[str, int]] = {}  # key -> (kind, seal#)

    def reset_open(self, t0_ns: int, span_ns: int) -> None:
        self.open_counts = {}
        self.open_cm.fill(0)
        self.open_total = 0
        self.open_windows = 0
        self.open_t0_ns = t0_ns
        self.open_until_ns = (t0_ns // span_ns + 1) * span_ns


def _top_keys(counts: dict[int, int], k: int) -> list[int]:
    if len(counts) <= k:
        return list(counts)
    return sorted(counts, key=counts.__getitem__, reverse=True)[:k]


class RegressionSentinel:
    """Continuous baseline-diff over the per-(build, tenant) rollup
    stream.

    Thread model: fold_from_prepared runs on the encode pipeline's
    worker (the rollup/snapshot hooks' twin); verdicts()/diff_ranges()/
    metrics()/snapshot() on HTTP threads; drain_alerts() on whichever
    thread the alerts sink emits from (worker for pipelined windows,
    profiler for inline fallbacks). One lock guards groups, counters,
    and the verdict/alert rings; per-window attribution (the numpy/loop
    work) runs outside it.
    """

    def __init__(self, spec: RegressionSpec = RegressionSpec(),
                 path: str | None = None, labels_for=None,
                 clock=time.time, adopt: bool = True):
        self.spec = spec
        self.path = path
        # pid -> label dict hook (the profiler installs its lock-guarded
        # labels manager, exactly like the hotspot store); the "tenant"
        # label is the group axis. None = single "default" tenant.
        self.labels_for = labels_for
        self._clock = clock
        self._lock = threading.Lock()
        self._groups: dict[tuple[str, str], _Group] = {}
        self._verdicts: collections.deque = collections.deque(
            maxlen=spec.verdict_ring)
        self._alerts: collections.deque = collections.deque(maxlen=4096)
        self._mark_stale = None     # AutoFDO staleness hook (bind_staleness)
        self._stale_pending: list[str] = []  # guarded-by: _lock
        self._seals_unsaved = 0
        self._tenant_memo: dict[int, str] = {}
        self.stats = {  # guarded-by: _lock
            "windows_folded": 0,
            "windows_skipped": 0,    # no registry view: rows unreadable
            "fold_errors": 0,
            "rollups_sealed": 0,
            "groups_dropped": 0,
            "keys_overflow": 0,
            "rows_dropped": 0,
            "verdicts_suppressed": 0,
            "alerts_dropped": 0,
            "baselines_frozen": 0,
            "baseline_saves": 0,
            "baseline_save_errors": 0,
            "baselines_adopted": 0,
            "baseline_adopt_errors": 0,
            "stale_marks": 0,
            "stale_mark_errors": 0,
            "queries": 0,
            "query_errors": 0,
            "last_fold_s": 0.0,
        }
        self._verdict_counts = {k: 0 for k in VERDICT_KINDS}  # guarded-by: _lock
        if adopt and path:
            self._adopt()

    # -- wiring --------------------------------------------------------------

    def bind_staleness(self, hook) -> None:
        """Install the AutoFDO staleness hook: ``hook(build_key)`` is
        called (fail-open, counted) when a group's drift crosses the
        threshold — sinks/autofdo.py marks that binary's profdata stale."""
        self._mark_stale = hook

    # -- fold path (encode-pipeline worker) ----------------------------------

    # palint: fail-open
    def fold_from_prepared(self, view, prep) -> None:
        """Attribute one shipped window's rows by (leaf build-id, tenant)
        and fold them into the group rollups, sealing and judging any
        bucket the window clock closed. The encode worker's rider, after
        the ship: fail-open by contract — an injected
        (``regression.fold``) or real failure is counted and costs this
        window's judgment, never the window or the pprof bytes."""
        try:
            t0 = time.perf_counter()
            faults.inject("regression.fold")
            if view is None:
                with self._lock:
                    self.stats["windows_skipped"] += 1
                return
            self._fold(view, prep)
            self._flush_stale_marks()
            with self._lock:
                self.stats["windows_folded"] += 1
                self.stats["last_fold_s"] = time.perf_counter() - t0
            if self.path and self._seals_unsaved >= self.spec.save_every:
                self.save()
        except Exception as e:  # noqa: BLE001 - fail-open contract
            with self._lock:
                self.stats["fold_errors"] += 1
            _log.warn("regression fold failed; window unjudged",
                      error=repr(e))

    def _fold(self, view, prep) -> None:
        spec = self.spec
        idx = np.asarray(prep.idx)
        n = len(idx)
        span_ns = int(spec.interval_s * 1e9)
        now_ns = int(prep.time_ns)
        if n:
            vals = np.asarray(prep.vals, np.int64)
            h1, h2 = view.id_hashes(int(idx.max()) + 1)
            rh1 = h1[idx]
            key64 = ((rh1.astype(np.uint64) << np.uint64(32))
                     | h2[idx].astype(np.uint64))
            leaf = view._loc_flat[view._loc_off[idx]]
            pids = np.asarray(prep.pids_live)
            rows = np.arange(n)
            if n > spec.fold_rows:
                # Bounded attribution: the hottest rows carry the
                # regression signal; the tail is counted, not judged.
                part = np.argpartition(vals, n - spec.fold_rows)
                rows = part[n - spec.fold_rows:]
                with self._lock:
                    self.stats["rows_dropped"] += n - spec.fold_rows
            batches: dict[tuple[str, str], list] = {}
            caps = prep.caps
            for i in rows.tolist():
                pid = int(pids[i])
                build = self._build_for(caps.get(pid), int(leaf[i]))
                tenant = self._tenant_for(pid)
                b = batches.get((build, tenant))
                if b is None:
                    b = batches[(build, tenant)] = [[], [], []]
                b[0].append(int(key64[i]))
                b[1].append(int(rh1[i]))
                b[2].append(int(vals[i]))
        else:
            batches = {}
        with self._lock:
            # Seal every group the window clock has passed — including
            # untouched ones: a binary that vanished from the profile
            # (a deploy) must still be judged against its baseline.
            for g in self._groups.values():
                if g.open_until_ns and now_ns >= g.open_until_ns:
                    self._seal(g, span_ns, now_ns)
            for (build, tenant), (keys, h1s, counts) in batches.items():
                g = self._groups.get((build, tenant))
                if g is None:
                    if len(self._groups) >= spec.max_groups:
                        self.stats["groups_dropped"] += 1
                        continue
                    g = _Group(build, tenant, spec)
                    g.reset_open(now_ns, span_ns)
                    self._groups[(build, tenant)] = g
                if not g.open_until_ns:
                    g.reset_open(now_ns, span_ns)
                oc = g.open_counts
                for k, v in zip(keys, counts):
                    if k in oc:
                        oc[k] += v
                    elif len(oc) < spec.max_keys:
                        oc[k] = v
                    else:
                        # Past the exact-key cap the sketch still holds
                        # the mass — the diff falls back to cm bounds.
                        self.stats["keys_overflow"] += 1
                cm_add(g.open_cm, np.asarray(h1s, np.uint32),
                       np.asarray(counts, np.int64), spec.cm)
                g.open_total += int(sum(counts))
                g.open_windows += 1

    def _build_for(self, cap, leaf_loc: int) -> str:
        """Leaf binary key for one row, through the per-pid registry cap
        (the AutoFDO sink's attribution, sharing its keying so staleness
        verdicts address the same profdata files)."""
        from parca_agent_tpu_torch.sinks.autofdo import binary_key

        j = leaf_loc - 1  # registry loc ids are 1-based
        if cap is None or not (0 <= j < cap[2]):
            return "unmapped"
        reg = cap[0]
        if reg.loc_is_kernel[j]:
            return "kernel"
        mid = int(reg.loc_mapping_id[j])
        if not (1 <= mid <= cap[1]):
            return "unmapped"
        return binary_key(reg.mappings[mid - 1])

    def _tenant_for(self, pid: int) -> str:
        tenant = self._tenant_memo.get(pid)
        if tenant is not None:
            return tenant
        tenant = "default"
        if self.labels_for is not None:
            labels = self.labels_for(pid)
            if labels:
                tenant = str(labels.get("tenant") or "default")
        if len(self._tenant_memo) > 8192:
            self._tenant_memo.clear()
        self._tenant_memo[pid] = tenant
        return tenant

    # -- sealing + judgment (worker thread, under _lock) ---------------------

    # palint: holds=_lock
    def _seal(self, g: _Group, span_ns: int, now_ns: int) -> None:
        counts = g.open_counts
        total = g.open_total
        cm_table = g.open_cm.copy()
        t1_ns = g.open_until_ns
        g.rollups_sealed += 1
        self.stats["rollups_sealed"] += 1
        spec = self.spec
        if g.baseline is None:
            for k, v in counts.items():
                if k in g.pending_counts:
                    g.pending_counts[k] += v
                elif len(g.pending_counts) < spec.max_keys:
                    g.pending_counts[k] = v
            g.pending_cm += cm_table
            g.pending_total += total
            g.pending_rollups += 1
            if g.pending_rollups >= spec.baseline_rollups:
                g.baseline = _Baseline(
                    g.pending_counts, g.pending_cm.copy(),
                    g.pending_total, g.pending_rollups, t1_ns)
                g.pending_counts = {}
                g.pending_cm.fill(0)
                g.pending_total = 0
                self.stats["baselines_frozen"] += 1
                self._seals_unsaved = spec.save_every  # save at next fold
        else:
            self._judge(g, counts, cm_table, total, t1_ns)
            self._seals_unsaved += 1
        self._learn_floor(g, counts)
        g.last_counts = counts
        g.last_total = total
        # Re-open, aligned to the bucket grid the window clock sits in
        # (reset_open replaces the counts dict, so the `counts`
        # reference kept as last_counts above stays intact, and zeroes
        # the cm in place — cm_table was copied at the top).
        g.reset_open(max(now_ns, t1_ns), span_ns)

    # palint: holds=_lock
    def _learn_floor(self, g: _Group, counts: dict[int, int]) -> None:
        """Per-key noise floor: EWMA of |rollup-to-rollup delta| over the
        union of the previous and current top keys — the historical
        window-to-window variance a verdict must clear."""
        if g.last_counts is None:
            return
        spec = self.spec
        keys = set(_top_keys(counts, spec.max_verdicts_per_rollup * 4))
        keys.update(_top_keys(g.last_counts,
                              spec.max_verdicts_per_rollup * 4))
        floor = g.floor
        for k in keys:
            d = abs(counts.get(k, 0) - g.last_counts.get(k, 0))
            prev = floor.get(k)
            floor[k] = d if prev is None else 0.7 * prev + 0.3 * d
        while len(floor) > spec.max_keys:
            floor.pop(next(iter(floor)))

    # palint: holds=_lock
    def _judge(self, g: _Group, counts: dict[int, int], cm_table,
               total: int, t1_ns: int) -> None:
        spec = self.spec
        base = g.baseline
        base_rate_total = base.total / base.rollups
        # Propagated two-sided sketch bound for keys either side only
        # estimates (ops/sketch.cm_sub contract).
        err_bound = spec.cm.epsilon * (total + base_rate_total)
        diff_cm = cm_sub(cm_table, base.cm / base.rollups)
        cand = set(_top_keys(counts, spec.max_verdicts_per_rollup * 4))
        cand.update(_top_keys(base.counts,
                              spec.max_verdicts_per_rollup * 4))
        found = []
        for k in cand:
            cur = counts.get(k)
            cur_exact = cur is not None
            if cur is None:
                cur = 0 if total == 0 else max(0, int(cm_query(
                    cm_table, np.asarray([k >> 32], np.uint32),
                    spec.cm)[0]))
            base_rate = base.rate(k)
            base_exact = k in base.counts or base.total == 0
            delta = cur - base_rate
            # The learned floor can dip below a Poisson stream's true
            # variance on an unlucky EWMA run; sqrt(base) is the
            # physical lower bound for counting noise, so it backstops
            # the learned value. The sketch bound then ADDS to the
            # noise gate rather than competing with it — a shift must
            # clear both stacked, which is what holds 30+ clean Poisson
            # windows at zero verdicts while a 2x shift (delta ~= base)
            # still clears in one rollup.
            floor = max(g.floor.get(k, 0.0),
                        math.sqrt(max(base_rate, 1.0)))
            threshold = err_bound + max(spec.k_sigma * floor,
                                        float(spec.min_count))
            kind = None
            if delta > threshold and cur >= base_rate * spec.min_ratio:
                kind = ("new_hotspot"
                        if base_rate <= max(err_bound, 1.0) else "regressed")
            elif -delta > threshold and cur <= base_rate / spec.min_ratio:
                kind = "improved"
            if kind is None:
                g.active.pop(k, None)  # shift subsided: latch clears
                continue
            held = g.active.get(k)
            if held is not None and held[0] == kind \
                    and g.rollups_sealed - held[1] < spec.repeat_every:
                self.stats["verdicts_suppressed"] += 1
                continue
            g.active[k] = (kind, g.rollups_sealed)
            found.append({
                "kind": kind,
                "stack": f"0x{k:016x}",
                "current": int(cur),
                "baseline": round(base_rate, 2),
                "delta": round(delta, 2),
                "threshold": round(threshold, 2),
                "noise_floor": round(floor, 2),
                "error_bound": round(err_bound, 2),
                "exact": bool(cur_exact and base_exact),
            })
        found.sort(key=lambda v: abs(v["delta"]), reverse=True)
        if len(found) > spec.max_verdicts_per_rollup:
            self.stats["verdicts_suppressed"] += \
                len(found) - spec.max_verdicts_per_rollup
            found = found[: spec.max_verdicts_per_rollup]
        for v in found:
            self._emit(g, t1_ns, v)
        self._judge_drift(g, counts, total, t1_ns, diff_cm)

    # palint: holds=_lock
    def _judge_drift(self, g: _Group, counts: dict[int, int], total: int,
                     t1_ns: int, diff_cm) -> None:
        """Distribution-level drift: normalized L1 distance between the
        rollup's and the baseline's per-key mass over the tracked keys.
        EWMA-smoothed and edge-triggered — one ``drifted`` verdict (and
        one staleness mark) per excursion, re-armed only after the score
        falls back below half the threshold."""
        spec = self.spec
        base = g.baseline
        if total == 0 and base.total == 0:
            d = 0.0
        elif total == 0 or base.total == 0:
            d = 1.0
        else:
            keys = set(counts) | set(base.counts)
            d = 0.5 * sum(
                abs(counts.get(k, 0) / total
                    - base.counts.get(k, 0) / base.total)
                for k in keys)
        g.drift = 0.7 * g.drift + 0.3 * min(d, 1.0)
        if g.drift > spec.drift_threshold and not g.stale_marked:
            g.stale_marked = True
            self._emit(g, t1_ns, {
                "kind": "drifted",
                "stack": None,
                "current": int(total),
                "baseline": round(base.total / base.rollups, 2),
                "delta": None,
                "threshold": spec.drift_threshold,
                "noise_floor": None,
                "error_bound": round(float(np.abs(diff_cm).max()), 2),
                "exact": False,
                "drift": round(g.drift, 4),
            })
            if self._mark_stale is not None and not g.synthetic:
                # The hook is a DISK write (autofdo .stale marker):
                # queued here and flushed by fold_from_prepared after
                # the lock drops, so a hung filesystem can never freeze
                # /metrics //healthz //diff behind this lock.
                self._stale_pending.append(g.build)
        elif g.stale_marked and g.drift < spec.drift_threshold / 2:
            g.stale_marked = False

    # palint: holds=_lock
    def _emit(self, g: _Group, t1_ns: int, verdict: dict) -> None:
        rec = {
            "t_s": round(t1_ns / 1e9, 3),
            "tenant": g.tenant,
            "build": g.build,
            "baseline_id": g.baseline.ident if g.baseline else None,
            **verdict,
        }
        self._verdict_counts[rec["kind"]] += 1
        self._verdicts.append(rec)
        if len(self._alerts) == self._alerts.maxlen:
            self.stats["alerts_dropped"] += 1
        self._alerts.append(rec)

    def _flush_stale_marks(self) -> None:
        """Run the queued AutoFDO staleness marks OUTSIDE the lock (the
        hook writes a marker file; a hung disk must stall only this
        worker's judgment, never an HTTP scrape). Worker thread only."""
        with self._lock:
            pending, self._stale_pending = self._stale_pending, []
        for build in pending:
            try:
                self._mark_stale(build)
                with self._lock:
                    self.stats["stale_marks"] += 1
            except Exception as e:  # noqa: BLE001 - hook is best-effort
                with self._lock:
                    self.stats["stale_mark_errors"] += 1
                _log.warn("autofdo staleness mark failed",
                          build=build, error=repr(e))

    # -- alert drain (sinks/alerts.py) ---------------------------------------

    def drain_alerts(self) -> list[dict]:
        """Pop every pending verdict record for the alerts sink (bounded
        by the ring; a sink outage costs the oldest alerts, counted)."""
        with self._lock:
            out = list(self._alerts)
            self._alerts.clear()
        return out

    def requeue_alerts(self, records: list[dict]) -> None:
        """Put drained-but-unwritten records back at the FRONT of the
        ring (the alerts sink's append failed): they retry at the next
        window's drain, oldest-first order preserved. Past the ring
        bound the oldest are dropped, counted — a long disk outage
        costs the oldest alerts, never the newest."""
        with self._lock:
            room = self._alerts.maxlen - len(self._alerts)
            if len(records) > room:
                self.stats["alerts_dropped"] += len(records) - room
                records = records[len(records) - room:]
            self._alerts.extendleft(reversed(records))

    # -- query path (HTTP threads) -------------------------------------------

    def count_query_error(self) -> None:
        """Bad-parameter accounting for /diff handler threads (the
        hotspot store's count_query_error twin)."""
        with self._lock:
            self.stats["query_errors"] += 1

    def verdicts(self, tenant: str | None = None, build: str | None = None,
                 kind: str | None = None, since_s: float | None = None,
                 limit: int = 100) -> dict:
        """Recent verdicts (newest first) plus per-group judgment state."""
        if kind is not None and kind not in VERDICT_KINDS:
            raise ValueError(f"kind must be one of {VERDICT_KINDS}")
        limit = max(1, min(int(limit), self.spec.verdict_ring))
        with self._lock:
            self.stats["queries"] += 1
            out = []
            for rec in reversed(self._verdicts):
                if tenant is not None and rec["tenant"] != tenant:
                    continue
                if build is not None and rec["build"] != build:
                    continue
                if kind is not None and rec["kind"] != kind:
                    continue
                if since_s is not None and rec["t_s"] < since_s:
                    continue
                out.append(rec)
                if len(out) >= limit:
                    break
            groups = [{
                "build": g.build,
                "tenant": g.tenant,
                "baseline_id": g.baseline.ident if g.baseline else None,
                "baseline_rollups": g.baseline.rollups if g.baseline else 0,
                "baseline_total": g.baseline.total if g.baseline else 0,
                "rollups_sealed": g.rollups_sealed,
                "tracked_keys": len(g.open_counts),
                "last_total": g.last_total,
                "drift": round(g.drift, 4),
                "stale_marked": g.stale_marked,
            } for g in self._groups.values()
                if tenant is None or g.tenant == tenant]
            counts = dict(self._verdict_counts)
        return {"verdicts": out, "groups": groups,
                "verdict_counts": counts,
                "interval_s": self.spec.interval_s}

    def diff_ranges(self, store, a0_s: float, a1_s: float, b0_s: float,
                    b1_s: float, k: int | None = None,
                    selector: dict | None = None,
                    scope: str = "local") -> dict:
        """On-demand diff of two time ranges over the hotspot store's
        rollup hierarchy (range A minus range B), every entry carrying
        exact/estimate bounds: ``delta`` is the candidate-exact
        difference, ``delta_min``/``delta_max`` bracket the true shift
        using each side's count-min estimate and cut (the upper bound on
        any key absent from a candidate table)."""
        qa = store.query(k=k, t0_s=a0_s, t1_s=a1_s, selector=selector,
                         scope=scope)
        qb = store.query(k=k, t0_s=b0_s, t1_s=b1_s, selector=selector,
                         scope=scope)
        ea = {e["stack"]: e for e in qa["entries"]}
        eb = {e["stack"]: e for e in qb["entries"]}
        entries = []
        for stack in set(ea) | set(eb):
            a, b = ea.get(stack), eb.get(stack)
            count_a = a["count"] if a else 0
            est_a = a["estimate"] if a else qa["cut"]
            count_b = b["count"] if b else 0
            est_b = b["estimate"] if b else qb["cut"]
            src = a or b
            entries.append({
                "stack": stack,
                "count_a": count_a, "estimate_a": est_a,
                "count_b": count_b, "estimate_b": est_b,
                "delta": count_a - count_b,
                "delta_min": count_a - est_b,
                "delta_max": est_a - count_b,
                "exact": bool(qa["exact"] and qb["exact"]),
                "frames": src.get("frames"),
                "labels": src.get("labels"),
            })
        entries.sort(key=lambda e: abs(e["delta"]), reverse=True)
        with self._lock:
            self.stats["queries"] += 1
        return {
            "mode": "range",
            "scope": scope,
            "exact": bool(qa["exact"] and qb["exact"]),
            "a": {kk: qa[kk] for kk in ("t0_s", "t1_s", "total_samples",
                                        "windows", "level", "cut",
                                        "stale")},
            "b": {kk: qb[kk] for kk in ("t0_s", "t1_s", "total_samples",
                                        "windows", "level", "cut",
                                        "stale")},
            "entries": entries,
        }

    # -- crash-only persistence (regression.baseline site) -------------------

    def save(self) -> bool:
        """Persist every frozen baseline via tmp+rename (the
        statics_store discipline: whole file or no file, every record
        CRC-framed and digest-checked at adoption). Runs on the encode
        worker after seals; fail-open — a failed save is counted and the
        next seal retries."""
        try:
            faults.inject("regression.baseline")
            with self._lock:
                body = bytearray(_MAGIC)
                self._frame(body, json.dumps({
                    "version": 1,
                    "created_at_unix": self._clock(),
                    "interval_s": self.spec.interval_s,
                    "cm_depth": self.spec.cm.depth,
                    "cm_width": self.spec.cm.width,
                }).encode())
                n = 0
                for g in self._groups.values():
                    if g.baseline is None:
                        continue
                    self._frame(body, self._pack_baseline(g))
                    n += 1
            atomic_write_bytes(self.path, bytes(body))
            # Reset the dirty counter only AFTER the write landed: a
            # failed write must retry at the very next seal, not after
            # another save_every of exposure.
            self._seals_unsaved = 0
            with self._lock:
                self.stats["baseline_saves"] += 1
            _log.debug("regression baselines saved", baselines=n)
            return True
        except Exception as e:  # noqa: BLE001 - persistence is best-effort
            with self._lock:
                self.stats["baseline_save_errors"] += 1
            _log.warn("regression baseline save failed; retrying at the "
                      "next seal", error=repr(e))
            return False

    @staticmethod
    def _frame(body: bytearray, payload: bytes) -> None:
        import zlib

        body.extend(_FMARK)
        body.extend(_FRAME.pack(len(payload), zlib.crc32(payload)))
        body.extend(payload)

    @staticmethod
    def _pack_baseline(g: _Group) -> bytes:
        base = g.baseline
        keys = np.fromiter(base.counts.keys(), np.uint64,
                           len(base.counts))
        counts = np.fromiter(base.counts.values(), np.int64,
                             len(base.counts))
        meta = json.dumps({
            "build": g.build, "tenant": g.tenant, "n": len(base.counts),
            "total": base.total, "rollups": base.rollups,
            "created_ns": base.created_ns, "ident": base.ident,
        }).encode()
        return b"".join((_U32.pack(len(meta)), meta, keys.tobytes(),
                         counts.tobytes(),
                         np.ascontiguousarray(base.cm).tobytes()))

    # palint: holds=_lock — called from __init__ only, before the
    # object is shared with any other thread (the same construction
    # exemption the checker grants __init__ itself).
    def _adopt(self) -> None:
        """Adopt the previous run's frozen baselines at startup (from
        __init__, before the sentinel is shared with any thread). Per
        record crash-only: a corrupt frame, undecodable record, spec
        mismatch, or content-digest mismatch is counted and skipped —
        that group just relearns its baseline cold."""
        import zlib

        try:
            faults.inject("regression.baseline")
            with open(self.path, "rb") as f:
                data = f.read(64 << 20)
        except OSError:
            return
        except Exception as e:  # noqa: BLE001 - injected chaos included
            self.stats["baseline_adopt_errors"] += 1
            _log.warn("regression baseline adoption failed; cold start",
                      error=repr(e))
            return
        if not data.startswith(_MAGIC):
            self.stats["baseline_adopt_errors"] += 1
            return
        off = len(_MAGIC)
        head_len = len(_FMARK) + _FRAME.size
        frames = []
        while 0 <= off < len(data):
            if data[off: off + len(_FMARK)] != _FMARK \
                    or off + head_len > len(data):
                self.stats["baseline_adopt_errors"] += 1
                nxt = data.find(_FMARK, off + 1)
                if nxt < 0:
                    break
                off = nxt
                continue
            length, crc = _FRAME.unpack_from(data, off + len(_FMARK))
            start = off + head_len
            payload = data[start: start + length]
            if len(payload) != length or zlib.crc32(payload) != crc:
                self.stats["baseline_adopt_errors"] += 1
                nxt = data.find(_FMARK, off + 1)
                if nxt < 0:
                    break
                off = nxt
                continue
            frames.append(payload)
            off = start + length
        if not frames:
            return
        try:
            header = json.loads(frames[0])
            if header.get("cm_depth") != self.spec.cm.depth \
                    or header.get("cm_width") != self.spec.cm.width \
                    or float(header.get("interval_s", 0)) \
                    != self.spec.interval_s:
                # Spec changed across the restart: rates and sketch
                # shapes are incomparable; relearn everything.
                self.stats["baseline_adopt_errors"] += 1
                return
        except (ValueError, TypeError):
            self.stats["baseline_adopt_errors"] += 1
            return
        for payload in frames[1:]:
            try:
                self._adopt_record(payload)
            except (ValueError, KeyError, struct.error,
                    UnicodeDecodeError):
                self.stats["baseline_adopt_errors"] += 1
        _log.info("regression baselines adopted",
                  adopted=self.stats["baselines_adopted"],
                  errors=self.stats["baseline_adopt_errors"])

    # palint: holds=_lock
    def _adopt_record(self, payload: bytes) -> None:
        spec = self.spec
        (meta_len,) = _U32.unpack_from(payload, 0)
        off = _U32.size
        meta = json.loads(payload[off: off + meta_len])
        off += meta_len
        n = int(meta["n"])
        cm_bytes = spec.cm.depth * spec.cm.width * 8
        want = off + 16 * n + cm_bytes
        if want != len(payload):
            raise ValueError("baseline record length mismatch")
        keys = np.frombuffer(payload, np.uint64, n, off)
        counts = np.frombuffer(payload, np.int64, n, off + 8 * n)
        cm_table = np.frombuffer(
            payload, np.int64, spec.cm.depth * spec.cm.width,
            off + 16 * n).reshape(spec.cm.depth, spec.cm.width).copy()
        base = _Baseline(
            dict(zip(keys.tolist(), counts.tolist())), cm_table,
            int(meta["total"]), int(meta["rollups"]),
            int(meta["created_ns"]))
        if base.ident != meta.get("ident"):
            # Content-addressing is the adoption gate: a record that
            # frames correctly but decodes to different content (or was
            # written by different code) must not seed judgment.
            raise ValueError("baseline content digest mismatch")
        key = (str(meta["build"]), str(meta["tenant"]))
        if key in self._groups or len(self._groups) >= spec.max_groups:
            raise ValueError("baseline group conflict")
        g = _Group(key[0], key[1], spec)
        g.baseline = base
        self._groups[key] = g
        self.stats["baselines_adopted"] += 1

    # -- observability -------------------------------------------------------

    def metrics(self) -> dict:
        """Flat gauges for /metrics (web.py renders the
        parca_agent_regression_* families)."""
        with self._lock:
            out = dict(self.stats)
            out["groups"] = len(self._groups)
            out["baselines"] = sum(
                1 for g in self._groups.values() if g.baseline is not None)
            out["alerts_pending"] = len(self._alerts)
            out["drift_max"] = round(max(
                (g.drift for g in self._groups.values()), default=0.0), 4)
            out["verdicts"] = dict(self._verdict_counts)
        return out

    def snapshot(self) -> dict:
        """/healthz section. Informational only by contract: verdicts,
        drift, or persistence trouble degrade JUDGMENT, never readiness
        — this section can never turn the agent red."""
        m = self.metrics()
        return {
            "windows_folded": m["windows_folded"],
            "fold_errors": m["fold_errors"],
            "rollups_sealed": m["rollups_sealed"],
            "groups": m["groups"],
            "baselines": m["baselines"],
            "verdicts": m["verdicts"],
            "drift_max": m["drift_max"],
            "stale_marks": m["stale_marks"],
            "baseline_saves": m["baseline_saves"],
            "baseline_save_errors": m["baseline_save_errors"],
            "alerts_pending": m["alerts_pending"],
        }
