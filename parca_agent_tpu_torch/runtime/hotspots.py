"""Fleet-global hotspot rollups: mergeable window summaries + top-K query.

The first READ path in the agent. Every other subsystem moves profiles
toward the store; this one answers questions locally: "the top-K hottest
stacks matching this label selector, over this time range, node-local or
fleet-wide" — served at dashboard rates out of pre-merged rollups, never
by touching the capture/close hot path (Atys, PAPERS.md arxiv 2506.15523:
hotspot identification across a large fleet needs hierarchical
aggregation of compact summaries, not raw profile shipping).

The unit is a :class:`WindowSummary`: a count-min sketch over the whole
window's (stack-hash, count) stream (ops/sketch.py — the `ab_sketch`
bench phase holds its error envelope at mean rel. err ~0.002) plus an
exact top-candidates table keyed by the 64-bit content hash
(h1 << 32 | h2, the same identity the fleet merge dedups on), each entry
carrying enough frame/label context to render a human-readable answer.
Summaries are MERGEABLE: count-min merges elementwise (+), candidate
tables merge by key with count addition and prune back to the candidate
bound. That makes the whole hierarchy one operation applied at different
granularities:

  per-window  ->  1-minute buckets  ->  1-hour buckets      (node-local)
  fleet round ->  1-minute buckets  ->  1-hour buckets      (fleet scope)

Each level is a byte-capped ring with oldest-eviction, so an always-on
agent answers multi-hour queries in bounded memory.

Where the work runs: :meth:`HotspotStore.fold_from_aggregator` is called
by the encode pipeline's WORKER thread after each shipped window (the
same clock and thread as the statics snapshot hook) — the capture/close
thread contributes zero cycles. Queries run on HTTP server threads
against sealed summaries under one lock.

Accuracy contract (docs/hotspots.md): candidate-table counts are EXACT
for mass observed while the stack was inside the candidate bound; a
summary's ``cut`` is an upper bound on the count any stack absent from
its table can have, so an answer is exact when cut == 0 and otherwise a
lower bound with the count-min estimate as the matching upper bound.

Fleet scope rides the timeout-bounded, degrade-safe FleetWindowMerger
collectives (parallel/distributed.py): every successful merge round
hands the fleet-deduped (h1, h2, count) stream to
:meth:`fleet_fold`; on CollectiveTimeout the merger notifies
:meth:`fleet_degraded` and queries serve node-local answers flagged
stale — the window loop never blocks on a hung peer.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from parca_agent_tpu_torch.ops.sketch import CountMinSpec, cm_add, cm_query
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("hotspots")

# Entry slots: [count, pid, frames, labels] (a list so merges mutate the
# count in place; context slots are frozen at first sight of the key).
_COUNT, _PID, _FRAMES, _LABELS = range(4)


@dataclasses.dataclass(frozen=True)
class HotspotSpec:
    """Sizing of one summary: K answers served, candidate entries kept
    (the exactness headroom above K), the count-min backstop, and how
    many frames of context each candidate carries."""

    k: int = 50
    candidates: int = 512
    cm: CountMinSpec = CountMinSpec(depth=4, width=1 << 12)
    frames: int = 8

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.candidates < self.k:
            raise ValueError("candidates must be >= k")


class WindowSummary:
    """One mergeable hotspot summary (a window, a rollup bucket, or a
    fleet round)."""

    __slots__ = ("t0_ns", "t1_ns", "total", "windows", "nodes", "cm",
                 "entries", "cut")

    def __init__(self, spec: HotspotSpec, t0_ns: int = 0, t1_ns: int = 0):
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.total = 0
        self.windows = 0
        self.nodes = 1
        self.cm = np.zeros((spec.cm.depth, spec.cm.width), np.int64)
        self.entries: dict[int, list] = {}
        self.cut = 0

    @classmethod
    def build(cls, h1, h2, counts, ctx_for, spec: HotspotSpec,
              time_ns: int, duration_ns: int, nodes: int = 1
              ) -> "WindowSummary":
        """Summarize one (hash, count) stream. ``ctx_for(i)`` returns
        (pid, frames, labels) for stream row i — called only for the
        candidate rows, so context rendering is bounded by the spec, not
        the stream."""
        h1 = np.asarray(h1, np.uint32)
        h2 = np.asarray(h2, np.uint32)
        counts = np.asarray(counts, np.int64)
        s = cls(spec, t0_ns=int(time_ns), t1_ns=int(time_ns + duration_ns))
        s.total = int(counts.sum())
        s.windows = 1
        s.nodes = nodes
        cm_add(s.cm, h1, counts, spec.cm)
        n = len(counts)
        if n > spec.candidates:
            part = np.argpartition(counts, n - spec.candidates)
            keep = part[n - spec.candidates:]
            s.cut = int(counts[part[: n - spec.candidates]].max(initial=0))
        else:
            keep = np.arange(n)
        key64 = ((h1[keep].astype(np.uint64) << np.uint64(32))
                 | h2[keep].astype(np.uint64))
        for j, i in enumerate(keep.tolist()):
            k = int(key64[j])
            e = s.entries.get(k)
            if e is None:
                pid, frames, labels = ctx_for(i)
                s.entries[k] = [int(counts[i]), pid, frames, labels]
            else:
                # 64-bit hash collision inside one stream: merge, the
                # same way the exact fleet merge would.
                e[_COUNT] += int(counts[i])
        return s

    def merge_in(self, other: "WindowSummary",
                 spec: HotspotSpec) -> None:
        """Fold ``other`` into this summary (linear: associative and
        commutative up to candidate pruning)."""
        if self.windows == 0:
            self.t0_ns, self.t1_ns = other.t0_ns, other.t1_ns
        else:
            self.t0_ns = min(self.t0_ns, other.t0_ns)
            self.t1_ns = max(self.t1_ns, other.t1_ns)
        self.cm += other.cm
        self.total += other.total
        self.windows += other.windows
        self.nodes = max(self.nodes, other.nodes)
        self.cut += other.cut
        mine = self.entries
        for k, e in other.entries.items():
            got = mine.get(k)
            if got is None:
                mine[k] = list(e)
            else:
                got[_COUNT] += e[_COUNT]
                if got[_FRAMES] is None and e[_FRAMES] is not None:
                    got[_PID], got[_FRAMES], got[_LABELS] = e[1:]
        if len(mine) > spec.candidates:
            drop = sorted(mine.items(), key=lambda kv: kv[1][_COUNT])
            dropped_max = 0
            for k, e in drop[: len(mine) - spec.candidates]:
                dropped_max = max(dropped_max, e[_COUNT])
                del mine[k]
            # A dropped key's true mass <= its merged count plus what the
            # children's own cuts already hid from it.
            self.cut += dropped_max

    def nbytes(self) -> int:
        """Footprint estimate for the byte-capped rings: the sketch is
        exact; entries are approximated per slot (key + count + context
        strings)."""
        n = self.cm.nbytes
        for e in self.entries.values():
            n += 80
            if e[_FRAMES]:
                n += sum(len(f) for f in e[_FRAMES])
            if e[_LABELS]:
                n += sum(len(k) + len(v) for k, v in e[_LABELS].items())
        return n

    def overlaps(self, t0_ns: int, t1_ns: int) -> bool:
        return self.t1_ns > t0_ns and self.t0_ns < t1_ns


class _Level:
    """One rollup granularity: an open accumulating bucket (span-aligned)
    plus a byte-capped ring of sealed summaries, oldest evicted first.
    span_s None = the per-window level (no bucketing: every fold seals
    immediately)."""

    def __init__(self, name: str, span_s: float | None, max_bytes: int,
                 spec: HotspotSpec):
        self.name = name
        self.span_s = span_s
        self.max_bytes = max_bytes
        self._spec = spec
        self.ring: collections.deque[tuple[WindowSummary, int]] \
            = collections.deque()
        self.bytes = 0
        self.evictions = 0
        self.open: WindowSummary | None = None
        self._open_until_ns = 0

    def _append(self, s: WindowSummary) -> None:
        nb = s.nbytes()
        self.ring.append((s, nb))
        self.bytes += nb
        while self.bytes > self.max_bytes and len(self.ring) > 1:
            _, old_nb = self.ring.popleft()
            self.bytes -= old_nb
            self.evictions += 1

    def add(self, s: WindowSummary) -> WindowSummary | None:
        """Fold one summary in; returns a SEALED bucket when this fold
        closed one (the caller promotes it to the next level)."""
        if self.span_s is None:
            self._append(s)
            return s
        span_ns = int(self.span_s * 1e9)
        sealed = None
        if self.open is not None and s.t0_ns >= self._open_until_ns:
            sealed = self.open
            self._append(sealed)
            self.open = None
        if self.open is None:
            self.open = WindowSummary(self._spec)
            self._open_until_ns = (s.t0_ns // span_ns + 1) * span_ns
        self.open.merge_in(s, self._spec)
        return sealed

    def overlapping(self, t0_ns: int, t1_ns: int) -> list[WindowSummary]:
        out = [s for s, _ in self.ring if s.overlaps(t0_ns, t1_ns)]
        if self.open is not None and self.open.windows \
                and self.open.overlaps(t0_ns, t1_ns):
            out.append(self.open)
        return out

    def span(self) -> tuple[int, int] | None:
        """(t0_ns, t1_ns) of the data this level still holds."""
        lo = hi = None
        if self.ring:
            lo, hi = self.ring[0][0].t0_ns, self.ring[-1][0].t1_ns
        if self.open is not None and self.open.windows:
            lo = self.open.t0_ns if lo is None else min(lo, self.open.t0_ns)
            hi = self.open.t1_ns if hi is None else max(hi, self.open.t1_ns)
        return None if lo is None else (lo, hi)


class RegistryView:
    """Rotation-consistent snapshot of the per-id mirrors a fold reads
    (`_loc_off`/`_loc_flat`/`_id_pid`/`_id_h1`/`_id_h2`/`_pids`),
    captured on the PROFILER thread at window hand-off — the same thread
    that runs cold-stack rotation, so capture and rotation can never
    interleave. Rotation REPLACES these arrays with compacted copies
    (it never mutates the old ones in place), so references captured
    before the next window's first feed stay internally consistent for
    the whole fold, no matter when the encode worker gets to it;
    in-place appends only ever land beyond the published watermark the
    prepared ids were read under. Duck-types the aggregator surface
    ``fold_from_aggregator`` and ``render_frames`` consume."""

    __slots__ = ("_loc_off", "_loc_flat", "_id_pid", "_id_h1", "_id_h2",
                 "_pids", "registry_epoch", "_published")

    def __init__(self, agg):
        self._loc_off = agg._loc_off
        self._loc_flat = agg._loc_flat
        self._id_pid = agg._id_pid
        self._id_h1 = agg._id_h1
        self._id_h2 = agg._id_h2
        self._pids = agg._pids
        self.registry_epoch = getattr(agg, "registry_epoch", 0)
        self._published = getattr(agg, "_published", 0)

    def id_hashes(self, n: int | None = None):
        if n is None:
            n = self._published
        return self._id_h1[:n], self._id_h2[:n]


def render_frames(agg, sid: int, max_frames: int) -> tuple:
    """Human-readable frame context for one stack id, straight from the
    aggregator's per-pid location registry (append-only; reads are safe
    for ids below the published watermark — the window encoder's
    concurrent-reader contract). Frames render as mapping+offset (the
    agent ships unsymbolized, like the reference — function names are
    the server's job; mapping-relative addresses are what its symbolizer
    consumes and what a human can at least attribute to a binary)."""
    lo = int(agg._loc_off[sid])
    hi = int(agg._loc_off[sid + 1])
    loc_ids = agg._loc_flat[lo:hi][:max_frames]
    pid = int(agg._id_pid[sid])
    reg = agg._pids.get(pid)
    frames = []
    for lid in loc_ids.tolist():
        i = int(lid) - 1
        if reg is None or not (0 <= i < len(reg.loc_address)):
            frames.append("?")
            continue
        addr = int(reg.loc_address[i])
        if reg.loc_is_kernel[i]:
            frames.append(f"[kernel] 0x{addr:x}")
            continue
        mid = int(reg.loc_mapping_id[i])
        if 1 <= mid <= len(reg.mappings):
            m = reg.mappings[mid - 1]
            name = m.path or m.build_id or "?"
            frames.append(f"{name}+0x{int(reg.loc_normalized[i]):x}")
        else:
            frames.append(f"0x{addr:x}")
    return tuple(frames)


class HotspotStore:
    """Bounded-memory hierarchical hotspot rollups + the query engine.

    Thread model: fold_from_aggregator runs on the encode pipeline's
    worker; fleet_fold/fleet_degraded on the fleet merge actor; query/
    metrics/snapshot on HTTP threads. One lock guards the level rings
    and counters; summary CONSTRUCTION (sketch build, frame rendering)
    runs outside it.
    """

    def __init__(self, spec: HotspotSpec = HotspotSpec(),
                 window_s: float = 10.0,
                 rollup_spans_s: tuple = (60.0, 3600.0),
                 level_bytes: int = 32 << 20,
                 stale_after_s: float = 60.0,
                 labels_for=None,
                 context_cap: int = 8192,
                 clock=time.monotonic):
        self.spec = spec
        self.window_s = window_s
        self.stale_after_s = stale_after_s
        # Label resolution for candidate entries; the profiler installs
        # its (lock-guarded) labels manager hook. None = pid-only labels.
        self.labels_for = labels_for
        self._clock = clock
        self._lock = threading.Lock()
        for s in rollup_spans_s:
            # A zero span would ZeroDivisionError every bucket
            # alignment on the encode worker — fail at construction,
            # not per-fold.
            if not (float(s) > 0):
                raise ValueError(f"rollup span must be > 0, got {s!r}")
        names = ["window"] + [_span_name(s) for s in rollup_spans_s]
        spans = [None] + [float(s) for s in rollup_spans_s]
        self._levels = [_Level(n, s, level_bytes, spec)
                        for n, s in zip(names, spans)]
        self._fleet_levels = [_Level(n, s, level_bytes, spec)
                              for n, s in zip(names, spans)]
        # key64 -> (pid, frames, labels): locally-learned context joined
        # onto fleet-merged rows (hashes are all that crosses the wire —
        # Atys-style compact summaries). Bounded LRU.
        self._context: collections.OrderedDict = collections.OrderedDict()
        self._context_cap = context_cap
        # Per-sid rendered frames, valid for one registry epoch.
        self._frames_cache: dict[int, tuple] = {}
        self._frames_epoch = -1
        self.fleet_interval_s: float = window_s
        self._fleet_last_at: float | None = None
        self._fleet_degraded = False
        self.last_fleet_error = ""
        self.stats = {  # guarded-by: _lock
            "windows_folded": 0,
            "fold_errors": 0,
            "last_fold_s": 0.0,
            "fleet_rounds_ok": 0,
            "fleet_rounds_degraded": 0,
            "queries_total": 0,
            "query_errors": 0,
            "context_entries": 0,
        }

    # -- fold paths (worker / fleet-actor threads) ---------------------------

    def fold_from_aggregator(self, agg, idx, vals, time_ns: int,
                             duration_ns: int) -> None:
        """Summarize one shipped window straight from the aggregator's
        published per-id mirrors and fold it into the node-local rollups.
        Encode-pipeline worker thread only (the statics-snapshot hook's
        twin) — and off the profiler thread ``agg`` must be a
        :class:`RegistryView` captured at hand-off, never the live
        aggregator: a cold-stack rotation at the next window's first
        feed compacts the live mirrors under the fold. Errors are
        counted here (``fold_errors``, the exported contract) and
        re-raised for the pipeline to contain — a rollup bug can never
        lose a window."""
        try:
            self._fold_from(agg, idx, vals, time_ns, duration_ns)
        except Exception:
            # Under the lock (palint lock-discipline): the HTTP thread's
            # count_query_error and the fleet actor's degrade counter
            # mutate the same dict concurrently.
            with self._lock:
                self.stats["fold_errors"] += 1
            raise

    def _fold_from(self, agg, idx, vals, time_ns: int,
                   duration_ns: int) -> None:
        t0 = time.perf_counter()
        faults.inject("hotspot.fold")
        epoch = getattr(agg, "registry_epoch", 0)
        if epoch != self._frames_epoch:
            # Rotation remapped the id space: every cached render is
            # keyed by a dead sid.
            self._frames_cache.clear()
            self._frames_epoch = epoch
        idx = np.asarray(idx)
        h1, h2 = agg.id_hashes(int(idx.max()) + 1 if len(idx) else 0)
        label_memo: dict[int, dict | None] = {}

        def ctx_for(i: int):
            sid = int(idx[i])
            frames = self._frames_cache.get(sid)
            if frames is None:
                frames = render_frames(agg, sid, self.spec.frames)
                if len(self._frames_cache) < 4 * self.spec.candidates * 8:
                    self._frames_cache[sid] = frames
            pid = int(agg._id_pid[sid])
            if pid in label_memo:
                labels = label_memo[pid]
            else:
                labels = ({"pid": str(pid)} if self.labels_for is None
                          else self.labels_for(pid))
                label_memo[pid] = labels
            return pid, frames, labels

        s = WindowSummary.build(
            h1[idx], h2[idx], np.asarray(vals, np.int64), ctx_for,
            self.spec, time_ns, duration_ns)
        self.fold(s)
        with self._lock:
            self.stats["last_fold_s"] = time.perf_counter() - t0

    def fold(self, s: WindowSummary) -> None:
        """Fold one node-local window summary into the level hierarchy
        (public so the bench can drive synthetic streams)."""
        with self._lock:
            for k, e in s.entries.items():
                if e[_FRAMES] is not None:
                    self._context[k] = (e[_PID], e[_FRAMES], e[_LABELS])
                    self._context.move_to_end(k)
            while len(self._context) > self._context_cap:
                self._context.popitem(last=False)
            self.stats["context_entries"] = len(self._context)
            self._fold_levels(self._levels, s)
            self.stats["windows_folded"] += 1

    @staticmethod
    def _fold_levels(levels: list[_Level], s: WindowSummary) -> None:
        promote = s
        for lvl in levels:
            sealed = lvl.add(promote)
            if sealed is None:
                break
            promote = sealed

    def fleet_fold(self, h1, h2, counts, time_ns: int | None = None
                   ) -> None:
        """Ingest one successful fleet merge round's deduplicated
        (h1, h2, count) stream (FleetWindowMerger's collective output).
        Context joins back from locally-learned entries; stacks only
        other nodes have seen render as opaque hashes — the wire carries
        sketches and hashes, never frame payloads."""
        counts = np.asarray(counts, np.int64)
        if time_ns is None:
            time_ns = time.time_ns() - int(self.fleet_interval_s * 1e9)
        h1 = np.asarray(h1, np.uint32)
        h2 = np.asarray(h2, np.uint32)
        key64 = ((h1.astype(np.uint64) << np.uint64(32))
                 | h2.astype(np.uint64))

        def ctx_for(i: int):
            k = int(key64[i])
            with self._lock:  # the fold thread mutates the LRU
                got = self._context.get(k)
            if got is not None:
                return got
            return None, (f"stack:0x{k:016x}",), None

        s = WindowSummary.build(
            h1, h2, counts, ctx_for, self.spec, time_ns,
            # Floor the span: a zero-duration summary could never
            # overlap any range (sub-second merge cadences exist only
            # in tests, but the invariant is cheap to keep).
            max(int(self.fleet_interval_s * 1e9), 1))
        with self._lock:
            self._fold_levels(self._fleet_levels, s)
            self.stats["fleet_rounds_ok"] += 1
            self._fleet_last_at = self._clock()
            self._fleet_degraded = False

    def count_query_error(self) -> None:
        """Bad-parameter accounting for the HTTP layer's handler
        threads — same lock discipline as every other stats counter (a
        bare `stats[...] += 1` across ThreadingHTTPServer threads would
        lose increments)."""
        with self._lock:
            self.stats["query_errors"] += 1

    def fleet_degraded(self, error: str = "") -> None:
        """FleetWindowMerger's degrade notification (CollectiveTimeout
        or any collective failure): fleet answers turn stale-flagged
        node-local until a round completes again."""
        with self._lock:
            self.stats["fleet_rounds_degraded"] += 1
            self._fleet_degraded = True
            self.last_fleet_error = error[:200]

    # -- query path (HTTP threads) -------------------------------------------

    def _fleet_stale(self) -> bool:
        if self._fleet_degraded:
            return True
        if self._fleet_last_at is None:
            return True
        return (self._clock() - self._fleet_last_at
                > max(self.stale_after_s, 2 * self.fleet_interval_s))

    def _pick_levels(self, levels, t0_ns, t1_ns):
        """Granularity choice: the coarsest level whose bucket span fits
        the range at least twice (a dashboard asking for 6 h should read
        ~6 hour-buckets, not 2160 windows), falling COARSER first when
        the chosen ring has evicted the range (older data survives
        longest at the top), then finer."""
        range_s = max((t1_ns - t0_ns) / 1e9, 0.0)
        pick = 0
        for i, lvl in enumerate(levels):
            if lvl.span_s is not None and 2 * lvl.span_s <= range_s:
                pick = i
        order = list(range(pick, len(levels))) + \
            list(range(pick - 1, -1, -1))
        for i in order:
            got = levels[i].overlapping(t0_ns, t1_ns)
            if got:
                return levels[i], got
        return levels[pick], []

    def query(self, k: int | None = None, t0_s: float | None = None,
              t1_s: float | None = None, selector: dict | None = None,
              scope: str = "local") -> dict:
        """Top-K hottest stacks matching ``selector`` over [t0_s, t1_s]
        (unix seconds; None = the stored data's own bounds). Always
        answers: fleet scope with no fleet data degrades to node-local,
        flagged. Counts are candidate-exact lower bounds with the
        count-min estimate alongside (equal when ``exact``)."""
        if scope not in ("local", "fleet"):
            raise ValueError("scope must be 'local' or 'fleet'")
        t0 = time.perf_counter()
        with self._lock:
            self.stats["queries_total"] += 1
            k = self.spec.k if k is None else max(1, min(
                int(k), self.spec.candidates))
            fallback = None
            stale = False
            levels = self._levels
            if scope == "fleet":
                stale = self._fleet_stale()
                has_fleet = any(lv.span() for lv in self._fleet_levels)
                if has_fleet:
                    levels = self._fleet_levels
                else:
                    fallback = "local"
                    stale = True
            # Data bounds default the range.
            spans = [sp for sp in (lv.span() for lv in levels) if sp]
            data_lo = min((sp[0] for sp in spans), default=0)
            data_hi = max((sp[1] for sp in spans), default=0)
            t0_ns = int(t0_s * 1e9) if t0_s is not None else data_lo
            t1_ns = int(t1_s * 1e9) if t1_s is not None else data_hi
            if t1_ns < t0_ns:
                raise ValueError("empty time range (t1 < t0)")
            lvl, sums = self._pick_levels(levels, t0_ns, t1_ns)
            merged = WindowSummary(self.spec)
            sealed = []
            for s in sums:
                # Only the OPEN bucket keeps accumulating under later
                # folds, so only it must merge while locked. Sealed
                # summaries are immutable once ringed (folds build fresh
                # ones; promotion only reads them), and they are the
                # bulk of a long range — merging them after release
                # keeps a query burst from stalling the encode worker's
                # fold into backpressure-dropped rollups.
                if s is lvl.open:
                    merged.merge_in(s, self.spec)
                else:
                    sealed.append(s)
        for s in sealed:
            # Eviction may pop these refs from the ring concurrently;
            # the objects themselves never mutate, so the merge stays
            # consistent with the pick-time snapshot.
            merged.merge_in(s, self.spec)
        # Ranking + rendering outside the lock too: `merged` is private.
        want = dict(selector or {})

        def match(e) -> bool:
            if not want:
                return True
            labels = e[_LABELS]
            if labels is None:
                return False
            return all(labels.get(kk) == vv for kk, vv in want.items())

        ranked = sorted(
            ((key, e) for key, e in merged.entries.items() if match(e)),
            key=lambda kv: kv[1][_COUNT], reverse=True)[:k]
        ests = {}
        if ranked:
            keys = np.array([key for key, _ in ranked], np.uint64)
            h1 = (keys >> np.uint64(32)).astype(np.uint32)
            est = cm_query(merged.cm, h1, self.spec.cm)
            ests = {int(key): int(v) for key, v in zip(keys.tolist(),
                                                       est.tolist())}
        covered = sum(
            max(0, min(s.t1_ns, t1_ns) - max(s.t0_ns, t0_ns))
            for s in sums)
        span = max(t1_ns - t0_ns, 1)
        out = {
            "scope": scope,
            "k": k,
            "level": lvl.name,
            "summaries_merged": len(sums),
            "t0_s": round(t0_ns / 1e9, 3),
            "t1_s": round(t1_ns / 1e9, 3),
            "cover": round(min(1.0, covered / span), 4),
            "total_samples": merged.total,
            "windows": merged.windows,
            "unique_tracked": len(merged.entries),
            "cut": merged.cut,
            "exact": merged.cut == 0,
            "stale": stale,
            "query_s": 0.0,
            "entries": [
                {
                    "stack": f"0x{key:016x}",
                    "count": e[_COUNT],
                    "estimate": max(ests.get(key, e[_COUNT]), e[_COUNT]),
                    "exact": merged.cut == 0,
                    "pid": e[_PID],
                    "frames": list(e[_FRAMES] or ()),
                    "labels": e[_LABELS],
                }
                for key, e in ranked
            ],
        }
        if fallback:
            out["fallback"] = fallback
        if scope == "fleet":
            out["degraded"] = self._fleet_degraded
            if self.last_fleet_error:
                out["fleet_error"] = self.last_fleet_error
        out["query_s"] = round(time.perf_counter() - t0, 6)
        return out

    # -- observability -------------------------------------------------------

    def metrics(self) -> dict:
        """Flat gauges for /metrics (web.py renders the grouped
        families)."""
        with self._lock:
            levels = []
            for scope, lvls in (("local", self._levels),
                                ("fleet", self._fleet_levels)):
                for lv in lvls:
                    levels.append({
                        "name": lv.name, "scope": scope,
                        "summaries": len(lv.ring)
                        + (1 if lv.open is not None and lv.open.windows
                           else 0),
                        "bytes": lv.bytes
                        + (lv.open.nbytes()
                           if lv.open is not None and lv.open.windows
                           else 0),
                        "evictions": lv.evictions,
                    })
            out = {
                "levels": levels,
                "stale": self._fleet_stale(),
                **{k: v for k, v in self.stats.items()},
            }
            if self._fleet_last_at is not None:
                out["fleet_age_s"] = round(
                    self._clock() - self._fleet_last_at, 3)
            return out

    def snapshot(self) -> dict:
        """/healthz section. Informational only by contract: rollup
        state never turns readiness red — a degraded fleet or an evicted
        ring means coarser/staler ANSWERS, not an unhealthy agent."""
        m = self.metrics()
        return {
            "windows_folded": m["windows_folded"],
            "fold_errors": m["fold_errors"],
            "levels": {
                f"{lv['scope']}/{lv['name']}": {
                    "summaries": lv["summaries"],
                    "bytes": lv["bytes"],
                    "evictions": lv["evictions"],
                } for lv in m["levels"]
            },
            "fleet": {
                "rounds_ok": m["fleet_rounds_ok"],
                "rounds_degraded": m["fleet_rounds_degraded"],
                "stale": m["stale"],
                "age_s": m.get("fleet_age_s"),
                "last_error": self.last_fleet_error,
            },
        }


def _span_name(span_s: float) -> str:
    span_s = float(span_s)
    if span_s % 3600 == 0:
        return f"{int(span_s // 3600)}h"
    if span_s % 60 == 0:
        return f"{int(span_s // 60)}m"
    return f"{int(span_s)}s"
