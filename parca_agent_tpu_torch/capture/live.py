"""Live capture over the native perf_event sampler, and the drain-column
helpers.

The port's copy of parca_agent_tpu's capture/live.py. The sampler
(native/sampler.cc, built with g++ at first use and loaded with ctypes)
opens one perf event a CPU with kernel and frame-pointer user call
chains (PERF_SAMPLE_CALLCHAIN). Two capture modes:

  FP mode (default): once a second poll() drains the rings with the
  dedup drain, which folds repeats of a record into a count, and with
  the hash-carrying drain (v1h) stamps each unique record with the
  dictionary's identity triple h1/h2/h3, computed from the tables
  ops/hashing.py hash_params installs (pa_sampler_set_hash), so the
  carried triple equals row_hash_np's bits. Each drain's columns go to
  the ``on_drain`` tee (the streaming feeder) as they land.

  DWARF mode (capture_stack=True): the kernel also snapshots the user
  registers and a slice of the user stack a sample (v2 records,
  decode_records_v2); at drain time unwind_records walks frameless user
  stacks with the batched walker (unwind/walker.py) against .eh_frame
  tables that UnwindTableCache builds off the hot path (a background
  builder, refreshed every 5 s, dead pids evicted). The walker rewrites
  the user chains after the drain, so a drain-time hash would describe
  the wrong rows: this mode drains hashless and calls no ``on_drain``
  tee (the CLI runs it one-shot). It is the one exception to the hash
  carry that FP mode requires.

At the window's end the drains become one counted WindowSnapshot
(columns_to_snapshot, or records_to_snapshot in DWARF mode), joined with
the live /proc mapping table (mapping_table_for_pids).

Drain overflow is lossless: the native side returns the records that fit
and keeps the rest in the rings (truncation counter incremented); the
drain loops until nothing was left behind.

Differences from the original, by design: the hash carry is required in
FP mode unless PARCA_NO_CAPTURE_HASH is set (the port always builds the
sampler from its own source, which has it); an ``on_drain`` tee that
raises propagates out of poll(), as the port's feeder does; and a failed
native build or load raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import struct
import threading
import time

import numpy as np

from parca_agent_tpu_torch import native
from parca_agent_tpu_torch.capture.formats import (
    MAX_STACK_DEPTH,
    STACK_SLOTS,
    MappingTable,
    WindowSnapshot,
    filter_snapshot_rows,
)
from parca_agent_tpu_torch.ops.hashing import hash_params
from parca_agent_tpu_torch.process.maps import (
    ProcessMapCache,
    build_mapping_table,
)
from parca_agent_tpu_torch.process.objectfile import ObjectFileCache
from parca_agent_tpu_torch.unwind.table import (
    ShardedTable,
    UnwindTableBuilder,
)
from parca_agent_tpu_torch.unwind.walker import WalkStats, walk_batch
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.poison import PoisonInput
from parca_agent_tpu_torch.utils.vfs import RealFS

_log = get_logger("capture")

# pa_sampler_create2's flag for DWARF mode (registers and a stack slice
# a sample, v2 records).
PA_CAPTURE_USER_STACK = 1


class SamplerUnavailable(RuntimeError):
    """The kernel refused the perf events (opening, enabling or draining
    them); ``errno`` says why (EACCES or EPERM: no permission)."""

    def __init__(self, msg: str, errno: int = 0):
        super().__init__(msg)
        self.errno = errno


def build_native() -> str:
    """The sampler library's path, compiled first if it has no current
    build. A failed build raises RuntimeError with the compiler's
    output."""
    return str(native.ensure_built("sampler"))


def load_native() -> ctypes.CDLL:
    """The loaded sampler library, every entry point typed."""
    return native.load("sampler")


def decode_records(buf: bytes) -> list[tuple[int, int, np.ndarray, np.ndarray]]:
    """Packed v1 drain buffer -> [(pid, tid, kernel_frames, user_frames)]."""
    out = []
    pos = 0
    n = len(buf)
    while pos + 16 <= n:
        pid, tid, nk, nu = struct.unpack_from("<IIII", buf, pos)
        pos += 16
        if nk + nu > MAX_STACK_DEPTH or pos + 8 * (nk + nu) > n:
            break  # corrupt/truncated tail
        frames = np.frombuffer(buf, np.uint64, nk + nu, pos)
        pos += 8 * (nk + nu)
        out.append((pid, tid, frames[:nk], frames[nk:]))
    return out


def decode_records_v2(buf: bytes) -> list[
        tuple[int, int, np.ndarray, np.ndarray, int, int, int, np.ndarray]]:
    """Packed v2 drain buffer (the DWARF mode's records) ->
    [(pid, tid, kframes, uframes, rip, rsp, rbp, stack_bytes)]."""
    out = []
    pos = 0
    n = len(buf)
    while pos + 48 <= n:
        pid, tid, nk, nu = struct.unpack_from("<IIII", buf, pos)
        rip, rsp, rbp, dyn, _pad = struct.unpack_from(
            "<QQQII", buf, pos + 16)
        pos += 48
        dyn_pad = (dyn + 7) & ~7
        if nk + nu > MAX_STACK_DEPTH or pos + 8 * (nk + nu) + dyn_pad > n:
            break  # corrupt/truncated tail
        frames = np.frombuffer(buf, np.uint64, nk + nu, pos)
        pos += 8 * (nk + nu)
        stack = np.frombuffer(buf, np.uint8, dyn, pos)
        pos += dyn_pad
        out.append((pid, tid, frames[:nk], frames[nk:], rip, rsp, rbp,
                    stack))
    return out


def _decode_columnar(lib, kind: str, buf, nbytes: int, extra: tuple):
    """One native pass of the ``kind`` decoder (v1, v1d, v1h) over the
    first ``nbytes`` of ``buf`` (bytes or a ctypes buffer) into columnar
    arrays: pids, tids, ulen, klen, then the ``extra`` columns (dtypes),
    then stacks [n, STACK_SLOTS] with user frames first per row (the
    WindowSnapshot contract; the drain packs kernel frames first)."""
    src = np.frombuffer(buf, np.uint8, nbytes)
    n = int(getattr(lib, f"pa_decode_{kind}_count")(
        src.ctypes.data, nbytes, STACK_SLOTS))
    cols = [np.zeros(n, np.int32) for _ in range(4)]
    cols += [np.zeros(n, dt) for dt in extra]
    stacks = np.zeros((n, STACK_SLOTS), np.uint64)
    if n:
        got = int(getattr(lib, f"pa_decode_{kind}")(
            src.ctypes.data, nbytes, *(c.ctypes.data for c in cols),
            stacks.ctypes.data, STACK_SLOTS, n))
        if got != n:
            raise RuntimeError(f"pa_decode_{kind} decoded {got} of {n} "
                               "records")
    return (*cols[:4], stacks, *cols[4:])


def decode_records_columnar(lib, buf, nbytes: int) -> tuple:
    """Native one-pass v1 decode. Returns (pids, tids, ulen, klen,
    stacks)."""
    return _decode_columnar(lib, "v1", buf, nbytes, ())


def decode_records_columnar_v1d(lib, buf, nbytes: int) -> tuple:
    """Native one-pass v1d decode (dedup-drain records, 24-byte header
    with a count field). Returns (pids, tids, ulen, klen, stacks,
    counts)."""
    return _decode_columnar(lib, "v1d", buf, nbytes, (np.int64,))


def decode_records_columnar_v1h(lib, buf, nbytes: int) -> tuple:
    """Native one-pass v1h decode (hash-carrying dedup-drain records,
    32-byte header with count + h1/h2/h3). Returns (pids, tids, ulen,
    klen, stacks, counts, h1, h2, h3); the triple equals row_hash_np's
    over the decoded row (the drain computed it with the same installed
    tables)."""
    return _decode_columnar(lib, "v1h", buf, nbytes,
                            (np.int64, np.uint32, np.uint32, np.uint32))


def mapping_table_for_pids(maps_cache, objs_cache, pids,
                           quarantine=None) -> MappingTable:
    """MappingTable for a set of pids via the shared caches
    (``maps_cache.executable_mappings(pid)`` -> [ProcMapping],
    ``objs_cache.build_ids(per_pid)`` -> {path: build id}, and
    ``objs_cache.get(pid, mapping)`` for the normalization base); pids
    that exited (maps unreadable: OSError) or are unattributable (< 0)
    are skipped — their rows keep raw addresses.

    Ingest containment: with a quarantine registry (runtime/
    quarantine.py), a pid whose maps file is poison (PoisonInput) or
    whose processing blows the per-pid deadline is charged against its
    error budget and skipped — its samples stay unmapped and ride the
    degradation ladder — instead of aborting the table for every pid of
    the window. Without a registry PoisonInput propagates. Scalar-level
    pids skip the maps parse entirely; address-level pids keep their
    maps (normalized addresses must travel) but skip the object opens."""
    per_pid = {}
    healthy = {}
    for pid in pids:
        pid = int(pid)
        if pid < 0:
            continue
        level = quarantine.level(pid) if quarantine is not None else 0
        if level >= 2:
            continue  # scalar ladder level: counts only, no mapping work
        t0 = quarantine.clock() if quarantine is not None else 0.0
        try:
            per_pid[pid] = maps_cache.executable_mappings(pid)
        except OSError:
            continue
        except PoisonInput as e:
            if quarantine is None:
                raise
            quarantine.record_error(pid, getattr(e, "site", "maps.parse"),
                                    e)
            continue
        if quarantine is not None:
            quarantine.check_deadline(pid, t0)
            if quarantine.level(pid) == 0:
                healthy[pid] = per_pid[pid]
        else:
            healthy[pid] = per_pid[pid]
    # Build ids come from opening mapped objects: only healthy pids pay
    # (and risk) that; a path mapped by any healthy pid still contributes
    # its id for everyone.
    return build_mapping_table(per_pid, objs_cache.build_ids(healthy),
                               objcache=objs_cache, quarantine=quarantine)


def columns_to_snapshot(
    pids, tids, ulen, klen, stacks,
    mappings: MappingTable, period_ns: int, window_ns: int,
    weights=None, hashes=None,
) -> WindowSnapshot:
    """Dedup identical (pid, tid, stack) rows into counted rows (the role
    the BPF stack_counts map plays in the reference). `weights` carries
    per-row pre-aggregated counts; rows still merge here, with counts
    summed.

    `hashes` is an optional capture-carried (h1, h2, h3) uint32 triple
    aligned with the input rows. When given, the return is (snapshot,
    (h1, h2, h3)) with the triple gathered onto the snapshot's deduped
    rows — exact, because dedup-equal rows hash to equal triples."""
    pids = np.asarray(pids, np.int32)
    if weights is not None:
        weights = np.asarray(weights, np.int64)
    if hashes is not None:
        hashes = tuple(np.asarray(h, np.uint32) for h in hashes)
    if len(pids) and int(pids.min()) < 0:
        # Unattributable samples (pid -1) carry no process to profile,
        # and the uint32 cast downstream would alias the dead-row
        # sentinel: drop the records, not the window.
        keep = pids >= 0
        pids, tids = pids[keep], np.asarray(tids)[keep]
        ulen, klen = np.asarray(ulen)[keep], np.asarray(klen)[keep]
        stacks = np.asarray(stacks)[keep]
        if weights is not None:
            weights = weights[keep]
        if hashes is not None:
            hashes = tuple(h[keep] for h in hashes)
    n = len(pids)
    if n == 0:
        snap = WindowSnapshot(
            pids=np.zeros(0, np.int32), tids=np.zeros(0, np.int32),
            counts=np.zeros(0, np.int64), user_len=np.zeros(0, np.int32),
            kernel_len=np.zeros(0, np.int32),
            stacks=np.zeros((0, STACK_SLOTS), np.uint64),
            mappings=mappings, period_ns=period_ns, window_ns=window_ns,
            time_ns=time.time_ns(),
        )
        if hashes is not None:
            return snap, tuple(np.zeros(0, np.uint32) for _ in range(3))
        return snap
    # Vectorized row dedup over the byte view of each record, compared
    # only up to the drain's deepest stack (slots past it are zero in
    # every row).
    max_depth = int((ulen + klen).max())
    rec = np.zeros((n, max_depth + 4), np.uint64)
    rec[:, 0] = pids.astype(np.uint64)
    rec[:, 1] = tids.astype(np.uint64)
    rec[:, 2] = ulen.astype(np.uint64)
    rec[:, 3] = klen.astype(np.uint64)
    rec[:, 4:] = stacks[:, :max_depth]
    void = np.ascontiguousarray(rec).view(
        np.dtype((np.void, rec.shape[1] * 8))).ravel()
    _, first, inverse = np.unique(void, return_index=True, return_inverse=True)
    if weights is None:
        counts = np.bincount(inverse, minlength=len(first)).astype(np.int64)
    elif int(weights.sum(dtype=np.int64)) < 2**53:
        # float64 bincount is exact below 2^53 per key.
        counts = np.bincount(
            inverse, weights=weights, minlength=len(first)).astype(np.int64)
    else:
        counts = np.zeros(len(first), np.int64)
        np.add.at(counts, inverse, weights.astype(np.int64))
    snap = WindowSnapshot(
        pids=pids[first], tids=tids[first], counts=counts,
        user_len=ulen[first], kernel_len=klen[first], stacks=stacks[first],
        mappings=mappings, period_ns=period_ns, window_ns=window_ns,
        time_ns=time.time_ns(),
    )
    if hashes is not None:
        return snap, tuple(h[first] for h in hashes)
    return snap


def records_to_snapshot(
    records, mappings: MappingTable, period_ns: int, window_ns: int,
) -> WindowSnapshot:
    """Tuple-record variant of columns_to_snapshot: [(pid, tid,
    kernel_frames, user_frames)] -> a counted snapshot."""
    n = len(records)
    pids = np.zeros(n, np.int32)
    tids = np.zeros(n, np.int32)
    ulen = np.zeros(n, np.int32)
    klen = np.zeros(n, np.int32)
    stacks = np.zeros((n, STACK_SLOTS), np.uint64)
    for i, (pid, tid, kframes, uframes) in enumerate(records):
        # perf carries pid/tid as u32 (-1 = unattributable); store with
        # int32 wraparound semantics like the native columnar decoder,
        # so columns_to_snapshot's negative-pid drop sees them as -1.
        pids[i] = pid if pid < 2**31 else pid - 2**32
        tids[i] = tid if tid < 2**31 else tid - 2**32
        nu, nk = len(uframes), len(kframes)
        ulen[i] = nu
        klen[i] = nk
        # formats.py contract: user frames first, then kernel tail.
        stacks[i, :nu] = uframes
        stacks[i, nu:nu + nk] = kframes
    return columns_to_snapshot(pids, tids, ulen, klen, stacks,
                               mappings, period_ns, window_ns)


class UnwindTableCache:
    """Per-pid merged compact unwind tables with background builds and a
    5 s refresh (the role of the reference's watchProcesses loop: match
    processes, build and refresh their unwind tables off the hot path).
    ``fs`` reads each pid's comm and mapped objects (RealFS by
    default)."""

    def __init__(self, map_cache: ProcessMapCache,
                 comm_regex: str | None = None,
                 refresh_s: float = 5.0, fs=None):
        self._fs = fs or RealFS()
        self._builder = UnwindTableBuilder(fs=self._fs)
        # Ingest containment: set (by the sampler's quarantine property)
        # to the shared per-pid registry; builds charge poison to the
        # owning pid and skip laddered pids.
        self.quarantine = None
        self._maps = map_cache
        self._regex = re.compile(comm_regex) if comm_regex else None
        self._refresh = refresh_s
        self._tables: dict[int, ShardedTable] = {}
        self._built_at: dict[int, float] = {}
        self._lock = threading.Lock()
        self._queue: list[int] = []
        self._qset: set[int] = set()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        self._worker: threading.Thread | None = None
        self._last_evict = 0.0
        self.stats = {"builds": 0, "build_errors": 0}

    def _comm(self, pid: int) -> str:
        try:
            return self._fs.read_bytes(
                f"/proc/{pid}/comm").decode().strip()
        except OSError:
            return ""

    def matches(self, pid: int) -> bool:
        if self._regex is None:
            return True
        return bool(self._regex.search(self._comm(pid)))

    def table_for(self, pid: int) -> ShardedTable | None:
        """The pid's table if built; queues a (re)build when missing or
        stale. Never blocks the drain path."""
        now = time.monotonic()
        with self._lock:
            t = self._tables.get(pid)
            fresh = now - self._built_at.get(pid, 0) < self._refresh
            if (t is None or not fresh) and pid not in self._qset:
                self._qset.add(pid)
                self._queue.append(pid)
                self._cv.notify()
                self._ensure_worker()
            return t

    def evict(self, pid: int) -> None:
        """Drop a pid's table at once (process/identity.py: a recycled
        pid must not unwind through its dead predecessor's tables). A
        queued rebuild may stay queued: it reads the pid's current
        maps."""
        with self._lock:
            self._tables.pop(pid, None)
            self._built_at.pop(pid, None)

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="unwind-table-builder", daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            pid = None
            with self._cv:
                if not self._queue and not self._stop:
                    self._cv.wait(timeout=1.0)
                if self._stop:
                    return
                if self._queue:
                    pid = self._queue.pop(0)
            if pid is None:
                # Idle tick: the matched processes may all have exited,
                # and then no build runs the sweep below.
                self._evict_dead()
                continue
            try:
                self._builder.quarantine = self.quarantine
                maps = self._maps.executable_mappings(pid)
                # Range-partitioned: the walker's two-level lookup reads
                # the shards, and huge processes keep full coverage.
                table = ShardedTable.from_table(
                    self._builder.table_for_pid(pid, maps))
                with self._lock:
                    self._tables[pid] = table
                    self._built_at[pid] = time.monotonic()
                self.stats["builds"] += 1
            except Exception as e:  # noqa: BLE001 - one pid, not the worker
                # table_for_pid charges PoisonInput itself, but a maps
                # read can raise MapsError here, and a hostile input can
                # raise anything (MemoryError). Stamp built_at so the pid
                # is not queued again every drain, and keep the worker
                # alive for the other pids.
                if self.quarantine is not None \
                        and isinstance(e, PoisonInput):
                    self.quarantine.record_error(
                        pid, getattr(e, "site", "unwind.build"), e)
                with self._lock:
                    self._built_at[pid] = time.monotonic()
                self.stats["build_errors"] += 1
                _log.warn("unwind table build failed", pid=pid,
                          error=repr(e))
            finally:
                with self._lock:
                    self._qset.discard(pid)
                self._evict_dead()

    def _evict_dead(self) -> None:
        """Drop the tables of exited pids, so the tables' memory tracks
        the live process set under pid churn. Runs after builds and on
        idle ticks, at most once a refresh interval."""
        now = time.monotonic()
        if now - self._last_evict < self._refresh:
            return
        self._last_evict = now
        with self._lock:
            pids = list(self._tables)
        dead = [p for p in pids
                if not self._fs.exists(f"/proc/{p}/comm")]
        if not dead:
            return
        with self._lock:
            for p in dead:
                self._tables.pop(p, None)
                self._built_at.pop(p, None)
        self.stats["evicted"] = self.stats.get("evicted", 0) + len(dead)
        _log.debug("evicted unwind tables for exited pids", count=len(dead))

    def build_now(self, pid: int) -> ShardedTable | None:
        """Build the pid's table on this thread (tests, tools). None
        when its maps are gone or poisoned (charged to the pid with a
        quarantine registry)."""
        try:
            self._builder.quarantine = self.quarantine
            maps = self._maps.executable_mappings(pid)
        except OSError:
            return None
        except PoisonInput as e:
            if self.quarantine is not None:
                self.quarantine.record_error(
                    pid, getattr(e, "site", "maps.parse"), e)
            return None
        table = ShardedTable.from_table(
            self._builder.table_for_pid(pid, maps))
        with self._lock:
            self._tables[pid] = table
            self._built_at[pid] = time.monotonic()
        self.stats["builds"] += 1
        return table

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()


def unwind_records(records_v2, tables: UnwindTableCache,
                   trust_fp_frames: int | None = None, stats=None):
    """v2 records -> v1-shaped records with DWARF-walked user stacks.

    Every register-carrying sample of a table-matched pid is batch-walked
    and the LONGER of the walked and the frame-pointer chain wins (the
    reference likewise runs its DWARF walker for every sample of a
    targeted process: walking only short FP chains would keep truncated
    mixed stacks, where an FP-built leaf over a frameless caller stops
    the FP chain early with >= 2 frames). ``trust_fp_frames`` is a
    throughput knob: samples whose FP chain already has that many frames
    skip the walk (None: walk all). The walked user chain is cut to the
    depth the record's kernel frames leave (MAX_STACK_DEPTH). ``stats``
    (a WalkStats) accumulates the walks' outcomes.
    """
    by_pid: dict[int, list[int]] = {}
    for i, r in enumerate(records_v2):
        by_pid.setdefault(r[0], []).append(i)

    out = [(r[0], r[1], r[2], r[3]) for r in records_v2]
    total_stats = stats if stats is not None else WalkStats()
    for pid, idxs in by_pid.items():
        need = [i for i in idxs
                if records_v2[i][4] != 0
                and (trust_fp_frames is None
                     or len(records_v2[i][3]) < trust_fp_frames)]
        if not need or not tables.matches(pid):
            continue
        table = tables.table_for(pid)
        if table is None or len(table) == 0:
            continue
        m = len(need)
        dmax = max(len(records_v2[i][7]) for i in need)
        rip = np.zeros(m, np.uint64)
        rsp = np.zeros(m, np.uint64)
        rbp = np.zeros(m, np.uint64)
        dyn = np.zeros(m, np.int64)
        stacks = np.zeros((m, max(dmax, 8)), np.uint8)
        for k, i in enumerate(need):
            _, _, _, _, ip, sp, bp, stk = records_v2[i]
            rip[k], rsp[k], rbp[k] = ip, sp, bp
            dyn[k] = len(stk)
            stacks[k, : len(stk)] = stk
        frames, depth, st = walk_batch(table, rip, rsp, rbp, stacks, dyn)
        total_stats.add(st)
        for k, i in enumerate(need):
            # The record's kernel frames stay on the row; the walked user
            # chain must fit the depth they leave.
            budget = MAX_STACK_DEPTH - len(records_v2[i][2])
            d = min(int(depth[k]), budget)
            # Only adopt the walk when it beats the FP chain.
            if d > len(records_v2[i][3]):
                pid_, tid_, kf, _uf = out[i]
                out[i] = (pid_, tid_, kf, frames[k, :d].copy())
    return out


class PerfEventSampler:
    """Capture source: poll() blocks one window, draining the rings once
    a second, then returns the window's snapshot.

    ``capture_stack=True`` is DWARF mode: each sample also carries the
    user registers and ``stack_dump_bytes`` of its user stack (a
    multiple of 8 below 64 KiB), walked at drain time through the unwind
    tables of the pids whose comm matches ``dwarf_comm_regex`` (all pids
    when None); ``trust_fp_frames`` skips the walk of samples whose FP
    chain is at least that deep. ``walk_stats`` counts the walks.

    Raises SamplerUnavailable (with the errno) when the kernel refuses
    the perf events, RuntimeError when the native build or the hash
    tables' install fails."""

    def __init__(self, frequency_hz: int = 100, window_s: float = 10.0,
                 drain_cap_mb: int = 64, capture_stack: bool = False,
                 stack_dump_bytes: int = 16 * 1024,
                 dwarf_comm_regex: str | None = None,
                 trust_fp_frames: int | None = None):
        self._lib = load_native()
        self._freq = frequency_hz
        self._window = window_s
        self._cap = drain_cap_mb << 20
        self._maps = ProcessMapCache()
        self._objs = ObjectFileCache()
        # One reusable drain buffer: only the n written bytes of a drain
        # are read back.
        self._drainbuf = (ctypes.c_uint8 * self._cap)()
        # (lost, truncated, dedup, dd_overflow) snapshotted at close
        self._final_counters = (0, 0, 0, 0)
        # The per-drain tee (FP mode): called on the polling thread with
        # each drain's columns, so a streaming consumer (the window
        # feeder) ships them to the card during the window.
        self.on_drain = None
        self.capture_stack = capture_stack
        # DWARF mode's table cache and walk counters, made before the
        # quarantine property (which reaches the cache) is first set.
        self._tables = (UnwindTableCache(self._maps,
                                         comm_regex=dwarf_comm_regex)
                        if capture_stack else None)
        self._trust_fp_frames = trust_fp_frames
        self.walk_stats = WalkStats()
        # Ingest containment (runtime/quarantine.py): with a registry, a
        # poisoned maps file or object charges its pid and the window
        # goes on.
        self.quarantine = None
        ctypes.set_errno(0)
        self._handle = self._lib.pa_sampler_create2(
            frequency_hz, PA_CAPTURE_USER_STACK if capture_stack else 0,
            stack_dump_bytes if capture_stack else 0)
        if not self._handle:
            err = ctypes.get_errno()
            self._close_tables()
            raise SamplerUnavailable(
                f"perf_event_open failed (errno {err}, "
                f"{os.strerror(err)}): needs CAP_PERFMON or "
                "kernel.perf_event_paranoid <= 0", errno=err)
        if self._lib.pa_sampler_start(self._handle) != 0:
            err = ctypes.get_errno()
            # Free the per-CPU perf fds before raising: the caller may
            # degrade to another source and discard this object unclosed.
            self._lib.pa_sampler_destroy(self._handle)
            self._handle = None
            self._close_tables()
            raise SamplerUnavailable(
                f"failed to enable perf events (errno {err})", errno=err)
        self.n_cpus = self._lib.pa_sampler_n_cpus(self._handle)
        # The drain-time hash carry (FP mode): install the seeded
        # multilinear tables so the v1h drain stamps each unique record
        # with its h1/h2/h3 while its frames are hot.
        # PARCA_NO_CAPTURE_HASH=1 pins the hashless v1d drain (the feeder
        # then hashes on the host). DWARF mode drains hashless.
        self.hash_carry = False
        if not capture_stack and not os.environ.get("PARCA_NO_CAPTURE_HASH"):
            coefs, biases = hash_params(3, STACK_SLOTS)
            if self._lib.pa_sampler_set_hash(
                    self._handle, coefs.ctypes.data, coefs.shape[1],
                    biases.ctypes.data, 3, STACK_SLOTS) != 0:
                self.close()
                raise RuntimeError("pa_sampler_set_hash refused the row "
                                   "hash tables")
            self.hash_carry = True

    @property
    def quarantine(self):
        return self._quarantine

    @quarantine.setter
    def quarantine(self, registry) -> None:
        self._quarantine = registry
        if self._tables is not None:
            self._tables.quarantine = registry

    def _close_tables(self) -> None:
        if self._tables is not None:
            self._tables.close()

    # Counter properties stay truthful after close(): the native handle
    # is gone then, so close snapshots the final values.
    @property
    def lost_samples(self) -> int:
        if self._handle:
            return int(self._lib.pa_sampler_lost(self._handle))
        return self._final_counters[0]

    @property
    def truncated_drains(self) -> int:
        if self._handle:
            return int(self._lib.pa_sampler_truncated(self._handle))
        return self._final_counters[1]

    @property
    def dedup_hits(self) -> int:
        """Samples merged into an existing row at the drain boundary."""
        if self._handle:
            return int(self._lib.pa_sampler_dedup_hits(self._handle))
        return self._final_counters[2]

    @property
    def dedup_overflow(self) -> int:
        """Records emitted without table registration because the dedup
        probe chain saturated."""
        if self._handle:
            return int(self._lib.pa_sampler_dedup_overflow(self._handle))
        return self._final_counters[3]

    def _drain_passes(self, drain, consume) -> None:
        """Lossless drain: loops while the native side reports records
        left behind for lack of buffer space, handing each pass's
        (buffer, n_bytes) to ``consume`` before the buffer is reused."""
        for _ in range(64):  # safety bound; one pass is the norm
            before = self.truncated_drains
            n = drain(self._handle, ctypes.addressof(self._drainbuf),
                      self._cap)
            if n < 0:
                raise SamplerUnavailable(f"sampler drain failed ({n})")
            if n:
                consume(self._drainbuf, int(n))
            if self.truncated_drains == before:
                break

    def _drain_columnar(self) -> list[tuple]:
        """Lossless dedup drain with the native columnar decoder applied
        per pass, straight off the reusable drain buffer. Each chunk is
        (pids, tids, ulen, klen, stacks, counts), followed by (h1, h2,
        h3) with the hash carry."""
        if self.hash_carry:
            drain = self._lib.pa_sampler_drain_dedup2
            decode = decode_records_columnar_v1h
        else:
            drain = self._lib.pa_sampler_drain_dedup
            decode = decode_records_columnar_v1d
        cols = []
        self._drain_passes(
            drain, lambda buf, n: cols.append(decode(self._lib, buf, n)))
        return cols

    def _drain_v2(self) -> list[tuple]:
        """DWARF mode's lossless drain of v2 records, decoded."""
        chunks = []
        self._drain_passes(
            self._lib.pa_sampler_drain,
            lambda buf, n: chunks.append(ctypes.string_at(buf, n)))
        return decode_records_v2(b"".join(chunks))

    def poll(self) -> WindowSnapshot:
        deadline = time.monotonic() + self._window
        # Drain mid-window too so a ring never wraps.
        col_chunks: list[tuple] = []
        records: list[tuple] = []
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(1.0, remaining))
            if self.capture_stack:
                v2 = self._drain_v2()
                # Queue the table builds early, so they are ready within
                # the window (the 5 s watch cadence).
                for pid in {r[0] for r in v2}:
                    if self._tables.matches(pid):
                        self._tables.table_for(pid)
                records.extend(unwind_records(
                    v2, self._tables, trust_fp_frames=self._trust_fp_frames,
                    stats=self.walk_stats))
                continue
            for chunk in self._drain_columnar():
                col_chunks.append(chunk)
                if self.on_drain is not None:
                    self.on_drain(chunk)
        period_ns = int(1e9 / self._freq)
        window_ns = int(self._window * 1e9)
        if self.capture_stack:
            table = mapping_table_for_pids(
                self._maps, self._objs, sorted({r[0] for r in records}),
                quarantine=self.quarantine)
            return records_to_snapshot(records, table, period_ns, window_ns)
        cols = [np.concatenate([c[i] for c in col_chunks])
                if col_chunks else z
                for i, z in enumerate((
                    np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros((0, STACK_SLOTS), np.uint64),
                    np.zeros(0, np.int64)))]
        table = mapping_table_for_pids(self._maps, self._objs,
                                       np.unique(cols[0]).tolist(),
                                       quarantine=self.quarantine)
        return columns_to_snapshot(*cols[:5], table, period_ns, window_ns,
                                   weights=cols[5])

    def close(self) -> None:
        if self._handle:
            self._final_counters = (self.lost_samples,
                                    self.truncated_drains, self.dedup_hits,
                                    self.dedup_overflow)
            self._lib.pa_sampler_destroy(self._handle)
            self._handle = None
        self._close_tables()


class CommFilterSource:
    """Snapshot-source wrapper keeping only rows whose pid's comm matches
    one of the given regexes (--debug-process-names). Whole-machine
    capture stays on; rows are dropped at the window boundary, so the
    filter composes with any source. Comm verdicts are cached per pid
    with a TTL: pids get reused by the kernel and processes exec() into
    new comms, so a verdict is a lease, not a fact (and the TTL also
    bounds the cache under pid churn).

    Drains tee'd mid-window (streaming) bypass this filter; the CLI
    therefore runs debug-filtered sessions one-shot.
    """

    def __init__(self, source, patterns, read_comm=None,
                 cache_ttl_s: float = 60.0, clock=time.monotonic):
        self._source = source
        self._regexes = [re.compile(p) for p in patterns if p]
        self._cache: dict[int, tuple[bool, float]] = {}
        self._ttl = cache_ttl_s
        self._clock = clock

        def _default_read(pid: int) -> str:
            try:
                with open(f"/proc/{pid}/comm", "rb") as f:
                    return f.read().decode().strip()
            except OSError:
                return ""

        self._read_comm = read_comm or _default_read

    def __getattr__(self, name):
        return getattr(self._source, name)

    def _keep(self, pid: int, now: float) -> bool:
        got = self._cache.get(pid)
        if got is not None and now - got[1] < self._ttl:
            return got[0]
        comm = self._read_comm(pid)
        verdict = any(r.search(comm) for r in self._regexes)
        self._cache[pid] = (verdict, now)
        return verdict

    def poll(self):
        snap = self._source.poll()
        if snap is None or not len(snap) or not self._regexes:
            return snap
        now = self._clock()
        uniq = np.unique(snap.pids)
        if len(self._cache) > 4 * len(uniq) + 1024:
            # Bound the cache under pid churn: drop expired leases.
            self._cache = {p: v for p, v in self._cache.items()
                           if now - v[1] < self._ttl}
        kept = np.array([p for p in uniq.tolist()
                         if self._keep(int(p), now)], np.int32)
        if len(kept) == len(uniq):
            return snap
        return filter_snapshot_rows(snap, np.isin(snap.pids, kept))

    def close(self) -> None:
        close = getattr(self._source, "close", None)
        if close is not None:
            close()
