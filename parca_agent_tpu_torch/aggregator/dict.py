"""Incremental aggregation with a device-resident stack dictionary.

PyTorch counterpart of parca_agent_tpu/aggregator/dict.py, held to it bit
for bit (counts by stack id, id assignment, packed close buffers, pprof).
An always-on profiler sees an almost-stationary stack population, so the
device keeps a persistent open-addressing hash table of every stack ever
seen:

  device state   table int32 [cap, 4] = (h1, h2, h3, id + 1) uint32 bits
  per feed       one fused CUDA kernel (aggregator/probe.py): batched
                 linear-probe LOOKUP of all rows, atomic add of counts by
                 stack id into acc int32 [id_cap], touched 128-id blocks
                 flagged; misses compacted in row order by a cumsum
  per close      the accumulator packed at 4, 8 or 16 bits with an exact
                 overflow sideband (full or delta form: the CUDA kernels
                 of aggregator/close.py), fetched in one transfer

Misses (stacks not yet in the table) come back in a miss buffer; the HOST
owns insertion: it keeps an exact mirror (the same probe sequence on the
same arrays), assigns dense ids, resolves the new stacks'
locations/mappings once (numpy, incremental), and scatters the few new
entries into the device table. The first window pays full insertion;
steady state inserts ~nothing.

Identity is the 96-bit triple (h1, h2, h3) of the full padded row. Each
PidProfile lists the pid's full location registry (every location seen so
far), a superset of the window's — valid pprof, same samples.

Device tensors carry uint32 values as int32 bit patterns (numpy uint32
arrays viewed as int32 at the host boundary).

Bounded memory: with overflow "sketch" (the default), stacks that arrive
once the dictionary is full are absorbed into a host count-min sketch and
HLL (ops/sketch.py: approximate counts with known bounds instead of
loss), and at the next window boundary stacks unseen for rotate_min_age
windows are evicted and their ids recycled (_compact_ids), so an
always-on agent on a host with stack churn runs in bounded memory.
Overflow "raise" keeps the fail-fast contract: a window that would
exceed the table raises before mutating anything.
"""

from __future__ import annotations

import dataclasses
import time
from itertools import compress

import numpy as np
import torch

from parca_agent_tpu_torch.aggregator import probe
from parca_agent_tpu_torch.aggregator.base import PidProfile, ProfileMapping
from parca_agent_tpu_torch.aggregator.close import (
    _compact_into,
    close_pack,
    close_pack_delta,
)
from parca_agent_tpu_torch.aggregator.cpu import _pid_mappings
from parca_agent_tpu_torch.capture.formats import (
    KERNEL_ADDR_START,
    STACK_SLOTS,
    WindowSnapshot,
    fold_rows_first_seen,
)
from parca_agent_tpu_torch.ops.hashing import row_hash_np
from parca_agent_tpu_torch.ops.sketch import (
    CountMinSpec,
    HLLSpec,
    cm_add,
    cm_query,
    hll_build,
    hll_estimate,
    hll_merge,
)
from parca_agent_tpu_torch.pprof.vec import ragged_gather
from parca_agent_tpu_torch.runtime import device_telemetry as dtel
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.bounded import device_wait
from parca_agent_tpu_torch.utils.device import resolve_device
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("aggregator.dict")

# Linear-probe bound. The capacity guard keeps load factor <= 0.5, and at
# the default table sizing (2x the id capacity) it stays <= 0.25, where
# chains beyond 16 are rare enough that whole windows see none. Chains
# that do exceed the bound are absorbed by the host as overflow misses;
# exactness is unaffected either way.
_PROBES = probe.PROBES

# Miss batches at or above this size take the vectorized settle path
# (plan-then-commit over the host mirror, one registry append per batch);
# below it the scalar loop's constant factors win.
_VEC_MISS_MIN = 512


def _probe_free(occ: np.ndarray, home: int) -> int:
    """The host table's insert rule: the first free slot at or after
    `home`, wrapping (linear probing, unbounded on the host)."""
    mask = len(occ) - 1
    idx = home
    while occ[idx]:
        idx = (idx + 1) & mask
    return idx


def _fcfs_slots(home: np.ndarray, cap: int) -> np.ndarray:
    """The slots that inserting keys with these home slots one by one, in
    order, into an empty table of `cap` slots gives by _probe_free, for at
    most cap // 2 keys, without a Python loop over the keys.

    Linear probing fills the same set of slots in any order. That set is
    runs of adjacent slots with a free slot between them, and no probe
    crosses a free slot, so keys of different runs never meet: step t
    places the t-th key (in insertion order) of every run at once."""
    m = len(home)
    if not m:
        return np.empty(0, np.int64)
    mask = cap - 1
    rank = np.arange(m, dtype=np.int64)

    def park(shift):
        # The i-th smallest home parks at i + max_{j<=i}(home_j - j) on a
        # table without wrap-around.
        rot = (home - shift) & mask
        return rot, np.maximum.accumulate(np.sort(rot) - rank) + rank

    shift = 0
    rot, pos = park(0)
    if pos[-1] >= cap:
        # Keys parked past the end wrap to slot 0 and take the first free
        # slots there; the next free slot stays free, so start the table
        # just after it: then nothing wraps.
        over = int(np.count_nonzero(pos >= cap))
        lin = np.zeros(cap, bool)
        lin[pos[:m - over]] = True
        shift = int(np.flatnonzero(~lin)[over]) + 1
        rot, pos = park(shift)
    # A key's run is the one whose slots hold its home; a key alone in its
    # run stays home.
    label = np.zeros(cap, np.int32)
    label[pos[np.r_[True, pos[1:] != pos[:-1] + 1]]] = 1
    run = np.cumsum(label, dtype=np.int32)[rot] - 1
    slots = rot.copy()
    multi = np.flatnonzero(np.bincount(run)[run] > 1)
    by_run = multi[np.argsort(run[multi], kind="stable")]
    rs = run[by_run]
    start = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
    step = np.arange(len(rs)) - np.repeat(start, np.diff(np.r_[start,
                                                              len(rs)]))
    by_step = by_run[np.argsort(step, kind="stable")]
    taken = np.zeros(cap, bool)
    lo = 0
    for n in np.bincount(step):
        keys = by_step[lo:lo + n]
        lo += n
        idx = rot[keys]
        busy = np.flatnonzero(taken[idx])
        while len(busy):
            idx[busy] += 1
            busy = busy[taken[idx[busy]]]
        taken[idx] = True
        slots[keys] = idx
    return (slots + shift) & mask


def _fcfs_place(base: np.ndarray, start: np.ndarray, mask: int) -> np.ndarray:
    """The slots that inserting keys one by one, in order, gives when each
    key probes the sub-table of mask + 1 slots at base[i] from start[i]
    (_probe_free within its sub-table; one table when every base is 0).
    Sub-tables never share a key's probe, so each is _fcfs_slots of its
    own keys, or, when they fill more than half of it, the one-by-one
    loop."""
    cap = mask + 1
    slots = np.empty(len(start), np.int64)
    order = np.argsort(base, kind="stable")
    cuts = np.flatnonzero(np.diff(base[order])) + 1
    for grp in np.split(order, cuts) if len(order) else ():
        if len(grp) <= cap // 2:
            slots[grp] = base[grp[0]] + _fcfs_slots(start[grp], cap)
            continue
        occ = np.zeros(cap, bool)
        for i in grp.tolist():
            idx = _probe_free(occ, int(start[i]))
            occ[idx] = True
            slots[i] = base[i] + idx
    return slots


def feed_step(table: torch.Tensor, acc: torch.Tensor,
              touch: torch.Tensor | None, blk: int, packed: torch.Tensor,
              reset: bool):
    """One streaming-window feed: the counterpart of
    parca_agent_tpu/aggregator/dict.py:make_feed.

    packed is int32 [4, n_pad] (h1, h2, h3, count; uint32 bits). acc and
    touch are updated IN PLACE (reset first when `reset`); returns
    (n_miss int64 scalar tensor, miss_rows int32 [n_pad]: the row indices
    of live rows that missed, in row order, then -1). No host sync."""
    if reset:
        acc.zero_()
        if touch is not None:
            touch.zero_()
    h1, h2, h3, cnt = packed[0], packed[1], packed[2], packed[3]
    found = probe.feed_accumulate(table, acc, touch, blk, h1, h2, h3, cnt)
    miss = (cnt > 0) & (found < 0)
    n = packed.shape[1]
    rows = torch.arange(n, dtype=torch.int64, device=packed.device)
    miss_rows = _compact_into(n, miss, rows, -1).to(torch.int32)
    return miss.sum(), miss_rows


# Overflow sideband caps for the packed close fetch: ids whose window
# count exceeds the packing sentinel. The accumulator is NOT cleared by
# close (it resets on the next window's first feed), so a sideband overrun
# is recoverable: the host re-runs close at a wider packing and/or a
# larger sideband. Width 16 at the max sideband is the lossless backstop —
# any window total < 2^31 yields at most 2^31/65535 = 32768 overflows.
# The sideband actually fetched is sized predictively from the previous
# window, floored at _OVER_MIN.
_CLOSE_OVERS = {4: 1 << 15, 8: 1 << 15, 16: 1 << 15}
_OVER_MIN = 1 << 12

# Delta-fetch granularity: stack ids per touched-block flag (a multiple of
# every pack width's per32).
_DELTA_BLOCK = 128
# Delta fetch must move strictly less than half the full fetch's rows to
# be worth its second buffer dimension; past this the full close is used.
_DELTA_MAX_FRAC = 0.5

# The stats of the bounded-memory mode that a state carries across
# (sketch_info reads them).
_SKETCH_STATS = ("sketch_rows", "sketch_samples", "rotations",
                 "pid_invalidations", "invalidation_compactions")
# The overflow HLL's shape, parca_agent_tpu's (not a constructor option
# there either); the count-min table's is each dictionary's cm_spec.
_HLL_SPEC = HLLSpec()


class _CloseHandle:
    """One dispatched-but-uncollected window close (close_dispatch). The
    accumulator/touch references are the PRE-FLIP buffers, which the
    retry loop can re-pack any number of times while the next window's
    feeds land in the flipped twin."""

    __slots__ = ("acc", "touch", "pending", "pending_vec", "n_ids",
                 "n_fetch", "width", "n_over_buf", "delta_blks", "out_dev")

    def __init__(self):
        self.acc = None
        self.touch = None
        self.pending = []
        # The carry cache's window flush: (sids int64, counts int64)
        # arrays, applied once at collect (same lifecycle as pending).
        self.pending_vec = None
        self.n_ids = 0
        self.n_fetch = 0
        self.width = 0
        self.n_over_buf = 0
        self.delta_blks = 0
        self.out_dev = None


def registry_content_digest(mappings, loc_address, loc_normalized,
                            loc_mapping_id, loc_is_kernel) -> bytes:
    """16-byte digest of one pid registry's full content — mappings (all
    fields, including the normalization base) and every location row. The
    identity the statics snapshot keys on (pprof/statics_store.py): a
    record whose stored digest differs from the digest of its decoded
    content is discarded as corrupt."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for m in mappings:
        h.update(("%d,%d,%d,%d,%d,%s\0%s\0" % (
            m.id, m.start, m.end, m.offset, m.base, m.path,
            m.build_id)).encode())
    h.update(b";")
    h.update(np.asarray(loc_address, np.uint64).tobytes())
    h.update(np.asarray(loc_normalized, np.uint64).tobytes())
    h.update(np.asarray(loc_mapping_id, np.int32).tobytes())
    h.update(np.asarray(loc_is_kernel, bool).tobytes())
    return h.digest()


@dataclasses.dataclass
class _PidRegistry:
    """Per-pid incremental location registry (grows, never shrinks).

    Mappings are append-only with registry-stable 1-based ids: when a
    later window brings a changed mapping table, new ranges get NEW ids;
    existing loc_mapping_id values stay valid against this registry's
    list.
    """

    addr_to_loc: dict  # int addr -> 1-based loc id
    loc_address: list
    loc_normalized: list
    loc_mapping_id: list
    loc_is_kernel: list
    mappings: list     # ProfileMapping with registry-stable ids
    mapping_index: dict  # (start, end, offset) -> 1-based registry id


class DictAggregator:
    """Stateful exact aggregation on a device; reuse one instance across
    windows. ``device`` is "cuda" (default; raises without a CUDA device)
    or "cpu" (the plain PyTorch versions of the kernels). ``overflow`` is
    "sketch" (default: degrade to the count-min sideband and rotate cold
    stacks at capacity) or "raise" (fail fast).

    The other options are parca_agent_tpu's, with its defaults:
    ``id_cap`` bounds the stack ids (default ``capacity // 2``; one that
    is not a multiple of 128 turns the delta close off); ``cm_spec`` is
    the overflow count-min sketch's shape (default ``CountMinSpec()``);
    ``delta_fetch=False`` makes every close the full pack, never the
    touched-block delta; ``coalesce=False`` dispatches every feed row as
    it is instead of folding the batch to (stack, weight) pairs first
    (miss order, ids and pprof bytes are the same either way);
    ``carry=True`` turns on the cross-drain carry cache (host numpy): a
    stack dispatches on its first drain and later drains fold its mass
    on the host, flushed once at the close."""

    name = "dict"

    def __init__(self, capacity: int = 1 << 21, id_cap: int | None = None,
                 overflow: str = "sketch",
                 cm_spec: CountMinSpec | None = None,
                 rotate_min_age: int = 6, delta_fetch: bool = True,
                 coalesce: bool = True,
                 device: str | torch.device = "cuda", carry: bool = False):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        if overflow not in ("sketch", "raise"):
            raise ValueError("overflow must be 'sketch' or 'raise'")
        self.device = resolve_device(device)
        self._cap = capacity
        self._id_cap = id_cap or capacity // 2
        self._overflow = overflow
        # Feed coalescing: fold each batch to (stack, weight) pairs on the
        # identity triple before packing, first-occurrence ordered. A
        # fold failure (chaos site feed.coalesce) is counted and the
        # batch dispatches unfolded, never lost.
        self._coalesce = coalesce
        self._cm_spec = cm_spec or CountMinSpec()
        # Cross-drain carry cache: an h1-sorted host map key -> (stack id,
        # accumulated weight). A stack's FIRST dispatch admits its key;
        # every later drain that sees the key folds its mass here instead
        # of shipping a dispatch row, and the close flushes the
        # accumulated (sid, weight) pairs alongside the pending
        # corrections. Weights are zeroed at every window boundary (close
        # flush, discard); the key -> sid entries persist until a
        # compaction remaps the id space. At most one entry per live id.
        self._carry = carry
        self._carry_h1 = np.zeros(0, np.uint32)  # sorted, unique
        self._carry_h2 = np.zeros(0, np.uint32)
        self._carry_h3 = np.zeros(0, np.uint32)
        self._carry_sid = np.zeros(0, np.int64)
        self._carry_w = np.zeros(0, np.int64)
        # Prefix-bucket index over _carry_h1: starts[p] .. starts[p+1]
        # bound the entries whose top (32 - shift) bits equal p (~O(1)
        # probes a needle at <= 0.5 load). Rebuilt only at admission.
        self._carry_shift = 32
        self._carry_starts = np.zeros(2, np.int64)
        self._carry_open_mass = 0   # mass carried for the open window
        self._carry_disabled = False  # match failed: off until boundary
        self._cm = None                  # lazy [depth, width] int64
        self._over_hll = None            # lazy [m] int32 registers
        self._rotate_min_age = rotate_min_age
        self._rotate_pending = False
        # Pids whose invalidate_pid arrived while a close or a miss check
        # was in flight; dropped at the next window boundary.
        self._invalidate_pending: set[int] = set()
        # Per-id window number the id last had samples (eviction clock).
        self._last_seen = np.zeros(self._id_cap, np.int32)
        # Host mirror (source of truth).
        self._h1 = np.zeros(capacity, np.uint32)
        self._h2 = np.zeros(capacity, np.uint32)
        self._h3 = np.zeros(capacity, np.uint32)
        self._occ = np.zeros(capacity, bool)
        self._ids = np.full(capacity, -1, np.int32)
        # Stack keys (h1, h2, h3) in id order: _keys[i] is stack id i's.
        # The key -> id map (_key_to_id) is built from it on first use
        # after a compaction, so calls that compact back to back build it
        # once.
        self._keys: list[tuple] = []
        self._key_map: dict[tuple, int] | None = {}
        self._next_id = 0
        # Publication watermark for concurrent readers (the encode
        # pipeline's worker thread): _next_id advances inside the miss
        # settle BEFORE the per-id metadata and per-pid registries are
        # written; _published advances only once _append_id_meta lands
        # the batch (and at a compaction), so ids [0, _published) always
        # have complete metadata. The window encoder syncs against it.
        self._published = 0
        # Per-id metadata, ragged numpy (appended at insertion): stack id i
        # has pid _id_pid[i] and 1-based per-pid loc ids
        # _loc_flat[_loc_off[i]:_loc_off[i+1]] (depth == run length).
        self._id_pid = np.empty(1024, np.int32)
        self._loc_off = np.zeros(1025, np.int64)
        self._loc_flat = np.empty(4096, np.int32)
        # Per-id content hashes (the h1/h2 identity lanes, in id order).
        self._id_h1 = np.empty(1024, np.uint32)
        self._id_h2 = np.empty(1024, np.uint32)
        self._pids: dict[int, _PidRegistry] = {}
        # Bumped whenever any per-pid registry may have changed (insert
        # batches, compactions, load_state): the window encoder skips its
        # O(pids) statics staleness scan while it stands still.
        self._reg_version = 0
        # Device table (created lazily from the host mirror).
        self._dev = None
        # Streaming-window state (feed/close_window protocol). The
        # accumulator (and its touched-block flags) are DOUBLE-BUFFERED:
        # close_dispatch() flips active<->spare, so window N+1's feeds
        # land in one buffer while window N's pack/fetch (and any
        # grow-then-widen retry) runs against the other.
        self._acc = None            # active device int32 [id_cap] acc
        self._acc_spare = None      # the other buffer (last closed window)
        self._touch = None          # active int32 [n_blocks] touch flags
        self._touch_spare = None
        self._fed_total = 0         # sample mass fed into the open window
        self._needs_reset = False   # first feed of next window clears acc
        self._prev_counts = None    # last closed window (width prediction)
        self._prev_n_over = 0       # last close's overflow population
        # Delta-fetch state: block granularity (0 = tracking disabled —
        # the id space must divide into _DELTA_BLOCK blocks), and the
        # previous window's touched-block population (None = no history:
        # the next close fetches full and reads the flags).
        self._blk = _DELTA_BLOCK if (
            delta_fetch and self._id_cap % _DELTA_BLOCK == 0) else 0
        self._n_blocks = (self._id_cap // self._blk) if self._blk else 0
        self._prev_touched: int | None = None
        # Deferred feed-miss settle: _feed_dispatch_async returns device
        # handles without a host sync; the miss check settles at the NEXT
        # feed (or at close), by which time the kernel has long finished.
        # (handle, snapshot, rows_map, w64, h1, h2, h3) — all DISPATCH-row
        # aligned: rows_map maps each dispatched row to its representative
        # snapshot row, w64 is its (possibly folded) mass, h1/h2/h3 its
        # identity triple.
        self._miss_inflight = None
        # Dispatched-but-uncollected close (close_dispatch/close_collect).
        self._close_handle: _CloseHandle | None = None
        # Keys at probe-chain positions >= _PROBES: device lookups can
        # never find them, so feeds settle them host-side pre-ship.
        self._unreachable: dict[tuple, int] = {}
        self._unreach_h1: np.ndarray | None = None
        # Reused host buffers (warm pages are free; fresh multi-MB
        # allocations per feed/close cost page faults). The counts buffer
        # is DOUBLE-buffered because the previous window's array must
        # survive one more close.
        self._feed_bufs: dict[int, np.ndarray] = {}
        self._unpack_bufs: dict[tuple, np.ndarray] = {}
        self._counts_bufs: list = [None, None]
        self._counts_flip = 0
        self._pending: list[tuple[int, int]] = []  # host-side corrections
        self.stats = {"windows": 0, "inserts": 0, "overflow_misses": 0}
        self.timings: dict[str, float] = {}

    @property
    def registry_epoch(self) -> int:
        """Epoch of the id space: bumped whenever a cold-stack rotation OR
        a pid invalidation's compaction remaps stack ids wholesale. The
        window encoder keys its per-id mirrors on it."""
        return (self.stats.get("rotations", 0)
                + self.stats.get("invalidation_compactions", 0))

    @property
    def _key_to_id(self) -> dict[tuple, int]:
        if self._key_map is None:
            self._key_map = dict(zip(self._keys, range(len(self._keys))))
        return self._key_map

    # -- public -------------------------------------------------------------

    def aggregate(self, snapshot: WindowSnapshot,
                  hashes=None) -> list[PidProfile]:
        counts = self.window_counts(snapshot, hashes)
        return self._build_profiles(snapshot, counts)

    def hash_rows(self, snapshot: WindowSnapshot):
        """The capture-side identity triple (h1, h2, h3) of every row."""
        return row_hash_np(snapshot.stacks, snapshot.pids,
                           snapshot.user_len, snapshot.kernel_len,
                           n_hashes=3)

    def window_counts(self, snapshot: WindowSnapshot,
                      hashes=None) -> np.ndarray:
        """The aggregation core: int64 counts indexed by stack id
        (length == number of stacks known after this window), through the
        same feed/close path the streaming protocol uses. Any
        partially-fed open window is discarded first. Id assignment
        order matches the miss order of a single whole-window feed."""
        if len(snapshot) == 0:
            return np.zeros(self._next_id, np.int64)
        self.discard_open_window()
        self.feed(snapshot, hashes)
        return self.close_window(copy=True)

    def discard_open_window(self) -> None:
        """Drop every trace of a partially-fed open window — device mass
        (via the reset flag), host-side pending corrections, and any
        un-settled deferred miss check — without touching the registry.
        Dropping the miss check is exact: the discarded window's new
        stacks were never inserted, so they simply miss again later."""
        self._miss_inflight = None
        self._fed_total = 0
        self._pending = []
        self._needs_reset = True
        # Carried mass of the aborted window must not leak into the next
        # one's flush; the cache itself (key -> sid) stays warm.
        self._carry_disabled = False
        if self._carry_open_mass:
            self._carry_w[:] = 0
            self._carry_open_mass = 0
            self.stats["carry_discards"] = \
                self.stats.get("carry_discards", 0) + 1

    # -- registry identity (statics snapshot support) ------------------------

    def id_hashes(self, n: int | None = None):
        """Per-id content hashes (h1, h2) for ids [0, n): the identity
        every cross-node consumer keys on (fleet merge, hotspot rollups).
        ``n`` defaults to the published watermark; callers off the
        mutating thread must pass ids they observed at or below a
        _published they read earlier."""
        if n is None:
            n = self._published
        return self._id_h1[:n], self._id_h2[:n]

    def footprint_bytes(self) -> dict:
        """Per-lane host-memory accounting: every lane must go flat (or
        sit at its construction-time cap) once a stationary workload is
        warm. Lanes holding Python lists (the per-pid location
        registries) are counted at a fixed per-entry estimate."""
        carry = int(self._carry_h1.nbytes + self._carry_h2.nbytes
                    + self._carry_h3.nbytes + self._carry_sid.nbytes
                    + self._carry_w.nbytes + self._carry_starts.nbytes)
        table = int(self._h1.nbytes + self._h2.nbytes + self._h3.nbytes
                    + self._occ.nbytes + self._ids.nbytes
                    + self._last_seen.nbytes)
        id_meta = int(self._id_pid.nbytes + self._loc_off.nbytes
                      + self._loc_flat.nbytes + self._id_h1.nbytes
                      + self._id_h2.nbytes)
        # ~56 B per interned key tuple entry; ~48 B per location list
        # row across the four parallel lists; ~120 B per mapping row.
        keys = 56 * len(self._key_to_id)
        regs = 0
        for reg in self._pids.values():
            regs += 48 * len(reg.loc_address) + 120 * len(reg.mappings) \
                + 56 * len(reg.addr_to_loc)
        return {
            "carry_bytes": carry,
            "table_bytes": table,
            "id_meta_bytes": id_meta,
            "key_index_bytes": int(keys),
            "pid_registry_bytes": int(regs),
        }

    def registry_digest(self, pid: int, n_mappings: int | None = None,
                        n_locs: int | None = None) -> bytes | None:
        """Content digest of one pid's location registry (bounded reads
        for encoder-thread callers); None for an unknown pid."""
        reg = self._pids.get(pid)
        if reg is None:
            return None
        nm = len(reg.mappings) if n_mappings is None else n_mappings
        nl = min(len(reg.loc_address), len(reg.loc_normalized),
                 len(reg.loc_mapping_id), len(reg.loc_is_kernel))
        if n_locs is not None:
            nl = min(nl, n_locs)
        return registry_content_digest(
            reg.mappings[:nm], reg.loc_address[:nl],
            reg.loc_normalized[:nl], reg.loc_mapping_id[:nl],
            reg.loc_is_kernel[:nl])

    def adopt_registry(self, pid: int, mappings, loc_address,
                       loc_normalized, loc_mapping_id,
                       loc_is_kernel) -> bool:
        """Install a snapshot-restored per-pid location registry (the
        statics store's warm-restart path). Cold-start only: refused
        (False) once the pid has a registry — adoption must never alias
        or reorder live loc ids. Adopted content is an append-only
        prefix: the pid's first live window translates re-seen addresses
        to their restored ids and appends only the new ones."""
        if pid in self._pids:
            return False
        # One C-level pass to plain ints (dict keys must be exact ints;
        # a np.uint64 key would miss every later lookup).
        addrs = np.asarray(loc_address, np.uint64).tolist()
        self._pids[pid] = _PidRegistry(
            addr_to_loc=dict(zip(addrs, range(1, len(addrs) + 1))),
            loc_address=addrs,
            loc_normalized=np.asarray(loc_normalized, np.uint64).tolist(),
            loc_mapping_id=np.asarray(loc_mapping_id, np.int32).tolist(),
            loc_is_kernel=np.asarray(loc_is_kernel, bool).tolist(),
            mappings=list(mappings),
            mapping_index={(m.start, m.end, m.offset): m.id
                           for m in mappings},
        )
        self._reg_version += 1
        return True

    # -- state carried across (the dictionary is this system's state) --------

    def export_state(self) -> dict:
        """The dictionary's state as numpy arrays and Python lists:
        the host mirror, the per-id metadata, the per-pid registries, the
        unreachable keys and the bounded-memory state (the count-min and
        HLL tables, a pending rotation, pending pid invalidations and the
        stats sketch_info reads). Window-boundary only (no open
        feed/close)."""
        self._require_boundary("export_state")
        n = self._next_id
        nl = int(self._loc_off[n])
        return {
            "h1": self._h1.copy(), "h2": self._h2.copy(),
            "h3": self._h3.copy(), "occ": self._occ.copy(),
            "ids": self._ids.copy(), "next_id": n,
            "id_pid": self._id_pid[:n].copy(),
            "loc_off": self._loc_off[:n + 1].copy(),
            "loc_flat": self._loc_flat[:nl].copy(),
            "id_h1": self._id_h1[:n].copy(), "id_h2": self._id_h2[:n].copy(),
            "last_seen": self._last_seen.copy(),
            "windows": self.stats["windows"],
            "registries": {
                pid: {
                    "loc_address": list(r.loc_address),
                    "loc_normalized": list(r.loc_normalized),
                    "loc_mapping_id": list(r.loc_mapping_id),
                    "loc_is_kernel": list(r.loc_is_kernel),
                    "mappings": [(m.id, m.start, m.end, m.offset, m.path,
                                  m.build_id, m.base) for m in r.mappings],
                } for pid, r in self._pids.items()},
            "unreachable": [(*k, sid) for k, sid in self._unreachable.items()],
            "cm": None if self._cm is None else self._cm.copy(),
            "over_hll": (None if self._over_hll is None
                         else self._over_hll.copy()),
            "rotate_pending": self._rotate_pending,
            "invalidate_pending": sorted(self._invalidate_pending),
            "sketch_stats": {k: self.stats[k] for k in _SKETCH_STATS
                             if k in self.stats},
        }

    def load_state(self, arrays: dict) -> None:
        """Install a state taken by export_state (or the same fields read
        from parca_agent_tpu's DictAggregator). Rebuilds the key index
        from the mirror and the device table from the mirror; the open
        window, if any, is discarded."""
        self._require_boundary("load_state")
        cap, n = self._cap, int(arrays["next_id"])
        for k in ("h1", "h2", "h3", "occ", "ids"):
            if len(arrays[k]) != cap:
                raise ValueError(f"state {k!r} has {len(arrays[k])} slots, "
                                 f"this dictionary {cap}")
        if n > self._id_cap or len(arrays["id_pid"]) < n \
                or len(arrays["loc_off"]) < n + 1:
            raise ValueError(f"state holds {n} ids; id_cap is {self._id_cap}")
        self._h1 = np.array(arrays["h1"], np.uint32)
        self._h2 = np.array(arrays["h2"], np.uint32)
        self._h3 = np.array(arrays["h3"], np.uint32)
        self._occ = np.array(arrays["occ"], bool)
        self._ids = np.array(arrays["ids"], np.int32)
        slots = np.flatnonzero(self._occ)
        if not np.array_equal(np.sort(self._ids[slots]), np.arange(n)):
            raise ValueError("state mirror does not hold ids 0..next_id-1 "
                             "exactly once")
        # The keys in id order, the order the dictionary inserts in:
        # _compact_ids re-inserts keys in this order, so it fixes the
        # rebuilt table's probe layout.
        slots = slots[np.argsort(self._ids[slots])]
        self._keys = list(zip(self._h1[slots].tolist(),
                              self._h2[slots].tolist(),
                              self._h3[slots].tolist()))
        self._key_map = None
        self._next_id = n
        self._published = n
        size = max(1024, n)
        self._id_pid = np.empty(size, np.int32)
        self._id_pid[:n] = np.asarray(arrays["id_pid"])[:n]
        self._loc_off = np.zeros(size + 1, np.int64)
        self._loc_off[:n + 1] = np.asarray(arrays["loc_off"])[:n + 1]
        nl = int(self._loc_off[n])
        self._loc_flat = np.empty(max(4096, nl), np.int32)
        self._loc_flat[:nl] = np.asarray(arrays["loc_flat"])[:nl]
        self._id_h1 = np.empty(size, np.uint32)
        self._id_h1[:n] = np.asarray(arrays["id_h1"])[:n]
        self._id_h2 = np.empty(size, np.uint32)
        self._id_h2[:n] = np.asarray(arrays["id_h2"])[:n]
        self._last_seen = np.zeros(self._id_cap, np.int32)
        ls = np.asarray(arrays["last_seen"], np.int32)[:self._id_cap]
        self._last_seen[:len(ls)] = ls
        self.stats["windows"] = int(arrays.get("windows",
                                               self.stats["windows"]))
        self._pids = {}
        for pid, r in arrays["registries"].items():
            mappings = [ProfileMapping(id=int(m[0]), start=int(m[1]),
                                       end=int(m[2]), offset=int(m[3]),
                                       path=m[4], build_id=m[5],
                                       base=int(m[6]))
                        for m in r["mappings"]]
            addrs = [int(a) for a in r["loc_address"]]
            self._pids[int(pid)] = _PidRegistry(
                addr_to_loc=dict(zip(addrs, range(1, len(addrs) + 1))),
                loc_address=addrs,
                loc_normalized=[int(a) for a in r["loc_normalized"]],
                loc_mapping_id=[int(a) for a in r["loc_mapping_id"]],
                loc_is_kernel=[bool(a) for a in r["loc_is_kernel"]],
                mappings=mappings,
                mapping_index={(m.start, m.end, m.offset): m.id
                               for m in mappings})
        self._reg_version += 1
        self._unreachable = {(int(a), int(b), int(c)): int(sid)
                             for a, b, c, sid in arrays["unreachable"]}
        self._unreach_h1 = None
        self._load_sketch_state(arrays)
        # The device twin follows the mirror; the accumulators, the
        # width/delta history, the carry cache and the open window start
        # fresh.
        self._carry_reset()
        self._dev = None
        self._ensure_device()
        self._acc = self._acc_spare = None
        self._touch = self._touch_spare = None
        self._prev_counts = None
        self._prev_n_over = 0
        self._prev_touched = None
        self.discard_open_window()

    def _load_sketch_state(self, arrays: dict) -> None:
        """The bounded-memory half of load_state (absent keys: none of it,
        as a state taken before anything overflowed)."""
        cm, hll = arrays.get("cm"), arrays.get("over_hll")
        spec = self._cm_spec
        if cm is not None and np.shape(cm) != (spec.depth, spec.width):
            raise ValueError(f"state count-min table is {np.shape(cm)}, "
                             f"this dictionary's ({spec.depth}, "
                             f"{spec.width})")
        if hll is not None and len(hll) != _HLL_SPEC.m:
            raise ValueError(f"state HLL has {len(hll)} registers, this "
                             f"dictionary {_HLL_SPEC.m}")
        self._cm = None if cm is None else np.array(cm, np.int64)
        self._over_hll = None if hll is None else np.array(hll, np.int32)
        self._rotate_pending = bool(arrays.get("rotate_pending", False))
        self._invalidate_pending = {
            int(p) for p in arrays.get("invalidate_pending", ())}
        for k in _SKETCH_STATS:
            self.stats.pop(k, None)
        self.stats.update({k: int(v) for k, v in
                           arrays.get("sketch_stats", {}).items()
                           if k in _SKETCH_STATS})

    def _require_boundary(self, what: str) -> None:
        if self._close_handle is not None or self._miss_inflight is not None:
            raise RuntimeError(f"{what} needs a window boundary (settle the "
                               "open feed and collect the close first)")

    # -- streaming window protocol -------------------------------------------
    #
    # Capture drains arrive once a second, each drain is fed to the device
    # as it lands (H2D + probe kernel ride the otherwise-idle window, as the
    # reference's BPF map absorbs samples in-kernel during the window,
    # bpf/cpu/cpu.bpf.c:110-116), and window close only packs + fetches the
    # accumulated counts. window_counts() remains the one-shot batch path.

    def feed(self, snapshot: WindowSnapshot, hashes=None,
             lo: int = 0, hi: int | None = None) -> None:
        """Accumulate snapshot rows [lo, hi) into the open window.

        ``hashes`` is the capture-carried identity triple (h1, h2, h3)
        over ALL snapshot rows; None self-hashes here."""
        hi = len(snapshot) if hi is None else hi
        n = hi - lo
        if n <= 0:
            return
        # Settle the PREVIOUS feed's deferred miss check first: miss
        # resolution (= id assignment) must stay in feed order.
        self._settle_misses()
        self.timings.pop("feed_carry", None)
        chunk_total = int(snapshot.counts[lo:hi].sum())
        if self._fed_total + self._carry_open_mass + chunk_total >= 2**31:
            raise ValueError("window sample total exceeds int32")
        if self._needs_reset:
            # First feed of a new window: the boundary where cold-id
            # rotation (and any deferred pid invalidation) is safe —
            # nothing live indexes stack ids.
            self._apply_pending_invalidations()
            self._maybe_rotate()
        # Dispatch-row state: `rows_map` maps each dispatch row back to
        # a representative snapshot row (absolute index) for miss
        # resolution; `w64` carries its exact (possibly folded) mass.
        # Carry matches and coalesce folds below filter/fold both in
        # lockstep with the hash lanes.
        w64 = np.asarray(snapshot.counts[lo:hi], np.int64)
        rows_map = np.arange(lo, hi, dtype=np.int64)
        # Coalescing: dedupe the batch into (stack, weight) pairs BEFORE
        # packing, so dispatch rows track unique stacks, not sample rows.
        # First-occurrence ordered, so miss order — and therefore id
        # assignment and pprof bytes — is that of the unfolded stream.
        if hashes is not None:
            h1, h2, h3 = hashes
            h1c = np.asarray(h1[lo:hi], np.uint32)
            h2c = np.asarray(h2[lo:hi], np.uint32)
            h3c = np.asarray(h3[lo:hi], np.uint32)
            h2c = self._route_hashes(h1c, h2c, h3c, snapshot.pids[lo:hi])
            # Carry BEFORE the fold: carried rows are known stacks whose
            # mass accumulates on the host; only the remainder pays the
            # fold and the dispatch.
            keep = self._carry_match(h1c, h2c, h3c, w64)
            if keep is not None:
                h1c, h2c, h3c = h1c[keep], h2c[keep], h3c[keep]
                w64 = w64[keep]
                rows_map = rows_map[keep]
            if self._coalesce and len(h1c) > 1:
                h1c, h2c, h3c, w64, rows_map = self._coalesce_triples(
                    h1c, h2c, h3c, w64, rows_map)
        else:
            # Self-hash. The native row hash walks only each row's live
            # depth, so every row is hashed, then the batch folds by
            # triple (the order parca_agent_tpu takes with its native
            # hash), then the carry matches the representatives.
            t0 = time.perf_counter()
            sl = slice(lo, hi)
            h1c, h2c, h3c = row_hash_np(
                snapshot.stacks[sl], snapshot.pids[sl],
                snapshot.user_len[sl], snapshot.kernel_len[sl], n_hashes=3)
            h2c = self._route_hashes(h1c, h2c, h3c, snapshot.pids[sl])
            self.timings["feed_hash"] = time.perf_counter() - t0
            if self._coalesce and n > 1:
                h1c, h2c, h3c, w64, rows_map = self._coalesce_triples(
                    h1c, h2c, h3c, w64, rows_map)
            keep = self._carry_match(h1c, h2c, h3c, w64)
            if keep is not None:
                h1c, h2c, h3c = h1c[keep], h2c[keep], h3c[keep]
                w64, rows_map = w64[keep], rows_map[keep]
        if not len(h1c):
            # The whole batch carried: nothing to dispatch — its mass
            # rides the carry cache to the close flush.
            return
        counts_c = w64.astype(np.uint32)
        nd = len(h1c)
        t0 = time.perf_counter()
        counts_c, corrections = self._prefilter_unreachable(
            h1c, h2c, h3c, counts_c)
        # (corrections join _pending only after the device call succeeds,
        # mirroring the miss path: a failed feed must not leave partial
        # host-side mass that a recovery close would emit as a window.)
        n_pad = 1 << max(4, (nd - 1).bit_length())
        # LRU (dict order = recency order via pop/re-insert).
        packed = self._feed_bufs.pop(n_pad, None)
        if packed is None:
            if len(self._feed_bufs) >= 4:  # bounded cache
                self._feed_bufs.pop(next(iter(self._feed_bufs)))
            packed = np.zeros((4, n_pad), np.uint32)
        else:
            packed[:, nd:] = 0  # stale tail from a previous, larger chunk
        self._feed_bufs[n_pad] = packed
        packed[0, :nd] = h1c
        packed[1, :nd] = h2c
        packed[2, :nd] = h3c
        packed[3, :nd] = counts_c
        self.timings["feed_pack"] = time.perf_counter() - t0

        self._ensure_device()
        if self._acc is None:
            self._acc = self._new_acc()
        if self._blk and self._touch is None:
            self._touch = self._new_touch()
        t0 = time.perf_counter()
        handle = self._feed_dispatch_async(packed, self._needs_reset)
        self._needs_reset = False
        self._pending.extend(corrections)
        # _fed_total means "mass in the DEVICE accumulator" (the close
        # gate and width prediction read it); host-settled corrections
        # and carried mass are not part of it.
        self._fed_total += int(w64.sum()) - sum(c for _, c in corrections)
        # Dispatch-only cost: the miss sync is deferred to the next feed /
        # the close, where the kernel has already completed.
        self.timings["feed_dispatch"] = time.perf_counter() - t0
        self._miss_inflight = (handle, snapshot, rows_map, w64,
                               h1c, h2c, h3c)

    def _settle_misses(self) -> None:
        """Settle the deferred miss check of the last dispatched feed:
        sync the miss count, resolve any misses (insert new stacks, queue
        host-side count corrections), then admit the dispatched keys into
        the carry cache so later drains fold against them. Runs at the
        next feed and at close — always before the window's counts are
        read."""
        inflight, self._miss_inflight = self._miss_inflight, None
        if inflight is None:
            return
        handle, snapshot, rows_map, w64, h1d, h2d, h3d = inflight
        t0 = time.perf_counter()
        miss_rel = self._settle_dispatch(handle)
        self.timings["feed_settle"] = time.perf_counter() - t0
        if len(miss_rel):
            t0 = time.perf_counter()
            self._pending.extend(self._resolve_misses(
                snapshot, rows_map[miss_rel], h1d[miss_rel],
                h2d[miss_rel], h3d[miss_rel], w64[miss_rel]))
            self.timings["feed_miss"] = time.perf_counter() - t0
        if self._carry and not self._carry_disabled:
            t0 = time.perf_counter()
            self._carry_admit(h1d, h2d, h3d)
            self.timings["feed_carry"] = \
                self.timings.get("feed_carry", 0.0) \
                + (time.perf_counter() - t0)

    def _route_hashes(self, h1, h2, h3, pids):
        """Rewrite hook for identity triples computed outside hash_rows
        (capture-carried hashes, the feed's own row hash): an
        aggregator that re-routes identity lanes applies the same rewrite
        here so carried and self-hashed triples agree bit for bit.
        Returns the (possibly rewritten) h2 lane: the sharded dictionary
        (aggregator/sharded.py) rewrites its shard residue here."""
        return h2

    def _coalesce_triples(self, h1c, h2c, h3c, w64, rows_map):
        """Coalesce dispatch rows to (stack, weight) pairs on the
        (h1, h2, h3) identity, first-occurrence ordered. A fold failure
        (chaos site feed.coalesce) is counted and degrades to the
        unfolded batch, never a lost feed."""
        n = len(h1c)
        t0 = time.perf_counter()
        try:
            faults.inject("feed.coalesce")
            key = np.empty((n, 3), np.uint32)
            key[:, 0] = h1c
            key[:, 1] = h2c
            key[:, 2] = h3c
            folded = fold_rows_first_seen(
                key.view(np.dtype((np.void, 12))).ravel(), w64)
            if folded is not None:
                rep, _inv, fw = folded
                h1c, h2c, h3c = h1c[rep], h2c[rep], h3c[rep]
                w64 = fw
                rows_map = rows_map[rep]
            self.stats["coalesce_rows_in"] = \
                self.stats.get("coalesce_rows_in", 0) + n
            self.stats["coalesce_rows_out"] = \
                self.stats.get("coalesce_rows_out", 0) + len(h1c)
        except Exception as e:  # noqa: BLE001 - counted fallback
            # Locals are only rebound on success above, so the input
            # rows are intact: the batch dispatches unfolded.
            self.stats["coalesce_fallbacks"] = \
                self.stats.get("coalesce_fallbacks", 0) + 1
            _log.warn("feed coalesce failed; dispatching the uncoalesced "
                      "batch", error=repr(e)[:200])
        self.timings["feed_coalesce"] = time.perf_counter() - t0
        return h1c, h2c, h3c, w64, rows_map

    # -- cross-drain carry cache ---------------------------------------------

    def _carry_lookup(self, h1c: np.ndarray) -> np.ndarray:
        """Position of each needle's h1 in the cache, or -1: a bucket walk
        (each needle scans its prefix bucket — sorted, h1-unique, load
        <= 0.5, so almost always one probe — with the still-unresolved
        subset shrinking each pass)."""
        pref = (h1c >> self._carry_shift).astype(np.int64)
        cur = self._carry_starts[pref]
        end = self._carry_starts[pref + 1]
        pos = np.full(len(h1c), -1, np.int64)
        act = np.flatnonzero(cur < end)
        while len(act):
            c = cur[act]
            cand = self._carry_h1[c]
            eq = cand == h1c[act]
            pos[act[eq]] = c[eq]
            # Bucket entries are ascending: passing the needle's value
            # ends its scan (absent key).
            more = ~eq & (cand < h1c[act])
            act = act[more]
            cur[act] += 1
            act = act[cur[act] < end[act]]
        return pos

    def _carry_match(self, h1c, h2c, h3c, w64):
        """Cross-drain fold: batch rows whose keys already sit in the
        carry cache accumulate their mass on the host instead of shipping
        dispatch rows. Returns the keep mask (False = carried) or None
        when nothing matched. A match failure is counted and turns
        matching off until the window boundary: the batch dispatches
        whole and mass already carried still flushes at close, so counts
        stay exact."""
        if not self._carry or self._carry_disabled \
                or not len(self._carry_h1) or not len(h1c):
            return None
        t0 = time.perf_counter()
        try:
            faults.inject("feed.carry")
            pos = self._carry_lookup(h1c)
            hit = pos >= 0
            if hit.all():
                # Steady state (every row a candidate): the verify runs
                # without sub-index gathers.
                hit = ((self._carry_h2[pos] == h2c)
                       & (self._carry_h3[pos] == h3c))
            elif hit.any():
                sub = np.flatnonzero(hit)
                e = pos[sub]
                ok = ((self._carry_h2[e] == h2c[sub])
                      & (self._carry_h3[e] == h3c[sub]))
                hit[sub[~ok]] = False  # h1 collision: not cached
            self.stats["carry_rows_in"] = \
                self.stats.get("carry_rows_in", 0) + len(h1c)
            n_hit = int(hit.sum())
            if not n_hit:
                return None
            if n_hit == len(hit):
                eidx, w = pos, w64
            else:
                eidx, w = pos[hit], w64[hit]
            # float64 bincount is exact below 2^53 total mass (window
            # mass < 2^31).
            add = np.bincount(eidx, weights=w.astype(np.float64),
                              minlength=len(self._carry_w)).astype(
                                  np.int64)
            carried = int(w.sum())
            self.stats["carry_hits"] = \
                self.stats.get("carry_hits", 0) + n_hit
            self.stats["carry_mass"] = \
                self.stats.get("carry_mass", 0) + carried
            # Mutate LAST: an exception past this point could not be
            # failed open without double-counting the batch.
            self._carry_w += add
            self._carry_open_mass += carried
            return ~hit
        except Exception as e:  # noqa: BLE001 - counted, exact either way
            self._carry_disabled = True
            self.stats["carry_fallbacks"] = \
                self.stats.get("carry_fallbacks", 0) + 1
            _log.warn("feed carry match failed; dispatching per drain for "
                      "the rest of the window", error=repr(e)[:200])
            return None
        finally:
            self.timings["feed_carry"] = \
                self.timings.get("feed_carry", 0.0) \
                + (time.perf_counter() - t0)

    def _carry_admit(self, h1d, h2d, h3d) -> None:
        """Admit a dispatch's keys into the carry cache. h1 stays UNIQUE
        in the cache (a same-h1 different-key collision keeps dispatching
        per drain — exact either way), and only keys with live ids in the
        host mirror are admitted: sketch-absorbed overflow keys keep
        riding the sketch, never an exact host-side flush. Runs after
        miss resolution, so a drain's new inserts are admitted at once."""
        if not len(h1d):
            return
        u, ui = np.unique(h1d, return_index=True)
        if len(self._carry_h1):
            pos = np.minimum(np.searchsorted(self._carry_h1, u),
                             len(self._carry_h1) - 1)
            fresh = self._carry_h1[pos] != u
            u, ui = u[fresh], ui[fresh]
        if not len(u):
            return
        h1n = np.ascontiguousarray(h1d[ui], np.uint32)
        h2n = np.ascontiguousarray(h2d[ui], np.uint32)
        h3n = np.ascontiguousarray(h3d[ui], np.uint32)
        ids, _stop, overrun = self._classify_keys_vec(h1n, h2n, h3n)
        if overrun:
            return  # wrapped probe chain: skip admission this drain
        ok = ids >= 0
        n_new = int(ok.sum())
        if not n_new:
            return
        nh1 = np.concatenate([self._carry_h1, h1n[ok]])
        order = np.argsort(nh1, kind="stable")
        self._carry_h1 = nh1[order]
        self._carry_h2 = np.concatenate([self._carry_h2, h2n[ok]])[order]
        self._carry_h3 = np.concatenate([self._carry_h3, h3n[ok]])[order]
        self._carry_sid = np.concatenate(
            [self._carry_sid, ids[ok]])[order]
        self._carry_w = np.concatenate(
            [self._carry_w, np.zeros(n_new, np.int64)])[order]
        self._carry_reindex()
        self.stats["carry_admitted"] = \
            self.stats.get("carry_admitted", 0) + n_new
        self.stats["carry_entries"] = len(self._carry_h1)

    def _carry_reindex(self) -> None:
        """Rebuild the prefix-bucket index (~2 buckets per entry, clamped
        to [2^12, 2^22])."""
        n = len(self._carry_h1)
        k = max(12, min(22, int(2 * n - 1).bit_length()))
        self._carry_shift = 32 - k
        counts = np.bincount(
            (self._carry_h1 >> self._carry_shift).astype(np.int64),
            minlength=1 << k)
        starts = np.zeros((1 << k) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        self._carry_starts = starts

    def _carry_take(self):
        """Flush the open window's carried mass: (sids, counts) int64
        arrays, or (None, None) when nothing was carried. Zeroes the
        accumulated weights and re-arms matching — this is the window
        boundary, and carried corrections must never leak across it."""
        self._carry_disabled = False
        if not self._carry_open_mass:
            return None, None
        nz = np.flatnonzero(self._carry_w)
        sids = self._carry_sid[nz].copy()
        cnts = self._carry_w[nz].copy()
        self._carry_w[nz] = 0
        self._carry_open_mass = 0
        self.stats["carry_flushes"] = \
            self.stats.get("carry_flushes", 0) + 1
        return sids, cnts

    def _carry_reset(self) -> None:
        """Drop every cache entry: they map keys to an id space that is
        gone (live keys re-admit at their next dispatch)."""
        self._carry_h1 = np.zeros(0, np.uint32)
        self._carry_h2 = np.zeros(0, np.uint32)
        self._carry_h3 = np.zeros(0, np.uint32)
        self._carry_sid = np.zeros(0, np.int64)
        self._carry_w = np.zeros(0, np.int64)
        self._carry_shift = 32
        self._carry_starts = np.zeros(2, np.int64)

    # -- device hooks --------------------------------------------------------

    def _new_acc(self) -> torch.Tensor:
        return torch.zeros(self._id_cap, dtype=torch.int32,
                           device=self.device)

    def _new_touch(self) -> torch.Tensor:
        return torch.zeros(self._n_blocks, dtype=torch.int32,
                           device=self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host numpy -> device tensor; uint32 crosses as int32 bits. A
        device wait: a pageable upload syncs the stream."""
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        with device_wait():
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _feed_dispatch_async(self, packed: np.ndarray, reset: bool):
        """Launch the feed over the device state WITHOUT a host sync;
        returns the (n_miss, miss_rows) device handle for
        _settle_dispatch. Telemetry records the upload and launch's host
        time under the feed's shape signature, and the packed bytes."""
        t0 = time.perf_counter()
        out = feed_step(self._dev, self._acc,
                        self._touch if self._blk else None, self._blk,
                        self._to_device(packed), reset)
        dtel.record("feed_probe", time.perf_counter() - t0,
                    shape=(self._cap, self._id_cap, packed.shape[1],
                           self._n_blocks, self._blk),
                    h2d_bytes=packed.nbytes)
        return out

    def _settle_dispatch(self, handle) -> np.ndarray:
        """Sync one dispatched feed's miss outputs; returns chunk-relative
        miss row indices (empty in steady state). The n_miss read is the
        feed's one device sync point."""
        n_miss, miss_rows = handle
        with device_wait():
            nm = int(n_miss.item())
            if not nm:
                return np.empty(0, np.int64)
            rows = miss_rows[:nm].cpu()
        return rows.numpy().astype(np.int64)

    def _close_pack_dispatch(self, acc, n_fetch: int, width: int,
                             n_over_buf: int):
        """Launch the full close pack (no host sync)."""
        t0 = time.perf_counter()
        out = close_pack(acc, n_fetch, width, n_over_buf)
        dtel.record("close_pack", time.perf_counter() - t0,
                    shape=(self._id_cap, n_fetch, width, n_over_buf))
        return out

    def _close_pack_collect(self, out_dev) -> np.ndarray:
        """Fetch a dispatched close pack's buffer (uint32)."""
        t0 = time.perf_counter()
        with device_wait():
            host = out_dev.cpu().numpy().view(np.uint32)
        # Execute-only (shape=None): the fetch is a collect, not a
        # launch; the pack's signatures carry the first-launch latch.
        dtel.record("close_fetch", time.perf_counter() - t0,
                    d2h_bytes=host.nbytes)
        return host

    def _close_delta_dispatch(self, acc, touch, n_fetch: int, width: int,
                              n_over_buf: int, n_blk_buf: int):
        """Launch the delta close pack (no host sync)."""
        t0 = time.perf_counter()
        out = close_pack_delta(acc, touch, n_fetch, width, n_over_buf,
                               n_blk_buf, self._blk)
        dtel.record("close_delta", time.perf_counter() - t0,
                    shape=(self._id_cap, n_fetch, width, n_over_buf,
                           n_blk_buf, self._blk))
        return out

    def _ensure_device(self) -> None:
        if self._dev is None:
            table = np.zeros((self._cap, 4), np.uint32)
            table[:, 0] = self._h1
            table[:, 1] = self._h2
            table[:, 2] = self._h3
            table[:, 3] = np.where(self._occ, self._ids + 1,
                                   0).astype(np.uint32)
            self._dev = self._to_device(table)

    def _dev_scatter(self, slots: np.ndarray, vals: np.ndarray) -> None:
        """Write newly inserted rows into the device table."""
        slots = np.asarray(slots, np.int64)
        self._dev[self._to_device(slots)] = self._to_device(vals)
        dtel.transfer("miss_settle", "h2d", slots.nbytes + vals.nbytes)

    # -- close ---------------------------------------------------------------

    def _pick_close_width(self) -> int:
        """Packing width for this close: the narrowest that provably (from
        the fed total) or predictably (from the last window's stationary
        count distribution) keeps the overflow sideband within bounds. A
        misprediction is detected and retried wider — never lossy."""
        total = self._fed_total
        if total // 15 <= _CLOSE_OVERS[4] // 2:
            return 4
        if self._prev_counts is not None and total // 255 <= _CLOSE_OVERS[8]:
            if int((self._prev_counts > 14).sum()) <= _CLOSE_OVERS[4] // 2:
                return 4
        if total // 255 <= _CLOSE_OVERS[8]:
            return 8
        return 16

    def close_window(self, copy: bool = True) -> np.ndarray:
        """Finish the open window: exact int64 counts indexed by stack id
        (length == number of stacks known after this window).
        close_dispatch() + close_collect(); copy=False returns a view into
        a double-buffered reusable allocation, valid through the NEXT
        close."""
        return self.close_collect(self.close_dispatch(), copy=copy)

    def close_dispatch(self) -> "_CloseHandle | None":
        """First half of the window close: settle deferred feed misses,
        launch the pack against the open accumulator (no host sync), and
        FLIP the double buffers — from here on, feeds belong to the next
        window. Returns None for an empty window (nothing fed, nothing
        pending) after counting it."""
        if self._close_handle is not None:
            raise RuntimeError("previous close not collected")
        self._settle_misses()
        carry_sids, carry_cnts = self._carry_take()
        if self._fed_total == 0 and not self._pending \
                and carry_sids is None:
            self.stats["windows"] += 1
            self.timings.pop("buffer_flip", None)
            self.timings.pop("delta_fetch", None)
            return None
        h = _CloseHandle()
        h.pending, self._pending = self._pending, []
        if carry_sids is not None:
            h.pending_vec = (carry_sids, carry_cnts)
        h.n_ids = self._next_id
        if self._acc is not None and self._fed_total:
            h.acc = self._acc
            h.touch = self._touch
            grain = 1 << 18
            h.n_fetch = min(self._id_cap,
                            max(grain, -(-h.n_ids // grain) * grain))
            h.width = self._pick_close_width()
            # Predictive sideband: cover 2x the previous window's overflow
            # population, floored at _OVER_MIN; a misprediction is caught
            # by the n_over counter and retried larger. A delta close
            # shrinks the floor 8x (and caps at the fetched row count).
            h.delta_blks = self._delta_plan(h.n_fetch)
            predicted = max(_OVER_MIN, 2 * self._prev_n_over)
            if h.delta_blks:
                predicted = min(max(_OVER_MIN // 8, 2 * self._prev_n_over),
                                h.delta_blks * self._blk)
            h.n_over_buf = min(_CLOSE_OVERS[h.width],
                               1 << (predicted - 1).bit_length())
            t0 = time.perf_counter()
            if h.delta_blks:
                h.out_dev = self._close_delta_dispatch(
                    h.acc, h.touch, h.n_fetch, h.width, h.n_over_buf,
                    h.delta_blks)
            else:
                h.out_dev = self._close_pack_dispatch(
                    h.acc, h.n_fetch, h.width, h.n_over_buf)
            self.timings["close_dispatch"] = time.perf_counter() - t0
        # The flip: the closed window's buffers stay intact inside the
        # handle (retries re-pack them); the next window's first feed
        # resets the flipped-in twin on the device.
        t0 = time.perf_counter()
        self._acc, self._acc_spare = self._acc_spare, self._acc
        self._touch, self._touch_spare = self._touch_spare, self._touch
        self._fed_total = 0
        self._needs_reset = True
        self.stats["buffer_flips"] = self.stats.get("buffer_flips", 0) + 1
        self.timings["buffer_flip"] = time.perf_counter() - t0
        self._close_handle = h
        return h

    def _delta_plan(self, n_fetch: int) -> int:
        """Blocks to fetch for a delta close, or 0 for a full fetch.
        Sized predictively at 2x the previous window's touched-block
        population (floor 8 blocks); delta engages only when that moves
        less than _DELTA_MAX_FRAC of the full fetch's rows."""
        if not self._blk or self._touch is None \
                or self._prev_touched is None:
            return 0
        nb_prefix = n_fetch // self._blk
        want = min(nb_prefix, max(8, 2 * self._prev_touched))
        n_blk_buf = 1 << max(0, (want - 1).bit_length())
        if n_blk_buf * self._blk > _DELTA_MAX_FRAC * n_fetch:
            return 0
        return n_blk_buf

    def close_collect(self, handle: "_CloseHandle | None",
                      copy: bool = True) -> np.ndarray:
        """Second half of the window close: fetch the packed buffer
        launched by close_dispatch, retrying against the handle's intact
        (pre-flip) accumulator on any misprediction — touched blocks
        grown first, then the full fetch as the exact fallback, then the
        sideband's grow-then-widen ladder, all lossless."""
        if handle is None:  # empty window (already counted)
            return np.zeros(self._next_id, np.int64)
        h = handle
        if h is self._close_handle:
            self._close_handle = None
        if h.acc is not None:
            n_fetch, width, n_over_buf = h.n_fetch, h.width, h.n_over_buf
            n_blk_buf = h.delta_blks
            out_dev = h.out_dev
            h.out_dev = None
            nb_prefix = n_fetch // self._blk if self._blk else 0
            t0 = time.perf_counter()
            while True:
                per32 = 32 // width
                if out_dev is None:  # a retry: re-pack the intact acc
                    if n_blk_buf:
                        out_dev = self._close_delta_dispatch(
                            h.acc, h.touch, n_fetch, width, n_over_buf,
                            n_blk_buf)
                    else:
                        out_dev = self._close_pack_dispatch(
                            h.acc, n_fetch, width, n_over_buf)
                host = self._close_pack_collect(out_dev)
                out_dev = None
                if int(host[-1]) != 0:
                    raise AssertionError("count mass beyond fetched prefix")
                if n_blk_buf:
                    n_touched = int(host[-4])
                    if int(host[-2]) != 0:
                        # Untouched-block mass: the touch tracking missed
                        # a write. Impossible by construction; degrade to
                        # the exact full fetch rather than trust it.
                        self.stats["delta_guard_trips"] = \
                            self.stats.get("delta_guard_trips", 0) + 1
                        n_blk_buf = 0
                        continue
                    if n_touched > n_blk_buf:
                        # More blocks touched than predicted: grow to the
                        # reported population, or fall back to the full
                        # fetch once delta stops being a win.
                        self.stats["delta_retries"] = \
                            self.stats.get("delta_retries", 0) + 1
                        need = 1 << max(0, (n_touched - 1).bit_length())
                        if need * self._blk > _DELTA_MAX_FRAC * n_fetch:
                            self.stats["delta_fallbacks"] = \
                                self.stats.get("delta_fallbacks", 0) + 1
                            n_blk_buf = 0
                        else:
                            n_blk_buf = need
                        continue
                n_over = int(host[-3] if n_blk_buf else host[-2])
                if n_over <= n_over_buf:
                    break
                # Sideband overran: acc is intact, retry. Grow the buffer
                # to cover the reported population first; only then go
                # wider (width 16 at the max cap cannot overrun for int32
                # totals).
                self.stats["close_retries"] = \
                    self.stats.get("close_retries", 0) + 1
                if n_over <= _CLOSE_OVERS[width]:
                    n_over_buf = 1 << (n_over - 1).bit_length()
                else:
                    width = 8 if width == 4 else 16
                    n_over_buf = _CLOSE_OVERS[width]
            self._prev_n_over = n_over
            fetch_s = time.perf_counter() - t0
            self.timings["close_fetch"] = fetch_s
            if n_blk_buf:
                self.timings["delta_fetch"] = fetch_s
            else:
                self.timings.pop("delta_fetch", None)
            t0 = time.perf_counter()
            sentinel = (1 << width) - 1
            shifts = (np.arange(per32, dtype=np.uint32) * width)[None, :]
            if n_blk_buf:
                lanes_n = n_blk_buf * self._blk // per32
                wb_key = (1, n_blk_buf * self._blk, width)
            else:
                lanes_n = n_fetch // per32
                wb_key = (0, n_fetch, width)
            lanes = host[:lanes_n]
            wb = self._unpack_bufs.get(wb_key)
            if wb is None:
                if len(self._unpack_bufs) >= 4:  # bounded: evict smallest
                    self._unpack_bufs.pop(
                        min(self._unpack_bufs,
                            key=lambda k: self._unpack_bufs[k].nbytes))
                wb = self._unpack_bufs[wb_key] = np.empty(
                    (lanes_n, per32), np.uint32)
            np.right_shift(lanes[:, None], shifts, out=wb)
            np.bitwise_and(wb, np.uint32(sentinel), out=wb)
            self._counts_flip ^= 1
            counts = self._counts_bufs[self._counts_flip]
            if counts is None or len(counts) != n_fetch:
                counts = np.empty(n_fetch, np.int64)
                self._counts_bufs[self._counts_flip] = counts
            if n_blk_buf:
                # Delta unpack: zero, then scatter the touched blocks
                # back to their id ranges (block ids ride the buffer).
                counts[:] = 0
                n_t = n_touched
                bids = host[lanes_n:lanes_n + n_blk_buf][:n_t].astype(
                    np.int64)
                idx = (bids[:, None] * self._blk
                       + np.arange(self._blk, dtype=np.int64)).reshape(-1)
                counts[idx] = wb.reshape(-1)[: n_t * self._blk]
                over_off = lanes_n + n_blk_buf
                self._prev_touched = n_t
                self.stats["delta_closes"] = \
                    self.stats.get("delta_closes", 0) + 1
                self.stats["fetch_rows_last"] = n_t * self._blk
            else:
                counts[:] = wb.reshape(-1)
                over_off = lanes_n
                self.stats["full_closes"] = \
                    self.stats.get("full_closes", 0) + 1
                self.stats["fetch_rows_last"] = n_fetch
                if self._blk and h.touch is not None:
                    # Learn the touched population from the flags (one
                    # small fetch) so the NEXT close can go delta.
                    with device_wait():
                        self._prev_touched = int(
                            (h.touch[:nb_prefix] > 0).sum().item())
            over_id = host[over_off:over_off + n_over]
            over_val = host[over_off + n_over_buf:
                            over_off + n_over_buf + n_over]
            counts[over_id] = over_val
            self.stats["fetch_bytes_last"] = int(host.nbytes)
            self.stats["fetch_bytes_total"] = \
                self.stats.get("fetch_bytes_total", 0) + int(host.nbytes)
            self.timings["close_unpack"] = time.perf_counter() - t0
        else:
            # Pending-only close (nothing fed to the device).
            self.timings.pop("delta_fetch", None)
            counts = np.zeros(max(h.n_ids, 1), np.int64)

        if h.pending:
            sids = np.array([p[0] for p in h.pending], np.int64)
            cnts = np.array([p[1] for p in h.pending], np.int64)
            np.add.at(counts, sids, cnts)
            h.pending = []
        if h.pending_vec is not None:
            # The carry flush, applied exactly once a handle (the retries
            # above re-pack the device buffers, never this).
            sids, cnts = h.pending_vec
            np.add.at(counts, sids, cnts)
            h.pending_vec = None
        self.stats["windows"] += 1
        out = counts[: h.n_ids]
        self._last_seen[np.flatnonzero(out)] = self.stats["windows"]
        self._prev_counts = out
        return out.copy() if copy else out

    # -- bounded-memory degradation ------------------------------------------

    def _sketch_add(self, hashes: np.ndarray, counts: np.ndarray) -> None:
        """Absorb overflow rows into the count-min table + HLL registers
        (host numpy; overestimate-only error per CountMinSpec)."""
        t0 = time.perf_counter()
        if self._cm is None:
            self._cm = np.zeros((self._cm_spec.depth, self._cm_spec.width),
                                np.int64)
            self._over_hll = np.zeros(_HLL_SPEC.m, np.int32)
        cm_add(self._cm, hashes, counts, self._cm_spec)
        self._over_hll = hll_merge(self._over_hll,
                                   hll_build(hashes, _HLL_SPEC))
        self.stats["sketch_rows"] = \
            self.stats.get("sketch_rows", 0) + len(hashes)
        self.stats["sketch_samples"] = \
            self.stats.get("sketch_samples", 0) + int(counts.sum())
        self.timings["sketch_absorb"] = \
            self.timings.get("sketch_absorb", 0.0) + time.perf_counter() - t0

    def sketch_estimate(self, h1_hashes) -> np.ndarray:
        """Point-query overflow-absorbed counts (CM overestimate bound);
        zeros when nothing has ever overflowed."""
        h1_hashes = np.asarray(h1_hashes, np.uint32)
        if self._cm is None:
            return np.zeros(len(h1_hashes), np.int64)
        return cm_query(self._cm, h1_hashes,
                        self._cm_spec).astype(np.int64)

    def sketch_info(self) -> dict:
        """Observable degradation state (parca_agent_tpu's keys)."""
        return {
            "sketch_rows": self.stats.get("sketch_rows", 0),
            "sketch_samples": self.stats.get("sketch_samples", 0),
            "sketch_distinct_est": (
                round(hll_estimate(self._over_hll, _HLL_SPEC))
                if self._over_hll is not None else 0),
            "rotations": self.stats.get("rotations", 0),
        }

    def _maybe_rotate(self) -> None:
        """Evict stack ids unseen for rotate_min_age windows and recycle
        their space. Runs only at a window boundary, before the new window
        touches the device, so no live accumulator, fetched counts buffer
        or profile build is ever indexed by a stale id."""
        if not self._rotate_pending:
            return
        if self._close_handle is not None or self._miss_inflight is not None:
            # An uncollected close still indexes the current id space and
            # an unsettled feed may still insert: defer to the next
            # boundary.
            return
        self._rotate_pending = False
        w = self.stats["windows"]
        n = self._next_id
        keep = (w - self._last_seen[:n]) < self._rotate_min_age
        if int(keep.sum()) == n:
            return  # nothing cold yet; stay in sketch-degraded mode
        self._compact_ids(keep)
        self.stats["rotations"] = self.stats.get("rotations", 0) + 1

    def invalidate_pid(self, pid: int) -> bool:
        """The pid was recycled: every stack id and the location registry
        it owns describe a dead predecessor, so drop them and let the new
        process's stacks register afresh. Compaction is safe only at a
        window boundary, so while a close or a deferred miss check is in
        flight the pid queues and is dropped at the next first feed of a
        window. Returns True when applied now, False when deferred."""
        pid = int(pid)
        if self._close_handle is not None or self._miss_inflight is not None:
            self._invalidate_pending.add(pid)
            return False
        self._invalidate_pending.discard(pid)
        self._drop_pids([pid])
        return True

    def _apply_pending_invalidations(self) -> None:
        """Deferred invalidate_pid drops, at the window boundary, sorted
        for a deterministic compaction order."""
        if not self._invalidate_pending:
            return
        if self._close_handle is not None or self._miss_inflight is not None:
            return
        pids = sorted(self._invalidate_pending)
        self._invalidate_pending.clear()
        self._drop_pids(pids)

    def _drop_pids(self, pids) -> None:
        n = self._next_id
        keep = ~np.isin(self._id_pid[:n],
                        np.asarray(sorted(pids), np.int64).astype(np.int32))
        for p in pids:
            self._pids.pop(int(p), None)
        # Registry content changed even when the pid owned no stack ids.
        self._reg_version += 1
        self.stats["pid_invalidations"] = \
            self.stats.get("pid_invalidations", 0) + len(pids)
        if int(keep.sum()) != n:
            self._compact_ids(keep)
            self.stats["invalidation_compactions"] = \
                self.stats.get("invalidation_compactions", 0) + 1

    def _compact_ids(self, keep: np.ndarray) -> None:
        """Remap the id space to the `keep` survivors and rebuild every
        structure keyed by stack id (shared by rotation and pid
        invalidation). Window-boundary only."""
        t0 = time.perf_counter()
        n = self._next_id
        kept = np.flatnonzero(keep)
        m = len(kept)
        # Where each survivor sits now, before anything moves.
        occ = np.flatnonzero(self._occ)
        slot_of = np.empty(n, np.int64)
        slot_of[self._ids[occ]] = occ
        old = slot_of[kept]
        gone_pids = np.unique(self._id_pid[:n][~keep])
        # Compact the ragged per-id metadata to the survivors.
        off = self._loc_off
        self._loc_flat = self._loc_flat[:off[n]][
            np.repeat(keep, np.diff(off[:n + 1]))]
        self._loc_off = np.zeros(m + 1, np.int64)
        np.cumsum(off[kept + 1] - off[kept], out=self._loc_off[1:])
        self._id_pid = self._id_pid[:n][kept].copy()
        self._id_h1 = self._id_h1[:n][kept].copy()
        self._id_h2 = self._id_h2[:n][kept].copy()
        new_last = np.zeros(self._id_cap, np.int32)
        new_last[:m] = self._last_seen[kept]
        self._last_seen = new_last
        # Rebuild the host table for the survivors, each re-inserted by
        # _probe_free in id order (within its home sub-table), as
        # parca_agent_tpu re-inserts them one by one. A key that lands
        # where it sat keeps its hashes there; vacated slots keep their
        # stale hashes.
        base, start, mask = self._probe_geometry_vec(self._id_h1,
                                                     self._id_h2)
        slots = _fcfs_place(base, start, mask)
        moved = np.flatnonzero(slots != old)
        for lane in (self._h1, self._h2, self._h3):
            lane[slots[moved]] = lane[old[moved]]
        self._occ[:] = False
        self._occ[slots] = True
        self._ids[:] = -1
        self._ids[slots] = np.arange(m, dtype=np.int32)
        # Chains change wholesale with the rebuild: the keys past the probe
        # bound, in id order.
        keys = list(compress(self._keys, keep.tolist()))
        self._unreachable = {
            keys[j]: j for j in
            np.flatnonzero(((slots - base - start) & mask)
                           >= _PROBES).tolist()}
        self._unreach_h1 = None
        self._keys = keys
        self._key_map = None
        self._next_id = m
        self._published = m
        # Per-pid registries with no surviving stacks go too (memory
        # bound); a registry is made with its pid's first stack, so only a
        # pid that lost stacks here can be left with none.
        for p in gone_pids[~np.isin(gone_pids, self._id_pid)].tolist():
            self._pids.pop(p, None)
        # The device table is rebuilt from the host mirror at the next
        # feed. Both accumulator twins and both touch twins index the old
        # id space, so they go, with the width and delta history.
        self._dev = None
        self._acc = None
        self._acc_spare = None
        self._touch = None
        self._touch_spare = None
        self._prev_touched = None
        self._prev_counts = None
        self._prev_n_over = 0
        # The carry cache maps keys to the OLD id space: drop it wholesale
        # (live keys re-admit at their next dispatch; the accumulated
        # weights are zero at a boundary).
        self._carry_reset()
        self._reg_version += 1
        self.timings["compact"] = \
            self.timings.get("compact", 0.0) + time.perf_counter() - t0

    # -- miss settle ---------------------------------------------------------

    def _resolve_misses(self, snapshot, rows, h1, h2, h3, weights=None
                        ) -> list[tuple[int, int]]:
        """Absorb device-miss rows: insert genuinely new stacks (host mirror
        + device table), and return (stack_id, count) corrections the caller
        must add to the window's counts. ``h1/h2/h3`` are MISS-ALIGNED
        lanes; ``weights`` overrides ``snapshot.counts[rows]`` (the
        coalesced feed's folded masses). Large clean batches take the
        vectorized plan-then-commit path, the rest the scalar loop."""
        rows = np.asarray(rows, np.int64)
        wts = (np.asarray(weights, np.int64) if weights is not None
               else snapshot.counts[rows].astype(np.int64))
        if len(rows) >= _VEC_MISS_MIN:
            t0 = time.perf_counter()
            out = self._resolve_misses_vec(snapshot, rows, h1, h2, h3, wts)
            if out is not None:
                # Shape class: the miss batch's power-of-two envelope.
                dtel.record("miss_settle", time.perf_counter() - t0,
                            shape=(1 << max(0, (len(rows)
                                                - 1).bit_length()),))
                return out
            self.stats["miss_vec_fallbacks"] = \
                self.stats.get("miss_vec_fallbacks", 0) + 1
        return self._resolve_misses_scalar(snapshot, rows, h1, h2, h3, wts)

    def _over_capacity(self, n_new: int) -> bool:
        worst = self._next_id + n_new
        return worst > self._id_cap or worst * 2 > self._cap

    def _resolve_misses_scalar(self, snapshot, rows, h1, h2, h3, wts
                               ) -> list[tuple[int, int]]:
        """The reference miss loop; it owns every degradation case (the
        capacity raise, the sketch absorb, the rotation request). Classify
        first, mutate second: capacity is checked against the ACTUAL
        number of new keys before anything is inserted."""
        classified: list[tuple[int, int, tuple, int | None]] = []
        n_new = 0
        seen_batch: set = set()
        key_to_id = self._key_to_id
        for pos, r in enumerate(map(int, rows)):
            key = (int(h1[pos]), int(h2[pos]), int(h3[pos]))
            existing = key_to_id.get(key)
            if existing is None and key not in seen_batch:
                seen_batch.add(key)
                n_new += 1
            classified.append((pos, r, key, existing))
        budget = n_new
        if self._over_capacity(n_new):
            if self._overflow == "raise":
                raise RuntimeError(
                    f"stack dictionary capacity exhausted "
                    f"({self._next_id} ids + {n_new} new stacks vs "
                    f"id_cap {self._id_cap}, table {self._cap}); "
                    f"construct with a larger capacity")
            # Degrade instead of dying: insert what fits, absorb the rest
            # into the count-min/HLL sideband, and ask for a cold-stack
            # rotation at the next window boundary.
            budget = max(0, min(self._id_cap, self._cap // 2) - self._next_id)
            self._rotate_pending = True
        # Subclass room validation (a sharded table's per-sub-table
        # occupancy), before any mutation, so a raise leaves the state
        # whole.
        self._check_insert_room(classified, seen_batch)

        new_slots: list[int] = []
        new_rows: list[int] = []
        absorb_h: list[int] = []
        absorb_c: list[int] = []
        pending: list[tuple[int, int]] = []  # (sid, count) corrections
        for pos, r, key, existing in classified:
            w = int(wts[pos])
            if existing is None:
                existing = key_to_id.get(key)  # set earlier this loop?
            if existing is not None:
                # Probe-bound overflow on device; host resolves it.
                self.stats["overflow_misses"] += 1
                pending.append((existing, w))
                continue
            if budget <= 0:
                absorb_h.append(key[0])
                absorb_c.append(w)
                continue
            slot = self._try_insert_slot(key)
            if slot is None:
                # No room for this key where it must live (a sharded
                # table's full home sub-table) though the global budget
                # allows it: degrade as at budget exhaustion. Raise mode
                # never gets here: _check_insert_room raised before.
                self._rotate_pending = True
                absorb_h.append(key[0])
                absorb_c.append(w)
                continue
            budget -= 1
            sid = self._next_id
            self._next_id += 1
            key_to_id[key] = sid
            self._keys.append(key)
            self._occ[slot] = True
            self._h1[slot], self._h2[slot], self._h3[slot] = key
            self._ids[slot] = sid
            self._mark_if_unreachable(key, slot, sid)
            self._last_seen[sid] = self.stats["windows"] + 1
            new_slots.append(slot)
            new_rows.append(r)
            pending.append((sid, w))
            self.stats["inserts"] += 1

        if absorb_h:
            self._sketch_add(np.array(absorb_h, np.uint32),
                             np.array(absorb_c, np.int64))

        if new_slots:
            base = self._next_id - len(new_slots)
            self._grow_id_hashes(base)
            self._id_h1[base:self._next_id] = self._h1[new_slots]
            self._id_h2[base:self._next_id] = self._h2[new_slots]
            self._register_stacks_bulk(snapshot, np.array(new_rows, np.int64))
            slots = np.array(new_slots, np.int64)
            vals = np.zeros((len(new_slots), 4), np.uint32)
            vals[:, 0] = self._h1[new_slots]
            vals[:, 1] = self._h2[new_slots]
            vals[:, 2] = self._h3[new_slots]
            vals[:, 3] = (self._ids[new_slots] + 1).astype(np.uint32)
            self._dev_scatter(slots, vals)
        return pending

    def _grow_id_hashes(self, keep: int) -> None:
        """Grow the per-id hash mirrors to hold [0, _next_id), copying
        the first `keep` lanes."""
        if self._next_id <= len(self._id_h1):
            return
        for name in ("_id_h1", "_id_h2"):
            old = getattr(self, name)
            grown = np.empty(max(self._next_id, 2 * len(old)), np.uint32)
            grown[:keep] = old[:keep]
            setattr(self, name, grown)

    # The first window of a cold population resolves 100k+ misses; the
    # scalar loop above pays per-row Python. The vectorized twin PLANS with
    # pure array reads (classification probe + first-empty-slot arbitration
    # over the host mirror), then COMMITS the whole batch as one vectorized
    # registry append. An arbitration overrun falls back to the scalar
    # loop BEFORE any mutation.

    def _probe_geometry_vec(self, h1u, h2u):
        """(base, start, mask) per key for the vectorized host-mirror
        probe: slot(k) = base + ((start + k) & mask). The base table
        probes the whole table from h1 & mask."""
        mask = self._cap - 1
        return (np.zeros(len(h1u), np.int64),
                h1u.astype(np.int64) & mask, mask)

    def _check_insert_room_vec(self, h1n, h2n, h3n) -> None:
        """Vectorized twin of _check_insert_room (before any mutation,
        may raise). Nothing to check here: the global capacity gate
        already ran."""

    def _classify_keys_vec(self, h1u, h2u, h3u):
        """Probe every unique key against the host mirror in lockstep:
        returns (ids, stop, overrun) — ids[j] >= 0 for a known key,
        stop[j] = first empty slot on a new key's chain, overrun True
        when any chain wrapped a full (sub-)table (caller falls back)."""
        base, start, mask = self._probe_geometry_vec(h1u, h2u)
        m = len(h1u)
        ids = np.full(m, -1, np.int64)
        stop = np.full(m, -1, np.int64)
        alive = np.arange(m, dtype=np.int64)
        k = 0
        while len(alive):
            if k > mask:
                return ids, stop, True
            idx = base[alive] + ((start[alive] + k) & mask)
            occ = self._occ[idx]
            empty = np.flatnonzero(~occ)
            stop[alive[empty]] = idx[empty]
            hit = occ & (self._h1[idx] == h1u[alive]) \
                & (self._h2[idx] == h2u[alive]) \
                & (self._h3[idx] == h3u[alive])
            hsel = np.flatnonzero(hit)
            ids[alive[hsel]] = self._ids[idx[hsel]]
            alive = alive[occ & ~hit]
            k += 1
        return ids, stop, False

    def _place_new_keys_vec(self, h1n, h2n, stop):
        """First-empty-slot arbitration for a batch of new keys: every
        key starts at its chain's first pre-batch empty slot; contested
        slots go to the lowest batch rank and losers walk forward past
        slots occupied pre-batch or claimed this batch. The result is a
        valid linear-probe layout. Returns slots, or None on overrun
        (caller falls back to scalar)."""
        base, start, mask = self._probe_geometry_vec(h1n, h2n)
        n = len(h1n)
        slots = stop.copy()
        off = (slots - base - start) & mask
        overlay = np.zeros(self._cap, bool)  # slots claimed this batch
        unplaced = np.arange(n, dtype=np.int64)
        rounds = 0
        while len(unplaced):
            rounds += 1
            if rounds > 64 + 4 * _PROBES:
                return None
            s = slots[unplaced]
            order = np.lexsort((unplaced, s))
            ss = s[order]
            firsts = np.ones(len(order), bool)
            firsts[1:] = ss[1:] != ss[:-1]
            win = unplaced[order[firsts]]
            overlay[slots[win]] = True
            unplaced = unplaced[order[~firsts]]
            active = unplaced
            while len(active):
                off[active] += 1
                if int(off[active].max(initial=0)) > mask:
                    return None
                nxt = base[active] + ((start[active] + off[active]) & mask)
                slots[active] = nxt
                blocked = self._occ[nxt] | overlay[nxt]
                active = active[blocked]
        return slots

    def _resolve_misses_vec(self, snapshot, rows, h1, h2, h3, wts):
        """Plan-then-commit vectorized twin of the scalar miss loop.
        Returns the pending corrections, or None to fall back (nothing
        mutated). Id assignment stays in first-occurrence row order, so
        output bytes are identical to the scalar path's."""
        h1m = np.ascontiguousarray(h1, np.uint32)
        h2m = np.ascontiguousarray(h2, np.uint32)
        h3m = np.ascontiguousarray(h3, np.uint32)
        key = np.empty((len(rows), 3), np.uint32)
        key[:, 0] = h1m
        key[:, 1] = h2m
        key[:, 2] = h3m
        folded = fold_rows_first_seen(
            key.view(np.dtype((np.void, 12))).ravel(), wts)
        if folded is None:
            urep = np.arange(len(rows), dtype=np.int64)
            uw = wts
            row_mult = None  # every unique key came from exactly one row
        else:
            urep, inv, uw = folded
            row_mult = np.bincount(inv, minlength=len(urep))
        h1u, h2u, h3u = h1m[urep], h2m[urep], h3m[urep]
        ids, stop, overrun = self._classify_keys_vec(h1u, h2u, h3u)
        if overrun:
            return None
        new = np.flatnonzero(ids < 0)
        n_new = len(new)
        pending: list[tuple[int, int]] = []
        if n_new:
            if self._over_capacity(n_new):
                return None  # degradation: the scalar loop owns it
            h1n, h2n, h3n = h1u[new], h2u[new], h3u[new]
            # Subclass room validation before any mutation (a sharded
            # table under "raise").
            self._check_insert_room_vec(h1n, h2n, h3n)
            slots = self._place_new_keys_vec(h1n, h2n, stop[new])
            if slots is None:
                return None
            # -- commit (mirrors the scalar tail, batch-at-once) --------
            base_sid = self._next_id
            sids = np.arange(base_sid, base_sid + n_new, dtype=np.int64)
            self._next_id = base_sid + n_new
            keys = list(zip(h1n.tolist(), h2n.tolist(), h3n.tolist()))
            self._key_to_id.update(zip(keys, sids.tolist()))
            self._keys.extend(keys)
            self._occ[slots] = True
            self._h1[slots] = h1n
            self._h2[slots] = h2n
            self._h3[slots] = h3n
            self._ids[slots] = sids
            gbase, gstart, gmask = self._probe_geometry_vec(h1n, h2n)
            dist = (slots - gbase - gstart) & gmask
            for j in np.flatnonzero(dist >= _PROBES):
                self._unreachable[keys[int(j)]] = int(sids[j])
                self._unreach_h1 = None
            self._last_seen[sids] = self.stats["windows"] + 1
            self.stats["inserts"] += n_new
            self.stats["miss_vec_inserts"] = \
                self.stats.get("miss_vec_inserts", 0) + n_new
            self._grow_id_hashes(base_sid)
            self._id_h1[base_sid:self._next_id] = h1n
            self._id_h2[base_sid:self._next_id] = h2n
            self._register_stacks_bulk(snapshot, rows[urep[new]])
            vals = np.zeros((n_new, 4), np.uint32)
            vals[:, 0] = h1n
            vals[:, 1] = h2n
            vals[:, 2] = h3n
            vals[:, 3] = (sids + 1).astype(np.uint32)
            self._dev_scatter(slots, vals)
            pending.extend(zip(sids.tolist(), uw[new].tolist()))
            if row_mult is not None:
                # The scalar loop counts every duplicate row of a key
                # inserted earlier in the same batch as an overflow miss;
                # the fold collapsed those rows — count them back.
                self.stats["overflow_misses"] += \
                    int((row_mult[new] - 1).sum())
        exist = np.flatnonzero(ids >= 0)
        if len(exist):
            # Counted per MISS ROW (folded multiplicity), matching the
            # scalar loop's meaning exactly.
            self.stats["overflow_misses"] += (
                int(row_mult[exist].sum()) if row_mult is not None
                else len(exist))
            pending.extend(zip(ids[exist].tolist(),
                               uw[exist].astype(np.int64).tolist()))
        return pending

    def _check_insert_room(self, classified, seen_batch) -> None:
        """Room validation before any mutation, for subclasses with
        placement rules beyond the global capacity check (none here)."""

    def _try_insert_slot(self, key: tuple) -> int | None:
        """Slot for a new key, or None when it cannot be placed (a
        subclass's placement rule). The base table always has one: the
        global capacity check leaves a free slot."""
        return self._host_insert_slot(key)

    def _host_insert_slot(self, key: tuple) -> int:
        # Capacity was validated batch-wide by the caller. A key landing
        # beyond the device probe bound is recorded by the CALLER in
        # _unreachable so later windows short-circuit it host-side.
        return _probe_free(self._occ, key[0] & (self._cap - 1))

    def _chain_dist(self, key: tuple, slot: int) -> int:
        """Position of `slot` on the key's probe chain (0 = home)."""
        mask = self._cap - 1
        return (slot - (key[0] & mask)) & mask

    def _mark_if_unreachable(self, key: tuple, slot: int, sid: int) -> None:
        """Keys at probe-chain positions the device lookup cannot reach
        (>= _PROBES) would miss on EVERY window; register them so the feed
        path settles them host-side before shipping."""
        if self._chain_dist(key, slot) >= _PROBES:
            self._unreachable[key] = sid
            self._unreach_h1 = None  # sorted-cache invalidated

    def _prefilter_unreachable(self, h1c, h2c, h3c, counts_c):
        """Zero out rows whose keys the device probe bound cannot reach,
        returning (filtered_counts, [(sid, count) corrections]). The
        candidate scan is a sorted-array membership test on h1, then
        exact-key confirmation on the handful of candidates."""
        if not self._unreachable:
            return counts_c, []
        if self._unreach_h1 is None:
            self._unreach_h1 = np.sort(np.fromiter(
                (k[0] for k in self._unreachable), np.uint32,
                len(self._unreachable)))
        pos = np.searchsorted(self._unreach_h1, h1c)
        pos = np.minimum(pos, len(self._unreach_h1) - 1)
        cand = np.flatnonzero((self._unreach_h1[pos] == h1c)
                              & (counts_c > 0))
        if not len(cand):
            return counts_c, []
        corrections = []
        counts_c = counts_c.copy()
        for r in map(int, cand):
            sid = self._unreachable.get(
                (int(h1c[r]), int(h2c[r]), int(h3c[r])))
            if sid is not None:
                corrections.append((sid, int(counts_c[r])))
                counts_c[r] = 0
        if corrections:
            self.stats["unreachable_rows"] = \
                self.stats.get("unreachable_rows", 0) + len(corrections)
        return counts_c, corrections

    # -- per-id metadata and profiles ----------------------------------------

    def _append_id_meta(self, pids: np.ndarray, depths: np.ndarray,
                        flat_vals: np.ndarray) -> None:
        """Append a batch of per-id metadata (pid, ragged loc-id runs whose
        lengths are `depths`, concatenated in id order in `flat_vals`)."""
        n = self._next_id - len(pids)  # ids were assigned before this call
        need_ids = n + len(pids)
        if need_ids > len(self._id_pid):
            grown = np.empty(max(need_ids, 2 * len(self._id_pid)), np.int32)
            grown[:n] = self._id_pid[:n]
            self._id_pid = grown
            goff = np.zeros(len(grown) + 1, np.int64)
            goff[: n + 1] = self._loc_off[: n + 1]
            self._loc_off = goff
        self._id_pid[n:need_ids] = pids
        base = int(self._loc_off[n])
        np.cumsum(depths, out=self._loc_off[n + 1: need_ids + 1])
        self._loc_off[n + 1: need_ids + 1] += base
        need_flat = base + len(flat_vals)
        if need_flat > len(self._loc_flat):
            grown = np.empty(max(need_flat, 2 * len(self._loc_flat)),
                             np.int32)
            grown[:base] = self._loc_flat[:base]
            self._loc_flat = grown
        self._loc_flat[base:need_flat] = flat_vals
        # Metadata (and the per-pid registries, written by the caller
        # before this) is complete for every id below need_ids: publish.
        self._published = need_ids

    def _register_stacks_bulk(self, snapshot, rows: np.ndarray) -> None:
        """Vectorized per-pid location registration for a batch of newly
        inserted stacks (the first window inserts everything)."""
        pids = snapshot.pids[rows]
        depths = (snapshot.user_len + snapshot.kernel_len)[rows]
        table = snapshot.mappings
        # Batch outputs indexed by position in `rows` — positions correspond
        # 1:1 to the contiguous sids the caller just assigned. Each pid
        # group's loc-id runs scatter straight into the ragged batch buffer.
        nb = len(rows)
        depths64 = depths.astype(np.int64)
        boff = np.zeros(nb + 1, np.int64)
        np.cumsum(depths64, out=boff[1:])
        flat_vals = np.empty(int(boff[-1]), np.int32)

        # The rows grouped by pid in one stable sort: each group lists its
        # rows in batch order, the groups come in ascending pid order.
        order = np.argsort(pids, kind="stable")
        sp = pids[order]
        cuts = np.flatnonzero(sp[1:] != sp[:-1]) + 1
        for sel in np.split(order, cuts) if nb else ():
            pid = pids[sel[0]]
            reg = self._pids.get(int(pid))
            if reg is None:
                mappings = _pid_mappings(table, int(pid))
                reg = _PidRegistry(
                    {}, [], [], [], [], mappings,
                    {(m.start, m.end, m.offset): m.id for m in mappings},
                )
                self._pids[int(pid)] = reg

            prows = rows[sel]
            pdepths = depths[sel]
            stacks = snapshot.stacks[prows]
            live = np.arange(STACK_SLOTS)[None, :] < pdepths[:, None]
            addrs = stacks[live]
            uniq = np.unique(addrs)
            addr_to_loc = reg.addr_to_loc
            uniq_l = uniq.tolist()
            # New addresses for this pid's registry (a new registry knows
            # none yet).
            if addr_to_loc:
                known = np.fromiter(map(addr_to_loc.__contains__, uniq_l),
                                    bool, len(uniq_l))
                fresh = uniq[~known]
            else:
                fresh = uniq
            if len(fresh):
                is_kernel = fresh >= np.uint64(KERNEL_ADDR_START)
                mrows = table.rows_for_pid(int(pid))
                norm = fresh.copy()
                map_id = np.zeros(len(fresh), np.int32)
                if len(mrows):
                    starts = table.starts[mrows]
                    ends = table.ends[mrows]
                    offsets = table.offsets[mrows]
                    bases = table.bases[mrows]
                    j = np.searchsorted(starts, fresh, "right").astype(np.int64) - 1
                    safe = np.clip(j, 0, len(mrows) - 1)
                    hit = (j >= 0) & (fresh < ends[safe]) & ~is_kernel
                    norm = np.where(hit, fresh - bases[safe], fresh)
                    # Window-table rows -> registry-stable mapping ids
                    # (appending ranges this registry hasn't seen yet).
                    row_to_reg = np.zeros(len(mrows), np.int32)
                    for row in np.unique(safe[hit]) if hit.any() else []:
                        r = int(row)
                        mkey = (int(starts[r]), int(ends[r]), int(offsets[r]))
                        rid = reg.mapping_index.get(mkey)
                        if rid is None:
                            obj = int(table.objs[mrows[r]])
                            rid = len(reg.mappings) + 1
                            reg.mappings.append(ProfileMapping(
                                id=rid, start=mkey[0], end=mkey[1],
                                offset=mkey[2],
                                path=(table.obj_paths[obj]
                                      if 0 <= obj < len(table.obj_paths)
                                      else ""),
                                build_id=(table.obj_buildids[obj]
                                          if 0 <= obj < len(table.obj_buildids)
                                          else ""),
                                base=int(table.bases[mrows[r]]),
                            ))
                            reg.mapping_index[mkey] = rid
                        row_to_reg[r] = rid
                    map_id = np.where(hit, row_to_reg[safe], 0)
                base = len(reg.loc_address)
                fresh_l = fresh.tolist()
                reg.loc_address.extend(fresh_l)
                reg.loc_normalized.extend(norm.tolist())
                reg.loc_mapping_id.extend(map_id.tolist())
                reg.loc_is_kernel.extend(is_kernel.tolist())
                addr_to_loc.update(zip(fresh_l, range(base + 1,
                                                      base + 1 + len(fresh_l))))

            # Translate every frame to its 1-based loc id in one pass and
            # scatter the runs to their batch-flat positions directly.
            lut = np.fromiter(map(addr_to_loc.__getitem__, uniq_l), np.int32,
                              len(uniq_l))
            frame_ids = lut[np.searchsorted(uniq, stacks[live])]
            pd64 = pdepths.astype(np.int64)
            src_starts = np.zeros(len(sel), np.int64)
            np.cumsum(pd64[:-1], out=src_starts[1:])
            ragged_gather(frame_ids, src_starts, pd64,
                          out=flat_vals, out_starts=boff[sel])

        self._append_id_meta(pids.astype(np.int32), depths64, flat_vals)
        self._reg_version += 1

    def _build_profiles(self, snapshot: WindowSnapshot,
                        counts: np.ndarray) -> list[PidProfile]:
        ids = np.flatnonzero(counts)
        if not len(ids):
            return []
        vals = counts[ids]
        id_pid = self._id_pid[: self._next_id].astype(np.int64)[ids]
        order = np.argsort(id_pid, kind="stable")
        ids, vals, id_pid = ids[order], vals[order], id_pid[order]
        bounds = np.flatnonzero(np.diff(id_pid)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [len(ids)]))
        all_depths = (self._loc_off[ids + 1] - self._loc_off[ids]).astype(
            np.int32)

        profiles = []
        for lo, hi in zip(starts, ends):
            pid = int(id_pid[lo])
            reg = self._pids[pid]
            sel = ids[lo:hi]
            s = len(sel)
            depths = all_depths[lo:hi]
            loc_rows = np.zeros((s, STACK_SLOTS), np.int32)
            flat, _ = ragged_gather(self._loc_flat, self._loc_off[sel],
                                    depths)
            loc_rows[np.arange(STACK_SLOTS)[None, :] < depths[:, None]] = flat
            profiles.append(PidProfile(
                pid=pid,
                stack_loc_ids=loc_rows,
                stack_depths=depths.copy(),
                values=vals[lo:hi].copy(),
                loc_address=np.array(reg.loc_address, np.uint64),
                loc_normalized=np.array(reg.loc_normalized, np.uint64),
                loc_mapping_id=np.array(reg.loc_mapping_id, np.int32),
                loc_is_kernel=np.array(reg.loc_is_kernel, bool),
                mappings=reg.mappings,
                period_ns=snapshot.period_ns,
                time_ns=snapshot.time_ns,
                duration_ns=snapshot.window_ns,
            ))
        return profiles
