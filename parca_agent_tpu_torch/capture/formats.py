"""Window snapshot data contracts (Phase 0 of SURVEY.md section 7).

The seam every later phase plugs into. A WindowSnapshot is the drained state
of one aggregation window (default 10 s @ 100 Hz): for each distinct
(pid, stack) observed by the capture side, one row with the raw user+kernel
address trace and its sample count, plus the per-PID virtual-memory mapping
table needed to normalize user addresses.

Shape contract (chosen for device layout, not for the kernel ABI):

  pids        int32  [N]          process id (tgid in kernel terms)
  tids        int32  [N]          thread id of the sampled thread
  counts      int64  [N]          number of samples with this exact stack
  user_len    int32  [N]          number of valid user frames in stacks[i]
  kernel_len  int32  [N]          number of valid kernel frames in stacks[i]
  stacks      uint64 [N, 128]     user frames [0:user_len), kernel frames
                                  [user_len:user_len+kernel_len), zero-padded.
                                  Leaf-most frame first (index 0 = sampled pc).

The reference keeps user and kernel stacks in separate BPF maps keyed by
stack id (reference bpf/cpu/cpu.bpf.c:179-207) and joins them in userspace
(pkg/profiler/cpu/cpu.go:634-686); we pre-join at drain time so the device
sees one dense matrix. 128 slots = the reference's 127-frame depth cap
(bpf/cpu/cpu.bpf.c:22-27) rounded up to a power of two.

Mapping table (the subset of /proc/PID/maps that address normalization
needs, reference pkg/process/maps.go:73-128):

  map_pids    int32  [M]   owner pid, rows sorted by (pid, start)
  map_starts  uint64 [M]   virtual start address (inclusive)
  map_ends    uint64 [M]   virtual end address (exclusive)
  map_offsets uint64 [M]   file offset of the mapping
  map_objs    int32  [M]   index into the object table (-1 = anonymous)
  map_bases   uint64 [M]   normalization base: object vaddr = addr - base
                           (pprof GetBase semantics, reference
                           pkg/objectfile/object_file.go:156-238; defaults
                           to start - offset when the ELF was unreadable,
                           which matches file-offset normalization)
  obj_paths   list[str]    backing object path per object id
  obj_buildids list[str]   lowercase hex build id ('' if unknown)

Addresses at or above KERNEL_ADDR_START are kernel text; they are never
normalized through the mapping table (reference pkg/profiler/cpu/cpu.go:
652-659 treats kernel addresses via kallsyms only).
"""

from __future__ import annotations

import dataclasses
import io
import zlib
from typing import BinaryIO, Sequence

import numpy as np

from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

# palint: persistence-root — snapshot fixture files are replay/bench
# inputs adopted across process restarts; writes must be tmp+rename.

# Reference caps stacks at 127 frames (bpf/cpu/cpu.bpf.c:22-27). We pad the
# frame axis to 128 so a stack row is a power-of-two width.
MAX_STACK_DEPTH = 127
STACK_SLOTS = 128

# Start of the x86_64 kernel half of the canonical address space.
KERNEL_ADDR_START = 0xFFFF_8000_0000_0000

_MAGIC = b"PATPSNAP"
# v2 added the mapping `bases` column; v1 files load with bases defaulted.
_VERSION = 2


@dataclasses.dataclass(frozen=True)
class MappingTable:
    """Per-window union of the executable mappings of every sampled PID."""

    pids: np.ndarray      # int32 [M]
    starts: np.ndarray    # uint64 [M]
    ends: np.ndarray      # uint64 [M]
    offsets: np.ndarray   # uint64 [M]
    objs: np.ndarray      # int32 [M]
    obj_paths: tuple[str, ...] = ()
    obj_buildids: tuple[str, ...] = ()
    bases: np.ndarray | None = None  # uint64 [M]; None -> starts - offsets

    def __post_init__(self):
        object.__setattr__(self, "pids", np.asarray(self.pids, np.int32))
        object.__setattr__(self, "starts", np.asarray(self.starts, np.uint64))
        object.__setattr__(self, "ends", np.asarray(self.ends, np.uint64))
        object.__setattr__(self, "offsets", np.asarray(self.offsets, np.uint64))
        object.__setattr__(self, "objs", np.asarray(self.objs, np.int32))
        object.__setattr__(self, "obj_paths", tuple(self.obj_paths))
        object.__setattr__(self, "obj_buildids", tuple(self.obj_buildids))
        if self.bases is None:
            object.__setattr__(self, "bases", self.starts - self.offsets)
        else:
            object.__setattr__(self, "bases", np.asarray(self.bases, np.uint64))
        m = len(self.pids)
        for name in ("starts", "ends", "offsets", "objs", "bases"):
            if len(getattr(self, name)) != m:
                raise ValueError(f"mapping column {name!r} length mismatch")
        if len(self.obj_buildids) not in (0, len(self.obj_paths)):
            raise ValueError("obj_buildids must match obj_paths")
        if m:
            order = np.lexsort((self.starts, self.pids))
            if not np.array_equal(order, np.arange(m)):
                raise ValueError("mapping rows must be sorted by (pid, start)")
            # VMAs are disjoint within a process (kernel invariant); the
            # aggregators' binary-search join relies on it.
            same_pid = self.pids[1:] == self.pids[:-1]
            if np.any(same_pid & (self.starts[1:] < self.ends[:-1])):
                raise ValueError("mappings overlap within a pid")
            if np.any(self.ends < self.starts):
                raise ValueError("mapping end precedes start")

    def __len__(self) -> int:
        return len(self.pids)

    @staticmethod
    def empty() -> "MappingTable":
        z64 = np.zeros(0, np.uint64)
        z32 = np.zeros(0, np.int32)
        return MappingTable(z32, z64, z64, z64, z32)

    def rows_for_pid(self, pid: int) -> np.ndarray:
        """Indices of this pid's mappings (contiguous because sorted)."""
        # The pid goes in as the column's own dtype: a Python int makes
        # numpy cast the whole column on every search.
        col = self.pids
        info = np.iinfo(col.dtype)
        pid = int(pid)
        if not info.min <= pid <= info.max:
            return np.arange(0)
        key = col.dtype.type(pid)
        lo = np.searchsorted(col, key, side="left")
        hi = np.searchsorted(col, key, side="right")
        return np.arange(lo, hi)


@dataclasses.dataclass(frozen=True)
class WindowSnapshot:
    """Drained capture state for one aggregation window."""

    pids: np.ndarray        # int32 [N]
    tids: np.ndarray        # int32 [N]
    counts: np.ndarray      # int64 [N]
    user_len: np.ndarray    # int32 [N]
    kernel_len: np.ndarray  # int32 [N]
    stacks: np.ndarray      # uint64 [N, STACK_SLOTS]
    mappings: MappingTable
    period_ns: int = 10_000_000      # 100 Hz sampling period
    window_ns: int = 10_000_000_000  # 10 s aggregation window
    time_ns: int = 0                 # window start, unix nanos

    def __post_init__(self):
        object.__setattr__(self, "pids", np.asarray(self.pids, np.int32))
        object.__setattr__(self, "tids", np.asarray(self.tids, np.int32))
        object.__setattr__(self, "counts", np.asarray(self.counts, np.int64))
        object.__setattr__(self, "user_len", np.asarray(self.user_len, np.int32))
        object.__setattr__(self, "kernel_len", np.asarray(self.kernel_len, np.int32))
        object.__setattr__(self, "stacks", np.asarray(self.stacks, np.uint64))
        n = len(self.pids)
        for name in ("tids", "counts", "user_len", "kernel_len"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"snapshot column {name!r} length mismatch")
        if self.stacks.shape != (n, STACK_SLOTS):
            raise ValueError(
                f"stacks must be [N, {STACK_SLOTS}], got {self.stacks.shape}"
            )
        depth = self.user_len + self.kernel_len
        if n and int(depth.max(initial=0)) > MAX_STACK_DEPTH:
            raise ValueError(f"stack depth exceeds {MAX_STACK_DEPTH}")
        if n and (int(self.user_len.min()) < 0 or int(self.kernel_len.min()) < 0):
            raise ValueError("negative frame count")

    def __len__(self) -> int:
        return len(self.pids)

    @property
    def depths(self) -> np.ndarray:
        return self.user_len + self.kernel_len

    def validate_padding(self) -> None:
        """Check that slots past the declared depth are zero (fixture QA)."""
        idx = np.arange(STACK_SLOTS, dtype=np.int32)[None, :]
        live = idx < self.depths[:, None]
        if np.any(np.where(live, np.uint64(0), self.stacks) != 0):
            raise ValueError("nonzero padding past declared stack depth")

    def total_samples(self) -> int:
        return int(self.counts.sum())


def fold_rows_first_seen(keys: np.ndarray, counts):
    """Fold duplicate key rows into (unique key, summed weight) pairs in
    FIRST-OCCURRENCE order — the host twin of the reference's in-kernel
    ``(pid, stack) -> count`` fold (bpf/cpu/cpu.bpf.c:110-116): samples
    are reduced to unique work BEFORE they cross an expensive boundary
    (there the kernel->user copy, here the host->device feed dispatch
    and the one-shot kernel's padded upload).

    ``keys`` is a 1-D array whose elements compare by content (callers
    build an ``np.void`` byte view over their key columns). Returns
    ``None`` when every row is already unique (the common one-shot case
    — callers skip the rebuild entirely), else ``(rep, inverse,
    weights)``: ``rep[j]`` is the first input row carrying unique key j,
    ``inverse[i]`` maps input row i to its unique slot, and
    ``weights[j]`` is the exact int64 sum of its rows' counts. First-
    occurrence ordering is what keeps downstream id assignment (miss
    order = insertion order) bit-identical to the unfolded stream."""
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    if len(uniq) == len(keys):
        return None
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    inv = rank[inverse.reshape(-1)]
    counts = np.asarray(counts, np.int64)
    if int(counts.sum()) < 2**53:
        # float64 bincount is exact below 2^53 total mass (the same
        # guard columns_to_snapshot's weighted dedup uses).
        weights = np.bincount(inv, weights=counts,
                              minlength=len(order)).astype(np.int64)
    else:
        weights = np.zeros(len(order), np.int64)
        np.add.at(weights, inv, counts)
    return first[order].astype(np.int64), inv, weights


def _write_arr(out: BinaryIO, arr: np.ndarray) -> None:
    data = np.ascontiguousarray(arr).tobytes()
    out.write(len(data).to_bytes(8, "little"))
    out.write(data)


def _read_arr(buf: BinaryIO, dtype, shape) -> np.ndarray:
    n = int.from_bytes(buf.read(8), "little")
    raw = buf.read(n)
    if len(raw) != n:
        raise ValueError("truncated snapshot array")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _write_strs(out: BinaryIO, strs: Sequence[str]) -> None:
    blob = b"\x00".join(s.encode() for s in strs)
    out.write(len(strs).to_bytes(8, "little"))
    out.write(len(blob).to_bytes(8, "little"))
    out.write(blob)


def _read_strs(buf: BinaryIO) -> tuple[str, ...]:
    k = int.from_bytes(buf.read(8), "little")
    n = int.from_bytes(buf.read(8), "little")
    blob = buf.read(n)
    if k == 0:
        return ()
    parts = blob.split(b"\x00")
    if len(parts) != k:
        raise ValueError("corrupt snapshot string table")
    return tuple(p.decode() for p in parts)


def save_snapshot(snap: WindowSnapshot, path_or_file) -> None:
    """Serialize a snapshot: MAGIC | version | zlib(payload).

    The replayable map-dump fixture format called for by SURVEY.md section 4
    (BASELINE config #2) — lets the aggregator be tested and benchmarked
    without a kernel or capture privileges.
    """
    payload = io.BytesIO()
    n = len(snap)
    m = len(snap.mappings)
    payload.write(n.to_bytes(8, "little"))
    payload.write(m.to_bytes(8, "little"))
    for v in (snap.period_ns, snap.window_ns, snap.time_ns):
        payload.write(int(v).to_bytes(8, "little"))
    for arr in (snap.pids, snap.tids, snap.counts, snap.user_len,
                snap.kernel_len, snap.stacks):
        _write_arr(payload, arr)
    mt = snap.mappings
    for arr in (mt.pids, mt.starts, mt.ends, mt.offsets, mt.objs, mt.bases):
        _write_arr(payload, arr)
    _write_strs(payload, mt.obj_paths)
    _write_strs(payload, mt.obj_buildids)

    compressed = zlib.compress(payload.getvalue(), 6)
    blob = _MAGIC + _VERSION.to_bytes(4, "little") + compressed
    if hasattr(path_or_file, "write"):
        path_or_file.write(blob)
    else:
        # Crash-atomic (palint crash-only-io): a torn snapshot file
        # reads as "bad magic"/short payload at the next load — tmp +
        # rename means the path either holds the old fixture or the
        # complete new one, never a half.
        atomic_write_bytes(path_or_file, blob)


def load_snapshot(path_or_file) -> WindowSnapshot:
    if hasattr(path_or_file, "read"):
        raw = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            raw = f.read()
    if raw[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a snapshot file (bad magic)")
    version = int.from_bytes(raw[len(_MAGIC): len(_MAGIC) + 4], "little")
    if version not in (1, _VERSION):
        raise ValueError(f"unsupported snapshot version {version}")
    try:
        buf = io.BytesIO(zlib.decompress(raw[len(_MAGIC) + 4:]))
    except zlib.error as e:
        raise ValueError(f"corrupt snapshot payload: {e}") from e
    n = int.from_bytes(buf.read(8), "little")
    m = int.from_bytes(buf.read(8), "little")
    period_ns = int.from_bytes(buf.read(8), "little")
    window_ns = int.from_bytes(buf.read(8), "little")
    time_ns = int.from_bytes(buf.read(8), "little")
    pids = _read_arr(buf, np.int32, (n,))
    tids = _read_arr(buf, np.int32, (n,))
    counts = _read_arr(buf, np.int64, (n,))
    user_len = _read_arr(buf, np.int32, (n,))
    kernel_len = _read_arr(buf, np.int32, (n,))
    stacks = _read_arr(buf, np.uint64, (n, STACK_SLOTS))
    mt = MappingTable(
        _read_arr(buf, np.int32, (m,)),
        _read_arr(buf, np.uint64, (m,)),
        _read_arr(buf, np.uint64, (m,)),
        _read_arr(buf, np.uint64, (m,)),
        _read_arr(buf, np.int32, (m,)),
        bases=_read_arr(buf, np.uint64, (m,)) if version >= 2 else None,
        obj_paths=_read_strs(buf),
        obj_buildids=_read_strs(buf),
    )
    return WindowSnapshot(
        pids, tids, counts, user_len, kernel_len, stacks, mt,
        period_ns=period_ns, window_ns=window_ns, time_ns=time_ns,
    )
