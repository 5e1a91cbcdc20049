"""Plain NumPy reference of the exact-count guarantee.

What a window's pprof must hold, worked out again from the drains the
benchmark handed to the agent: each pid's samples are the sums of its
identical rows over all of the window's drains, each frame named by the
mapping it falls in and its address normalized by that mapping (address
minus start plus file offset; kernel frames and frames outside every
mapping keep their raw address and no mapping), leaf first. The window's
counts are each distinct (pid, frames) row's sum over the drains, found
by a 64-bit key hashed from the row's pid, lengths and frames. Nothing
here imports the agent or anything it made.
"""

from __future__ import annotations

import numpy as np

KERNEL_ADDR_START = 0xFFFF_8000_0000_0000
SLOTS = 128
_BLOCK = 8192
_M1, _M2 = np.uint64(0xBF58476D1CE4E5B9), np.uint64(0x94D049BB133111EB)
_S30, _S27, _S31 = np.uint64(30), np.uint64(27), np.uint64(31)
# Fixed odd weights a frame slot, and for the pid and the lengths.
_W = np.random.default_rng(0x5EED).integers(
    0, 2**63, SLOTS + 2, dtype=np.uint64) * np.uint64(2) + np.uint64(1)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer, elementwise, in place (0 stays 0)."""
    x ^= x >> _S30
    x *= _M1
    x ^= x >> _S27
    x *= _M2
    x ^= x >> _S31
    return x


def row_keys(pids, ulen, klen, stacks) -> np.ndarray:
    """A 64-bit key a drain row: equal rows (pid, lengths, frames) get
    equal keys; distinct ones collide with chance about 2^-64 a pair."""
    n = len(pids)
    keys = _mix(pids.astype(np.int64).astype(np.uint64) + np.uint64(1))
    keys *= _W[SLOTS]
    lens = (ulen.astype(np.uint64) << np.uint64(32)) | klen.astype(np.uint64)
    keys += _mix(lens + np.uint64(1)) * _W[SLOTS + 1]
    depth = int((ulen.astype(np.int64) + klen).max()) if n else 0
    for s in range(0, n, _BLOCK):
        block = _mix(np.array(stacks[s:s + _BLOCK, :depth], np.uint64))
        block *= _W[:depth]
        keys[s:s + _BLOCK] += block.sum(axis=1, dtype=np.uint64)
    return keys


def window_counts(drains) -> np.ndarray:
    """The window's count of each distinct (pid, frames) row, summed over
    its drains, sorted ascending (rows with no sample left out)."""
    keys = np.concatenate([row_keys(d[0], d[2], d[3], d[4])
                           for d in drains])
    counts = np.concatenate([np.asarray(d[5], np.int64) for d in drains])
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    sums = np.add.reduceat(counts, starts) if len(counts) else counts
    return np.sort(sums[sums != 0])


def window_summary(drains) -> tuple[int, np.ndarray]:
    """(samples in the window, sorted pids that have samples)."""
    total = sum(int(d[5].sum()) for d in drains)
    pids = np.unique(np.concatenate([d[0][d[5] > 0] for d in drains]))
    return total, pids.astype(np.int64)


def _frame_keys(frames: list[int], maps) -> tuple:
    out = []
    for a in frames:
        key = (0, a)
        if a < KERNEL_ADDR_START:
            for m in maps:
                if m.start <= a < m.end:
                    key = (m.start, a - (m.start - m.offset))
                    break
        out.append(key)
    return tuple(out)


def expected_profiles(drains, pids, maps_of, build_ids: dict) -> dict:
    """pid -> {"stacks": {frame keys: count}, "mass": samples, "mappings":
    {start: (start, end, offset, path, build id)}} for each pid in
    `pids`, from the rows of every drain."""
    want = {int(p): {"stacks": {}, "mass": 0, "mappings": {}}
            for p in pids}
    sel = np.asarray(sorted(want), np.int64)
    for pids_d, _tids, ulen, klen, stacks, counts in drains:
        rows = np.flatnonzero(np.isin(pids_d, sel) & (counts > 0))
        for r in rows.tolist():
            pid = int(pids_d[r])
            maps = maps_of(pid)
            depth = int(ulen[r]) + int(klen[r])
            key = _frame_keys([int(a) for a in stacks[r, :depth]], maps)
            entry = want[pid]
            entry["stacks"][key] = entry["stacks"].get(key, 0) + int(
                counts[r])
            entry["mass"] += int(counts[r])
            for start, _ in key:
                if start and start not in entry["mappings"]:
                    m = next(m for m in maps if m.start == start)
                    entry["mappings"][start] = (
                        m.start, m.end, m.offset, m.path,
                        build_ids.get(m.path, ""))
    return want
