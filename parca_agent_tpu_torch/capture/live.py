"""Drain columns to window snapshots.

The port's copy of the two helpers of parca_agent_tpu's capture/live.py
that the streaming feeder (profiler/streaming.py) runs on every drain:
mapping_table_for_pids, the per-drain mapping table from shared maps and
object caches, and columns_to_snapshot, which folds a drain's columns
into a counted WindowSnapshot. The perf sampler and the native record
decoders are not ported (the port has no live capture source); without
a quarantine registry, an error from a maps read other than OSError
propagates, as in the original without one.
"""

from __future__ import annotations

import time

import numpy as np

from parca_agent_tpu_torch.capture.formats import (
    STACK_SLOTS,
    MappingTable,
    WindowSnapshot,
)
from parca_agent_tpu_torch.process.maps import build_mapping_table


def mapping_table_for_pids(maps_cache, objs_cache, pids) -> MappingTable:
    """MappingTable for a set of pids via the shared caches
    (``maps_cache.executable_mappings(pid)`` -> [ProcMapping],
    ``objs_cache.build_ids(per_pid)`` -> {path: build id}, and
    ``objs_cache.get(pid, mapping)`` for the normalization base); pids
    that exited (maps unreadable: OSError) or are unattributable (< 0)
    are skipped — their rows keep raw addresses."""
    per_pid = {}
    for pid in pids:
        pid = int(pid)
        if pid < 0:
            continue
        try:
            per_pid[pid] = maps_cache.executable_mappings(pid)
        except OSError:
            continue
    return build_mapping_table(per_pid, objs_cache.build_ids(per_pid),
                               objcache=objs_cache)


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
