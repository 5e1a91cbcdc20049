"""CPU aggregation: the numpy path, and the oracle the device path is held to.

CPUAggregator states the aggregation semantics as whole-array numpy
operations (exact row dedup via byte views + stable sorts), the role the
reference's `obtainProfiles` loop plays (pkg/profiler/cpu/cpu.go:505-718).
It runs no device code, so `chip_smoke.py` checks the card's window
against it with nothing but numpy on the host.
"""

from __future__ import annotations

import numpy as np

from parca_agent_tpu_torch.aggregator.base import PidProfile, ProfileMapping
from parca_agent_tpu_torch.capture.formats import (
    KERNEL_ADDR_START,
    STACK_SLOTS,
    MappingTable,
    WindowSnapshot,
)


def _pid_mappings(table: MappingTable, pid: int) -> list[ProfileMapping]:
    rows = table.rows_for_pid(pid)
    out = []
    for k, r in enumerate(rows):
        obj = int(table.objs[r])
        out.append(
            ProfileMapping(
                id=k + 1,
                start=int(table.starts[r]),
                end=int(table.ends[r]),
                offset=int(table.offsets[r]),
                base=int(table.bases[r]),
                path=table.obj_paths[obj] if 0 <= obj < len(table.obj_paths) else "",
                build_id=(
                    table.obj_buildids[obj]
                    if 0 <= obj < len(table.obj_buildids)
                    else ""
                ),
            )
        )
    return out


def window_counts_rebuild(snapshot: WindowSnapshot) -> np.ndarray:
    """Full-rebuild stack dedup to counts — the CPU-side analog of
    DictAggregator.window_counts (used as the benchmark baseline so both
    sides are timed at the same counts-only boundary)."""
    n = len(snapshot)
    if n == 0:
        return np.zeros(0, np.int64)
    rec = np.zeros((n, STACK_SLOTS + 3), np.uint64)
    rec[:, 0] = snapshot.pids.astype(np.uint64)
    rec[:, 1] = snapshot.user_len.astype(np.uint64)
    rec[:, 2] = snapshot.kernel_len.astype(np.uint64)
    rec[:, 3:] = snapshot.stacks
    void = np.ascontiguousarray(rec).view(
        np.dtype((np.void, rec.shape[1] * 8))
    ).ravel()
    _, inverse = np.unique(void, return_inverse=True)
    counts = np.zeros(int(inverse.max()) + 1, np.int64)
    np.add.at(counts, inverse, snapshot.counts)
    return counts


class CPUAggregator:
    """Vectorized numpy aggregation — the default production backend."""

    name = "cpu"

    def aggregate(self, snapshot: WindowSnapshot) -> list[PidProfile]:
        n = len(snapshot)
        if n == 0:
            return []
        # Exact stack dedup: byte-compare rows of [pid, user_len, kernel_len,
        # frames...]. user/kernel lengths are part of the key so a same-address
        # trace with a different user/kernel boundary stays distinct. Compare
        # only up to the window's deepest stack — slots past it are zero in
        # every row, so the result is identical and the sort touches ~3x
        # less data at typical depths.
        max_depth = int((snapshot.user_len + snapshot.kernel_len).max())
        rec = np.zeros((n, max_depth + 3), np.uint64)
        rec[:, 0] = snapshot.pids.astype(np.uint64)
        rec[:, 1] = snapshot.user_len.astype(np.uint64)
        rec[:, 2] = snapshot.kernel_len.astype(np.uint64)
        rec[:, 3:] = snapshot.stacks[:, :max_depth]
        void = np.ascontiguousarray(rec).view(
            np.dtype((np.void, rec.shape[1] * 8))
        ).ravel()
        _, first_idx, inverse = np.unique(void, return_index=True, return_inverse=True)
        u = len(first_idx)
        values = np.zeros(u, np.int64)
        np.add.at(values, inverse, snapshot.counts)

        u_pid = snapshot.pids[first_idx]
        u_depth = (snapshot.user_len + snapshot.kernel_len)[first_idx]
        u_stacks = snapshot.stacks[first_idx]

        # Group unique stacks by pid (stable keeps the dedup order per pid).
        order = np.argsort(u_pid, kind="stable")
        u_pid, u_depth, u_stacks, values = (
            u_pid[order], u_depth[order], u_stacks[order], values[order]
        )
        boundaries = np.flatnonzero(np.diff(u_pid)) + 1
        seg_starts = np.concatenate(([0], boundaries))
        seg_ends = np.concatenate((boundaries, [u]))

        slot = np.arange(STACK_SLOTS, dtype=np.int32)[None, :]
        table = snapshot.mappings
        profiles = []
        for lo, hi in zip(seg_starts, seg_ends):
            pid = int(u_pid[lo])
            stacks = u_stacks[lo:hi]
            depths = u_depth[lo:hi]
            live = slot < depths[:, None]
            addrs = np.unique(stacks[live])
            loc_ids = np.where(
                live, np.searchsorted(addrs, stacks).astype(np.int32) + 1, 0
            )

            is_kernel = addrs >= np.uint64(KERNEL_ADDR_START)
            rows = table.rows_for_pid(pid)
            starts = table.starts[rows]
            ends = table.ends[rows]
            bases = table.bases[rows]
            if len(rows):
                midx = np.searchsorted(starts, addrs, side="right").astype(np.int64) - 1
                safe = np.clip(midx, 0, len(rows) - 1)
                hit = (midx >= 0) & (addrs < ends[safe]) & ~is_kernel
                loc_map = np.where(hit, (safe + 1).astype(np.int32), np.int32(0))
                loc_norm = np.where(hit, addrs - bases[safe], addrs)
            else:
                loc_map = np.zeros(len(addrs), np.int32)
                loc_norm = addrs.copy()

            profiles.append(
                PidProfile(
                    pid=pid,
                    stack_loc_ids=loc_ids,
                    stack_depths=depths.astype(np.int32),
                    values=values[lo:hi],
                    loc_address=addrs,
                    loc_normalized=loc_norm.astype(np.uint64),
                    loc_mapping_id=loc_map,
                    loc_is_kernel=is_kernel,
                    mappings=_pid_mappings(table, pid),
                    period_ns=snapshot.period_ns,
                    time_ns=snapshot.time_ns,
                    duration_ns=snapshot.window_ns,
                )
            )
        return profiles
