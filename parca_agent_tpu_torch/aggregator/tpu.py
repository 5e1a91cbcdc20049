"""One-shot window aggregation on the device: the whole window in one
program, batched over all pids.

PyTorch counterpart of parca_agent_tpu/aggregator/tpu.py, held to it bit
for bit (the program's 10 outputs, the profiles, the pprof bytes).
TPUAggregator keeps its name so that a reader finds its counterpart; it
runs on the CUDA card unless the caller asks for the CPU. The program:

  1. row hash      — hash families 0 and 1 over each padded row (pid,
                     user_len, kernel_len, 128 frames): the CUDA kernel of
                     ops/row_hash.py;
  2. stack dedup   — a stable sort by (pid, h1, h2), then a FULL row
                     comparison between neighbours (a hash collision can
                     never merge two stacks), segment sums of counts;
  3. location dedup— the live frames of the unique stacks compacted into
                     [f_cap], then deduplicated by (pid, addr_hi, addr_lo)
                     into per-pid 1-based location ids and a bounded
                     [l_cap] table, either through the location-table
                     CUDA kernel (dedup="hash", aggregator/probe.py) and a
                     sort of the dense list of keys it returns, or through
                     a sort of every frame (dedup="sort");
  4. mapping join  — a lockstep binary search of every location against
                     the (pid, start)-sorted mapping table.

Both dedup arms give the same bytes. "hash" is the default; "sort" is the
reference it is held against, in plain torch ops. Neither falls back to
the other: a failed kernel build or launch raises.

Device tensors carry uint32 values as int32 bits. Where the JAX program
orders or compares u32 values, the port flips the sign bit (x ^ -2^31),
which orders int32 bits as their u32 values; where it sorts by several
keys, the port runs stable single-key sorts from the least significant
key up, with two u32 keys packed into one int64, so that the order equals
lax.sort's exactly, ties by input index.

Stateless between windows: an instance keeps only the once-only
LOC_WARN_THRESHOLD warning latch, and the timings and stats of its last
window.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time

import numpy as np
import torch

from parca_agent_tpu_torch.aggregator import probe
from parca_agent_tpu_torch.aggregator.base import PidProfile
from parca_agent_tpu_torch.aggregator.cpu import _pid_mappings
from parca_agent_tpu_torch.capture.formats import (
    KERNEL_ADDR_START,
    STACK_SLOTS,
    WindowSnapshot,
    fold_rows_first_seen,
)
from parca_agent_tpu_torch.ops.hashing import u32_wide
from parca_agent_tpu_torch.ops.row_hash import row_hash
from parca_agent_tpu_torch.runtime import device_telemetry as dtel
from parca_agent_tpu_torch.utils.bounded import device_wait
from parca_agent_tpu_torch.utils.device import resolve_device

_U32_MAX = 0xFFFFFFFF
_I32_MAX = 2**31 - 1
# XOR with the int32 sign bit maps u32 order onto signed int32 order.
_SIGN = -(2**31)
# The 10 outputs' host dtypes, as the JAX program returns them.
OUTPUT_DTYPES = (np.int32, np.int32, np.uint32, np.int32, np.int32,
                 np.int32, np.uint32, np.uint32, np.uint32, np.int32)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _shift_down(a: torch.Tensor, fill: int) -> torch.Tensor:
    """[a0, a1, ...] -> [fill, a0, a1, ...] dropping the last element."""
    return torch.cat([a.new_full((1,), fill), a[:-1]])


def argsort3(k1: torch.Tensor, k2: torch.Tensor,
             k3: torch.Tensor) -> torch.Tensor:
    """The permutation lax.sort((k1, k2, k3, arange), num_keys=3,
    is_stable=True) applies, for u32 keys carried as int32 bits: a stable
    sort by k3, then a stable sort by (k1, k2) packed into one int64 (k1
    sign-flipped into the high half, so signed order is u32 order)."""
    p = torch.sort(u32_wide(k3), stable=True).indices
    hi = (k1[p] ^ _SIGN).to(torch.int64) * (1 << 32) + u32_wide(k2[p])
    return p[torch.sort(hi, stable=True).indices]


def _segment_min(data: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """jax.ops.segment_min for ids in [0, num): empty segments hold
    INT32_MAX."""
    out = torch.full((num,), _I32_MAX, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg, data, "amin")


def _scatter_drop(n: int, idx: torch.Tensor, src: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """jnp.full((n,), fill).at[idx].set(src, mode="drop") for idx >= 0:
    indices past the end land in a dump slot that is cut off."""
    out = torch.full((n + 1,), fill, dtype=src.dtype, device=src.device)
    out[idx.clamp_max(n)] = src
    return out[:n]


class StageClock:
    """Device time of each stage of one window_program run: CUDA events
    on the device's current stream (read once the program's outputs have
    been fetched), or the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._device = device
        self._marks: list = []
        self.mark("start")

    def mark(self, stage: str) -> None:
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
        else:
            ev = time.perf_counter()
        self._marks.append((stage, ev))

    def read_ms(self) -> dict[str, float]:
        out = {}
        for (_, a), (stage, b) in zip(self._marks, self._marks[1:]):
            out[stage] = a.elapsed_time(b) if self._cuda else (b - a) * 1e3
        return out


class _NoClock:
    def mark(self, stage: str) -> None:
        pass


# -- the window program -------------------------------------------------------


def stack_dedup(pid, cnt, ulen, klen, shi, slo, valid, h1, h2, *, n_pad):
    """Step 2: exact stack dedup. Returns (n_groups int32 scalar, out_pid,
    out_ulen, out_klen, out_shi, out_slo, values, group_live), one row a
    group in (pid, h1, h2) order."""
    n = pid.shape[0]
    dev = pid.device
    perm = argsort3(pid, h1, h2)
    pid_s, cnt_s, ulen_s, klen_s = pid[perm], cnt[perm], ulen[perm], \
        klen[perm]
    shi_s, slo_s, valid_s = shi[perm], slo[perm], valid[perm]

    same_meta = ((pid_s == _shift_down(pid_s, -1))
                 & (ulen_s == _shift_down(ulen_s, -1))
                 & (klen_s == _shift_down(klen_s, -1)))
    same_stack = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=dev),
        ((shi_s[1:] == shi_s[:-1]) & (slo_s[1:] == slo_s[:-1])).all(dim=1)])
    new_group = ~(same_meta & same_stack) & valid_s
    new_group[0] = valid_s[0]

    group = (torch.cumsum(new_group, 0) - 1).clamp_min(0)
    n_groups = new_group.sum().to(torch.int32)
    values = torch.zeros(n_pad, dtype=torch.int32, device=dev).index_add_(
        0, group, cnt_s)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    rep_pos = _segment_min(rows, group, n_pad).clamp_max(n - 1).long()
    group_live = rows < n_groups
    return (n_groups, pid_s[rep_pos], ulen_s[rep_pos], klen_s[rep_pos],
            shi_s[rep_pos], slo_s[rep_pos], values, group_live)


def compact_frames(out_pid, out_shi, out_slo, depth, group_live, *, f_cap):
    """Step 3a: the live frames of the unique stacks, in row order, in
    [f_cap] buffers: (fpid, fhi, flo) keys (dead lanes U32_MAX) and fsrc,
    each frame's flat [n*S] position (dead lanes n*S)."""
    n, s = out_shi.shape
    dev = out_shi.device
    slot = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    frame_live = (slot < depth[:, None]) & group_live[:, None]
    idx = frame_live.reshape(-1).nonzero().squeeze(1)[:f_cap]
    k = idx.numel()
    fpid = torch.full((f_cap,), -1, dtype=torch.int32, device=dev)
    fhi = torch.full((f_cap,), -1, dtype=torch.int32, device=dev)
    flo = torch.full((f_cap,), -1, dtype=torch.int32, device=dev)
    fsrc = torch.full((f_cap,), n * s, dtype=torch.int32, device=dev)
    fpid[:k] = out_pid[idx // s]
    fhi[:k] = out_shi.reshape(-1)[idx]
    flo[:k] = out_slo.reshape(-1)[idx]
    fsrc[:k] = idx.to(torch.int32)
    return fpid, fhi, flo, fsrc


def _ranks(kpid, klive, loc_seq, num_segments):
    """Per-pid 1-based location rank of each live sorted entry (0 for
    dead ones), from the global 1-based location sequence number."""
    new_pid = (kpid != _shift_down(kpid, -1)) & klive
    new_pid[0] = klive[0]
    pid_seg = (torch.cumsum(new_pid, 0) - 1).clamp_min(0)
    first = _segment_min(torch.where(klive, loc_seq, _I32_MAX), pid_seg,
                         num_segments)
    return torch.where(klive, loc_seq - first[pid_seg] + 1, 0).to(
        torch.int32)


def _hash_dedup(fpid, fhi, flo, fsrc, n_flat, l_cap, clock):
    """Step 3b, dedup="hash": the location table (the CUDA kernel, which
    hashes each key's probe base itself), then a sort of its dense list of
    l_cap keys, which restores the sort arm's exact order."""
    cap_loc = 2 * l_cap
    slot, epid, ehi, elo, eslot, n_entries = probe.build_loc_table(
        fpid, fhi, flo, None, cap_loc, l_cap)
    clock.mark("loc_table")
    # A live frame that could not place means the table is full (l_cap
    # too small): n_locs = l_cap + 1 makes the caller retry, as the sort
    # arm's overflow does. Otherwise n_locs is the table's key count, as
    # _window_kernel counts its live slots; above l_cap (entries dropped)
    # the caller retries too.
    overflowed = ((fpid != -1) & (slot < 0)).any()
    n_locs = torch.where(overflowed, l_cap + 1, n_entries[0]).to(torch.int32)
    perm = argsort3(epid, ehi, elo)
    spid, shi2, slo2, sslot = epid[perm], ehi[perm], elo[perm], eslot[perm]
    tlive = spid != -1
    rank_sorted = _ranks(spid, tlive, torch.cumsum(tlive, 0), l_cap)
    # Padding entries carry slot cap_loc: one dump entry past the table,
    # so their rank 0 never overwrites a live slot's.
    rank_by_slot = torch.zeros(cap_loc + 1, dtype=torch.int32,
                               device=fpid.device)
    rank_by_slot[sslot.long()] = rank_sorted
    frame_rank = torch.where(slot >= 0, rank_by_slot[slot.clamp_min(0).long()],
                             0)
    loc_ids = _scatter_drop(n_flat, fsrc.long(), frame_rank, 0)
    clock.mark("table_sort_ranks")
    return n_locs, loc_ids, spid, shi2, slo2


def _sort_dedup(fpid, fhi, flo, fsrc, n_flat, l_cap, n_pad, clock):
    """Step 3b, dedup="sort": a stable sort of every frame by (pid, hi,
    lo), neighbour compare, per-pid ranks, and the compacted table."""
    order = argsort3(fpid, fhi, flo)
    fpid_s, fhi_s, flo_s, fidx = fpid[order], fhi[order], flo[order], \
        fsrc[order]
    flive_s = fpid_s != -1
    same_loc = ((fpid_s == _shift_down(fpid_s, -1))
                & (fhi_s == _shift_down(fhi_s, 0))
                & (flo_s == _shift_down(flo_s, 0)))
    same_loc[0] = False
    new_loc = ~same_loc & flive_s
    new_loc[0] = flive_s[0]
    n_locs = new_loc.sum().to(torch.int32)
    loc_seq = torch.cumsum(new_loc, 0)
    rank = _ranks(fpid_s, flive_s, loc_seq, n_pad)
    loc_ids = _scatter_drop(n_flat, fidx.long(), rank, 0)
    tgt = torch.where(new_loc, loc_seq - 1, l_cap)
    loc_pid = _scatter_drop(l_cap, tgt, fpid_s, -1)
    loc_hi = _scatter_drop(l_cap, tgt, fhi_s, 0)
    loc_lo = _scatter_drop(l_cap, tgt, flo_s, 0)
    clock.mark("frame_sort_ranks")
    return n_locs, loc_ids, loc_pid, loc_hi, loc_lo


def _mapping_join(loc_pid, loc_hi, loc_lo, map_pid, map_shi, map_slo,
                  map_ehi, map_elo, m_pad):
    """Step 4: mapping row of each location (-1 = unmapped): rank_le =
    the number of mapping rows with (pid, start) <= (pid, addr), by a
    branchless binary search of all locations in lockstep, then the end
    check of candidate row rank_le - 1."""
    lp, lh, ll = (x ^ _SIGN for x in (loc_pid, loc_hi, loc_lo))
    mp, ms, ml = (x ^ _SIGN for x in (map_pid, map_shi, map_slo))
    lo_b = torch.zeros(loc_pid.shape[0], dtype=torch.int64,
                       device=loc_pid.device)
    hi_b = torch.full_like(lo_b, m_pad)
    for _ in range(max(1, math.ceil(math.log2(m_pad + 1)))):
        cont = lo_b < hi_b
        mid = ((lo_b + hi_b) // 2).clamp_max(m_pad - 1)
        a1, a2, a3 = mp[mid], ms[mid], ml[mid]
        le = (a1 < lp) | ((a1 == lp) & ((a2 < lh) | ((a2 == lh)
                                                     & (a3 <= ll))))
        lo_b = torch.where(cont & le, mid + 1, lo_b)
        hi_b = torch.where(cont & ~le, mid, hi_b)
    cand = lo_b - 1
    safe = cand.clamp_min(0)
    ehi, elo = map_ehi[safe] ^ _SIGN, map_elo[safe] ^ _SIGN
    addr_lt_end = (lh < ehi) | ((lh == ehi) & (ll < elo))
    hit = (cand >= 0) & (map_pid[safe] == loc_pid) & addr_lt_end
    return torch.where(hit, safe, -1).to(torch.int32)


def window_program(pid, cnt, ulen, klen, shi, slo, valid, map_pid, map_shi,
                   map_slo, map_ehi, map_elo, *, n_pad: int, l_cap: int,
                   m_pad: int, f_cap: int, dedup: str = "hash",
                   clock: StageClock | None = None):
    """The counterpart of parca_agent_tpu/aggregator/tpu.py:_window_kernel:
    the 12 operands of pack_window_inputs (as tensors: uint32 as int32
    bits, valid as bool) in, its 10 outputs out, in the same order and
    (as bits) the same dtypes: (n_groups, n_locs, out_pid, depth, values,
    loc_ids, loc_pid, loc_hi, loc_lo, loc_map_row). No host sync but the
    frame compaction's count. `clock` marks the end of each stage."""
    if dedup not in ("hash", "sort"):
        raise ValueError(f"dedup must be 'hash' or 'sort', not {dedup!r}")
    clock = clock or _NoClock()
    n, s = shi.shape

    h1, h2 = row_hash(shi, slo, pid, ulen, klen)
    clock.mark("row_hash")
    (n_groups, out_pid, out_ulen, out_klen, out_shi, out_slo, values,
     group_live) = stack_dedup(pid, cnt, ulen, klen, shi, slo, valid, h1,
                               h2, n_pad=n_pad)
    depth = out_ulen + out_klen
    clock.mark("stack_sort_dedup")
    fpid, fhi, flo, fsrc = compact_frames(out_pid, out_shi, out_slo, depth,
                                          group_live, f_cap=f_cap)
    clock.mark("frame_compaction")
    if dedup == "hash":
        n_locs, loc_ids, loc_pid, loc_hi, loc_lo = _hash_dedup(
            fpid, fhi, flo, fsrc, n * s, l_cap, clock)
    else:
        n_locs, loc_ids, loc_pid, loc_hi, loc_lo = _sort_dedup(
            fpid, fhi, flo, fsrc, n * s, l_cap, n_pad, clock)
    loc_map_row = _mapping_join(loc_pid, loc_hi, loc_lo, map_pid, map_shi,
                                map_slo, map_ehi, map_elo, m_pad)
    clock.mark("mapping_join")
    return (n_groups, n_locs, out_pid, depth, values, loc_ids.reshape(n, s),
            loc_pid, loc_hi, loc_lo, loc_map_row)


# -- host side: copies of parca_agent_tpu/aggregator/tpu.py -------------------


def shadow_compare(device_profiles, cpu_profiles) -> bool:
    """A/B correctness gate between two aggregations of the SAME window:
    per pid, total sample mass and unique-stack count must agree,
    order-insensitively."""
    def digest(profiles):
        return {int(p.pid): (int(p.total()), int(len(p.values)))
                for p in profiles}

    return digest(device_profiles) == digest(cpu_profiles)


def _coalesce_snapshot_rows(snapshot: WindowSnapshot) -> WindowSnapshot:
    """Fold rows that are EXACT duplicates in everything the program
    consumes — (pid, user_len, kernel_len, full padded stack row) — into
    one row with summed counts, in first-occurrence order. Cross-tid
    repetition is the common source: the program keys on (pid, stack), so
    the fold shrinks the padded upload and every sort lane behind it. The
    program's own dedup would have merged exactly these rows."""
    n = len(snapshot)
    if n < 2:
        return snapshot
    rec = np.empty((n, STACK_SLOTS + 1), np.uint64)
    # pid fits 32 bits, user/kernel lens fit 8 each: one header word.
    rec[:, 0] = (snapshot.pids.astype(np.uint64) << np.uint64(32)) \
        | (snapshot.user_len.astype(np.uint64) << np.uint64(8)) \
        | snapshot.kernel_len.astype(np.uint64)
    rec[:, 1:] = snapshot.stacks
    folded = fold_rows_first_seen(
        np.ascontiguousarray(rec).view(
            np.dtype((np.void, (STACK_SLOTS + 1) * 8))).ravel(),
        snapshot.counts)
    if folded is None:
        return snapshot
    rep, _inv, weights = folded
    return dataclasses.replace(
        snapshot, pids=snapshot.pids[rep], tids=snapshot.tids[rep],
        counts=weights, user_len=snapshot.user_len[rep],
        kernel_len=snapshot.kernel_len[rep], stacks=snapshot.stacks[rep])


def pack_window_inputs(snapshot: WindowSnapshot, l_cap: int | None = None):
    """Pad a WindowSnapshot into the program's uint32 operand layout.

    Returns (host_arrays, dims): the 12 operands as host numpy arrays, and
    the shape bucket {n_pad, l_cap, m_pad, f_cap}. l_cap defaults to the
    next power of two of the window's exact unique (pid, frame) count.
    """
    n = len(snapshot)
    n_pad = _next_pow2(max(1, n))
    table = snapshot.mappings
    m = len(table)
    m_pad = max(1, _next_pow2(m))

    # Counts ride int32 lanes on the device; guard the whole window's
    # total (an upper bound on any merged group's sum) before the astype
    # below wraps.
    if int(snapshot.counts.sum()) >= 2**31:
        raise ValueError("window sample total exceeds int32")
    # pid == U32_MAX is the program's dead-row/dead-frame sentinel. pid -1
    # (perf's unattributable context) would alias it after the uint32 cast
    # and silently lose that profile: reject it here.
    if n and int(snapshot.pids.min()) < 0:
        raise ValueError("negative pid in snapshot (would alias the "
                         "kernel's dead-row sentinel)")

    pid = np.full(n_pad, _U32_MAX, np.uint32)
    pid[:n] = snapshot.pids.astype(np.uint32)
    cnt = np.zeros(n_pad, np.int32)
    cnt[:n] = snapshot.counts.astype(np.int32)
    ulen = np.zeros(n_pad, np.int32)
    ulen[:n] = snapshot.user_len
    klen = np.zeros(n_pad, np.int32)
    klen[:n] = snapshot.kernel_len
    shi = np.zeros((n_pad, STACK_SLOTS), np.uint32)
    slo = np.zeros((n_pad, STACK_SLOTS), np.uint32)
    shi[:n] = (snapshot.stacks >> np.uint64(32)).astype(np.uint32)
    slo[:n] = snapshot.stacks.astype(np.uint32)
    valid = np.zeros(n_pad, bool)
    valid[:n] = True

    map_pid = np.full(m_pad, _U32_MAX, np.uint32)
    map_shi = np.full(m_pad, _U32_MAX, np.uint32)
    map_slo = np.full(m_pad, _U32_MAX, np.uint32)
    map_ehi = np.zeros(m_pad, np.uint32)
    map_elo = np.zeros(m_pad, np.uint32)
    map_pid[:m] = table.pids.astype(np.uint32)
    map_shi[:m] = (table.starts >> np.uint64(32)).astype(np.uint32)
    map_slo[:m] = table.starts.astype(np.uint32)
    map_ehi[:m] = (table.ends >> np.uint64(32)).astype(np.uint32)
    map_elo[:m] = table.ends.astype(np.uint32)

    total_frames = int((snapshot.user_len + snapshot.kernel_len).sum())
    if l_cap is None:
        # Exact unique-(pid, frame) count, an upper bound on the program's
        # deduplicated location count: col j of row i enumerates that
        # row's live frames.
        depth = (snapshot.user_len.astype(np.int64)
                 + snapshot.kernel_len.astype(np.int64))
        row_idx = np.repeat(np.arange(n, dtype=np.int64), depth)
        col_idx = np.arange(total_frames, dtype=np.int64) - \
            np.repeat(np.cumsum(depth) - depth, depth)
        key = np.empty((total_frames, 2), np.uint64)
        key[:, 0] = snapshot.pids[row_idx].astype(np.uint64)
        key[:, 1] = snapshot.stacks[row_idx, col_idx]
        n_locs = len(np.unique(
            np.ascontiguousarray(key).view(
                np.dtype((np.void, 16))).ravel()))
        l_cap = max(16, _next_pow2(max(1, n_locs)))
    # Frame-compaction buffer: sized from the exact frame count, so the
    # compaction can never drop a live frame.
    f_cap = max(16, _next_pow2(max(1, total_frames)))

    args = (pid, cnt, ulen, klen, shi, slo, valid,
            map_pid, map_shi, map_slo, map_ehi, map_elo)
    return args, {"n_pad": n_pad, "l_cap": l_cap, "m_pad": m_pad,
                  "f_cap": f_cap}


def to_device(host_args, device: torch.device) -> tuple:
    """pack_window_inputs' arrays as tensors on `device` (uint32 as int32
    bits)."""
    return tuple(
        torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        .to(device) for a in host_args)


class TPUAggregator:
    """One-shot window aggregation on `device` ("cuda", the default, which
    raises without a CUDA device; or "cpu", the plain versions of the
    kernels). dedup is "hash" (the location-table kernel) or "sort".

    The unique-location table is a bounded buffer sized from the host's
    exact count; if the program reports n_locs above it, the window runs
    again with the cap doubled. Results are always exact: the cap bounds
    memory, it never truncates.
    """

    name = "tpu"

    # Unique-location count beyond which the one-shot program is the wrong
    # tool and the streaming dict aggregator should be used. Advisory
    # only: results stay exact either way.
    LOC_WARN_THRESHOLD = 1 << 22

    def __init__(self, dedup: str = "hash",
                 device: str | torch.device = "cuda"):
        if dedup not in ("hash", "sort"):
            raise ValueError(f"dedup must be 'hash' or 'sort', not "
                             f"{dedup!r}")
        self.dedup = dedup
        self.device = resolve_device(device)
        self._loc_warned = False
        # Host stage seconds, device stage ms and shapes of the last window.
        self.timings: dict[str, float] = {}
        self.device_ms: dict[str, float] = {}
        self.stats: dict[str, int] = {}

    def window_outputs(self, snapshot: WindowSnapshot):
        """Coalesce, pack, upload, run the program (doubling l_cap until
        the locations fit) and fetch. Returns (the coalesced snapshot, the
        program's 10 outputs as host numpy arrays of the JAX program's
        dtypes)."""
        clk = time.perf_counter
        t0 = clk()
        snapshot = _coalesce_snapshot_rows(snapshot)
        t1 = clk()
        host_args, dims = pack_window_inputs(snapshot)
        t2 = clk()
        with device_wait():
            dev_args = to_device(host_args, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t3 = clk()
        attempts = 0
        while True:
            attempts += 1
            stages = StageClock(self.device)
            with device_wait():
                out = window_program(*dev_args, dedup=self.dedup,
                                     clock=stages, **dims)
                n_locs = int(out[1])
            if n_locs <= dims["l_cap"]:
                break
            dims["l_cap"] *= 2
        t4 = clk()
        with device_wait():
            outs = tuple(x.cpu().numpy().view(dt)
                         for x, dt in zip(out, OUTPUT_DTYPES))
        t5 = clk()
        # Telemetry: upload to fetch (the program is synchronous here),
        # keyed on the padded shapes; an l_cap doubling reads as the new
        # signature it is.
        dtel.record("loc_dedup", t5 - t2,
                    shape=(*(dims[k] for k in sorted(dims)), self.dedup),
                    h2d_bytes=sum(int(a.nbytes) for a in host_args),
                    d2h_bytes=sum(int(a.nbytes) for a in outs))
        self.timings = {"coalesce": t1 - t0, "pack": t2 - t1, "h2d": t3 - t2,
                        "program": t4 - t3, "d2h": t5 - t4}
        self.device_ms = stages.read_ms()
        self.stats = {**dims, "cap_loc": 2 * dims["l_cap"],
                      "attempts": attempts, "n_groups": int(outs[0]),
                      "n_locs": n_locs}

        if n_locs > self.LOC_WARN_THRESHOLD and not self._loc_warned:
            # Keyed on the MEASURED unique-location count, once per
            # aggregator: the per-window hot path must not log every window.
            self._loc_warned = True
            logging.getLogger(__name__).warning(
                "window location entropy is in the one-shot program's "
                "adversarial regime (%d unique locations > %d); "
                "--aggregator dict (the streaming dictionary) aggregates "
                "such windows faster", n_locs, self.LOC_WARN_THRESHOLD)
        return snapshot, outs

    def aggregate(self, snapshot: WindowSnapshot) -> list[PidProfile]:
        if len(snapshot) == 0:
            return []
        snapshot, outs = self.window_outputs(snapshot)
        t0 = time.perf_counter()
        profiles = self._build_profiles(snapshot, snapshot.mappings,
                                        int(outs[0]), int(outs[1]),
                                        *outs[2:])
        self.timings["build_profiles"] = time.perf_counter() - t0
        return profiles

    def _build_profiles(
        self, snapshot, table, n_groups, n_locs, out_pid, depth, values,
        loc_ids, loc_pid, loc_hi, loc_lo, loc_map_row,
    ) -> list[PidProfile]:
        u_pid = out_pid[:n_groups].astype(np.int64)
        u_depth = depth[:n_groups].astype(np.int32)
        u_values = values[:n_groups].astype(np.int64)
        u_loc_ids = loc_ids[:n_groups]

        l_pid = loc_pid[:n_locs].astype(np.int64)
        l_addr = (loc_hi[:n_locs].astype(np.uint64) << np.uint64(32)) | loc_lo[
            :n_locs
        ].astype(np.uint64)
        l_row = loc_map_row[:n_locs]

        l_kernel = l_addr >= np.uint64(KERNEL_ADDR_START)
        # u64 arithmetic + per-pid mapping ranks stay on the host. Kernel
        # text is never normalized through the mapping table, even if a
        # mapping (e.g. [vsyscall]) covers it — matches the CPU oracle.
        hit = (l_row >= 0) & ~l_kernel
        safe = np.maximum(l_row, 0)
        if len(table):
            l_norm = np.where(hit, l_addr - table.bases[safe], l_addr)
            # Global mapping row -> 1-based rank within its pid (rows are
            # sorted by (pid, start): rank = row - first row of pid's block).
            pid_first_row = np.searchsorted(table.pids, table.pids[safe], "left")
            l_map_id = np.where(hit, safe - pid_first_row + 1, 0).astype(np.int32)
        else:
            l_norm = l_addr.copy()
            l_map_id = np.zeros(n_locs, np.int32)

        # Both tables arrive pid-contiguous (device sort order); split them.
        profiles: list[PidProfile] = []
        stack_bounds = np.flatnonzero(np.diff(u_pid)) + 1
        s_starts = np.concatenate(([0], stack_bounds))
        s_ends = np.concatenate((stack_bounds, [n_groups]))
        loc_starts = np.searchsorted(l_pid, u_pid[s_starts], "left")
        loc_ends = np.searchsorted(l_pid, u_pid[s_starts], "right")

        for i, (lo, hi) in enumerate(zip(s_starts, s_ends)):
            pid = int(u_pid[lo])
            llo, lhi = int(loc_starts[i]), int(loc_ends[i])
            profiles.append(
                PidProfile(
                    pid=pid,
                    stack_loc_ids=u_loc_ids[lo:hi],
                    stack_depths=u_depth[lo:hi],
                    values=u_values[lo:hi],
                    loc_address=l_addr[llo:lhi],
                    loc_normalized=l_norm[llo:lhi].astype(np.uint64),
                    loc_mapping_id=l_map_id[llo:lhi],
                    loc_is_kernel=l_kernel[llo:lhi],
                    mappings=_pid_mappings(table, pid),
                    period_ns=snapshot.period_ns,
                    time_ns=snapshot.time_ns,
                    duration_ns=snapshot.window_ns,
                )
            )
        return profiles
