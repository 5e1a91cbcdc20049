"""The stack dictionary with its device table and probe work split into
home sub-tables: the PyTorch counterpart of
parca_agent_tpu/aggregator/sharded.py, held to it bit for bit (counts,
ids in per-shard miss order, the host mirror, close buffers, the sketch,
pprof).

  * Every key has a HOME SHARD, h2 % n_shards; shard s owns a private
    sub-table of capacity / n_shards slots, and the linear probe (from
    h1) runs within it, wrapping inside the sub-table. The device table
    is int32 [n_shards, cap_s, 4] (uint32 bits).
  * Each feed is the dictionary's packed buffer, int32 [4, n_pad] (h1,
    h2, h3, count), uploaded once as it is, and one launch of the B7 feed
    kernel (csrc/sharded_feed.cu): each live row's home shard taken from
    its h2, the row probed in that sub-table, a hit added into that
    shard's row of the accumulator, int32 [n_shards, id_cap], and a miss
    written at its rank in that shard's miss list, in packed order (a
    single pass with decoupled look-back over per-shard counts). The host
    takes the lists shard after shard, which fixes the id order. Packed
    order within a shard is the lane order of the JAX package's stable
    host partition, so the lists, and the ids, are its own; the port has
    no partition.
  * The close is one kernel (csrc/close_pack.cu, pa_close_pack_sharded):
    each id's count summed over the shards as the tile loads it, then
    the single table's pack and sideband, fetched once.

In the JAX package the shards are positions on a device mesh, one
sub-table a device. Here they are the leading dimension of tensors on the
aggregator's one device, as the JAX tests run 8 shards on 8 virtual
devices of one host. One shard a card is not a target: NCCL runs one
rank a card, and the cross-node path of the port is the fleet merge
(parallel/), whose process boundary is torch.distributed.

The host mirror is the dictionary's, with slot = shard * cap_s +
within-shard index, so insertion, rotation, eviction, sketch
degradation and the unreachable-key prefilter are inherited; only the
slot placement rule (the hooks below) and the device dispatch differ.
Touch tracking is off (every close is the full close), as in the JAX
package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from parca_agent_tpu_torch.aggregator import probe
from parca_agent_tpu_torch.aggregator.close import close_pack_sharded
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.ops import kernels
from parca_agent_tpu_torch.utils.device import resolve_device

_U32 = 0xFFFFFFFF

# Kernel launches: the wrapper adds one where it launches its CUDA kernel
# and nowhere else (the plain version counts nothing).
LAUNCHES = {"sharded_feed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route_h2(h2: np.ndarray, pids, shard_of_pid, n_shards: int
             ) -> np.ndarray:
    """Each row's h2 rewritten so that h2 % n_shards ==
    shard_of_pid(pid), the rest of the hash kept: the home-shard rule then
    places by pid (a tenant) instead of by raw hash. Every row of a pid
    gets the same residue, so equal stacks still meet in one key. Exact
    for any n_shards: int64 arithmetic, the top partial block stepped
    down one stride instead of wrapping."""
    n = int(n_shards)
    upids, inverse = np.unique(np.asarray(pids, np.int64),
                               return_inverse=True)
    residues = np.array([int(shard_of_pid(int(p))) % n for p in upids],
                        np.int64)
    out = (np.asarray(h2, np.uint32).astype(np.int64) // n) * n \
        + residues[inverse]
    out = np.where(out > 0xFFFFFFFF, out - n, out)
    return out.astype(np.uint32)


# -- B7-feed: the plain version and the kernel wrapper -----------------------

# Lanes a tile of the kernel (csrc/sharded_feed.cu kThreads) and the most
# shards it takes (pa_sharded_feed_max_shards).
FEED_TILE = 1024
FEED_MAX_SHARDS = 256


def _check_feed(table, acc, packed) -> None:
    if table.dtype != torch.int32 or table.dim() != 3 \
            or table.shape[2] != 4 or not table.is_contiguous():
        raise ValueError("table must be a contiguous int32 [n_shards, cap_s, "
                         "4] tensor (uint32 bits)")
    n_shards, cap_s = table.shape[0], table.shape[1]
    if n_shards < 1:
        raise ValueError("table has no shard")
    if cap_s < 1 or cap_s & (cap_s - 1):
        raise ValueError(f"sub-table capacity {cap_s} is not a power of two")
    if acc.dtype != torch.int32 or acc.dim() != 2 \
            or acc.shape[0] != n_shards or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous int32 [{n_shards}, "
                         "id_cap] tensor")
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or packed.shape[0] != 4 or packed.shape[1] < 1 \
            or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous int32 [4, n_pad] "
                         "tensor (uint32 bits), n_pad >= 1")
    for name, t in (("acc", acc), ("packed", packed)):
        if t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")


def sharded_feed_step_plain(table: torch.Tensor, acc: torch.Tensor,
                            packed: torch.Tensor, reset: bool):
    """One feed of _sharded_feed_program in plain torch ops, on the
    unpartitioned packed buffer (int32 [4, n_pad]: h1, h2, h3, count;
    uint32 bits): acc zeroed first when `reset`, then each live row probed
    in its home sub-table (h2 % n_shards) and its count added to
    acc[shard, id] in place (ids >= id_cap dropped). Returns (n_miss int32
    [n_shards], miss_rows int32 [n_shards, n_pad]): shard s's live misses
    as packed positions, in packed order, in miss_rows[s, :n_miss[s]]
    (-1 past it; only the prefix is the result)."""
    if reset:
        acc.zero_()
    n_shards, cap_s = table.shape[0], table.shape[1]
    n = packed.shape[1]
    dev = table.device
    mask = cap_s - 1
    flat = table.reshape(-1, 4)
    h1, h2, h3, cnt = packed[0], packed[1], packed[2], packed[3]
    shard = (h2.to(torch.int64) & _U32) % n_shards
    base = shard * cap_s
    h1w = h1.to(torch.int64) & _U32
    found = torch.full((n,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in range(probe.PROBES):
        row = flat[base + ((h1w + k) & mask)]
        occ = row[:, 3] != 0
        hit = occ & (row[:, 0] == h1) & (row[:, 1] == h2) & (row[:, 2] == h3)
        found = torch.where(hit & ~done, row[:, 3] - 1, found)
        done = done | hit | ~occ
    live = cnt > 0
    id_cap = acc.shape[1]
    add = live & (found >= 0) & (found < id_cap)
    acc.view(-1).index_add_(0, (shard * id_cap + found)[add], cnt[add])
    # Each shard's misses in packed order: a stable sort by shard keeps
    # the packed order within a shard, as JAX's partition does.
    rows = torch.nonzero(live & (found < 0)).flatten()
    by = shard[rows]
    order = torch.argsort(by, stable=True)
    rows, by = rows[order], by[order]
    n_miss = torch.bincount(by, minlength=n_shards)
    rank = torch.arange(len(rows), device=dev) \
        - (torch.cumsum(n_miss, 0) - n_miss)[by]
    miss_rows = torch.full((n_shards, n), -1, dtype=torch.int32, device=dev)
    miss_rows[by, rank] = rows.to(torch.int32)
    return n_miss.to(torch.int32), miss_rows


def sharded_feed_step(table: torch.Tensor, acc: torch.Tensor,
                      packed: torch.Tensor, reset: bool):
    """sharded_feed_step_plain's result (miss_rows past each shard's
    n_miss unwritten on the card). CUDA tensors: acc.zero_() when `reset`,
    then one launch of the B7 feed kernel (csrc/sharded_feed.cu), which
    routes, probes, accumulates and compacts every shard's misses; a
    failed build or launch raises, and so do more than FEED_MAX_SHARDS
    shards. CPU tensors run sharded_feed_step_plain."""
    _check_feed(table, acc, packed)
    if table.device.type == "cpu":
        return sharded_feed_step_plain(table, acc, packed, reset)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    n_shards, cap_s = table.shape[0], table.shape[1]
    if n_shards > FEED_MAX_SHARDS:
        raise ValueError(f"the sharded feed kernel takes at most "
                         f"{FEED_MAX_SHARDS} shards, not {n_shards}")
    lib = kernels.load("sharded_feed")
    dev = table.device
    stream = torch.cuda.current_stream(dev)
    n = packed.shape[1]
    scratch = kernels.epoch_scratch(
        "sharded_feed", dev, stream,
        lib.pa_sharded_feed_scratch_words(n, n_shards), torch.int64)
    if reset:
        acc.zero_()
    n_miss = torch.empty(n_shards, dtype=torch.int32, device=dev)
    miss_rows = torch.empty((n_shards, n), dtype=torch.int32, device=dev)
    code = lib.pa_sharded_feed(
        table.data_ptr(), n_shards, cap_s, acc.data_ptr(), acc.shape[1],
        packed.data_ptr(), n, scratch.data_ptr(), n_miss.data_ptr(),
        miss_rows.data_ptr(), stream.cuda_stream)
    kernels.check_launch(lib, code, "sharded_feed")
    LAUNCHES["sharded_feed"] += 1
    return n_miss, miss_rows


class ShardedDictAggregator(DictAggregator):
    """DictAggregator with the device table and probe work split into
    n_shards home sub-tables on its one device. Counts, the miss and
    insert protocol, sketch degradation and rotation are the dictionary's;
    ids follow the per-shard miss order (shard after shard), as
    parca_agent_tpu's ShardedDictAggregator assigns them. ``n_shards``
    defaults to the number of CUDA devices (1 on the CPU);
    ``shard_of_pid`` routes each pid's keys to one home shard."""

    name = "sharded-dict"

    def __init__(self, capacity: int = 1 << 21, n_shards: int | None = None,
                 shard_of_pid=None, device: str | torch.device = "cuda",
                 **kw):
        dev = resolve_device(device)
        if n_shards is None:
            n_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards {n_shards} is not positive")
        self._n_shards = n_shards
        if capacity % n_shards:
            raise ValueError("capacity must divide by the shard count")
        cap_s = capacity // n_shards
        if cap_s & (cap_s - 1):
            raise ValueError("per-shard capacity must be a power of two")
        self._cap_s = cap_s
        # pid -> home shard (a tenant's placement), stable per pid across
        # windows: hash_rows rewrites h2's residue by it (route_h2).
        self._shard_of_pid = shard_of_pid
        super().__init__(capacity=capacity, device=dev, **kw)
        # No touch flags: the close sums the shards and packs the full
        # prefix.
        self._blk = 0
        self._n_blocks = 0
        self._touch = None
        self._touch_spare = None

    def set_shard_router(self, shard_of_pid) -> None:
        """Install the pid router before the first feed (keys inserted
        under the raw-hash rule keep their placement until a rotation)."""
        self._shard_of_pid = shard_of_pid

    def hash_rows(self, snapshot):
        h1, h2, h3 = super().hash_rows(snapshot)
        return h1, self._route_hashes(h1, h2, h3, snapshot.pids), h3

    def _route_hashes(self, h1, h2, h3, pids):
        # The one place of the h2 rewrite: hash_rows and every triple
        # computed elsewhere (capture-carried hashes, the feed's
        # representative hashing) come through here.
        if self._shard_of_pid is not None:
            return route_h2(h2, pids, self._shard_of_pid, self._n_shards)
        return h2

    # -- host-mirror placement: probe within the key's home sub-table -------

    def _home_shard(self, key: tuple) -> int:
        return key[1] % self._n_shards

    def _shard_free(self) -> np.ndarray:
        """Free slots per sub-table (a skewed h2 can fill one sub-table
        while the table as a whole is half empty)."""
        occ = self._occ.reshape(self._n_shards, self._cap_s)
        return self._cap_s - occ.sum(axis=1)

    def _check_shard_demand(self, demand: np.ndarray) -> None:
        """The raise of both room checks: new keys per sub-table against
        its free slots."""
        free = self._shard_free()
        over = np.flatnonzero(demand > free)
        if len(over):
            s = int(over[0])
            raise RuntimeError(
                f"shard sub-table {s} exhausted ({int(demand[s])} new keys "
                f"vs {int(free[s])} free of {self._cap_s} slots); construct "
                f"with a larger capacity or overflow='sketch'")

    def _check_insert_room(self, classified, seen_batch) -> None:
        if self._overflow != "raise" or not seen_batch:
            return  # sketch mode degrades per key in _try_insert_slot
        demand = np.zeros(self._n_shards, np.int64)
        for key in seen_batch:
            demand[self._home_shard(key)] += 1
        self._check_shard_demand(demand)

    def _try_insert_slot(self, key: tuple) -> int | None:
        """The first free slot at or after the key's home, wrapping within
        its home sub-table; None when the sub-table is full (the caller
        degrades the key to the sketch). One scan in numpy, not a Python
        step a slot: a full sub-table refuses every key of a skewed
        window."""
        base = self._home_shard(key) * self._cap_s
        idx = key[0] & (self._cap_s - 1)
        sub = self._occ[base:base + self._cap_s]
        for lo, hi in ((idx, self._cap_s), (0, idx)):
            if hi > lo:
                j = lo + int(sub[lo:hi].argmin())
                if not sub[j]:
                    return base + j
        return None

    def _host_insert_slot(self, key: tuple) -> int:
        slot = self._try_insert_slot(key)
        if slot is None:
            raise RuntimeError("shard sub-table unexpectedly full")
        return slot

    def _chain_dist(self, key: tuple, slot: int) -> int:
        mask = self._cap_s - 1
        within = slot - self._home_shard(key) * self._cap_s
        return (within - (key[0] & mask)) & mask

    def _probe_geometry_vec(self, h1u, h2u):
        # Chains live within the key's home sub-table (base = home *
        # cap_s), as _try_insert_slot and _chain_dist walk them a key at a
        # time.
        mask = self._cap_s - 1
        base = (h2u.astype(np.int64) % self._n_shards) * self._cap_s
        return base, h1u.astype(np.int64) & mask, mask

    def _place_new_keys_vec(self, h1n, h2n, stop):
        # A sub-table given more new keys than it has free slots cannot
        # place them all: the arbitration would walk its whole ring to
        # find that out. Give up at once; the scalar settle then takes the
        # batch, as it would after the walk.
        demand = np.bincount(h2n.astype(np.int64) % self._n_shards,
                             minlength=self._n_shards)
        if (demand > self._shard_free()).any():
            return None
        return super()._place_new_keys_vec(h1n, h2n, stop)

    def _check_insert_room_vec(self, h1n, h2n, h3n) -> None:
        if self._overflow != "raise" or not len(h2n):
            return
        self._check_shard_demand(
            np.bincount(h2n.astype(np.int64) % self._n_shards,
                        minlength=self._n_shards))

    # -- device dispatch ------------------------------------------------------

    def _ensure_device(self) -> None:
        if self._dev is None:
            table = np.zeros((self._cap, 4), np.uint32)
            table[:, 0] = self._h1
            table[:, 1] = self._h2
            table[:, 2] = self._h3
            table[:, 3] = np.where(self._occ, self._ids + 1, 0).astype(
                np.uint32)
            self._dev = self._to_device(
                table.reshape(self._n_shards, self._cap_s, 4))

    def _new_acc(self) -> torch.Tensor:
        return torch.zeros((self._n_shards, self._id_cap), dtype=torch.int32,
                           device=self.device)

    def _feed_dispatch_async(self, packed: np.ndarray, reset: bool):
        t0 = time.perf_counter()
        dev_packed = self._to_device(packed)  # the feed's one H2D
        self.timings["feed_h2d"] = time.perf_counter() - t0
        return sharded_feed_step(self._dev, self._acc, dev_packed, reset)

    def _settle_dispatch(self, handle) -> np.ndarray:
        """The miss rows of one dispatched feed, shard after shard (their
        packed positions). The n_miss fetch is the feed's one sync."""
        n_miss, miss_rows = handle
        per = n_miss.cpu().numpy()
        if not per.any():
            return np.empty(0, np.int64)
        rows = miss_rows[:, :int(per.max())].cpu().numpy()
        # Each row has one home shard: the per-shard lists are disjoint.
        return np.concatenate([rows[s, :k] for s, k in enumerate(per.tolist())
                               if k]).astype(np.int64)

    def _close_pack_dispatch(self, acc, n_fetch: int, width: int,
                             n_over_buf: int):
        return close_pack_sharded(acc, n_fetch, width, n_over_buf)

    def _dev_scatter(self, slots: np.ndarray, vals: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        self._dev[self._to_device(slots // self._cap_s),
                  self._to_device(slots % self._cap_s)] = self._to_device(vals)
