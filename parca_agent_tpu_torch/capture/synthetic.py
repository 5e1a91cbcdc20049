"""Synthetic workload generator (BASELINE configs #2 and #4).

Produces WindowSnapshots with the statistical shape of a busy machine:
a Zipf-distributed population of unique stacks over many PIDs, realistic
address-space layout (a few executable mappings per PID, leaf frames deep in
shared-library ranges), and a fraction of samples carrying kernel tails.

Deterministic given a seed — the same (seed, params) always produces the
same snapshot, so fixtures don't need to be checked in.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parca_agent_tpu_torch.capture.formats import (
    KERNEL_ADDR_START,
    MAX_STACK_DEPTH,
    STACK_SLOTS,
    MappingTable,
    WindowSnapshot,
)


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_pids: int = 1_000
    n_unique_stacks: int = 10_000
    n_rows: int | None = None        # rows in the snapshot; default = n_unique_stacks
    total_samples: int = 1_000_000   # sum of counts across rows
    mean_depth: int = 24             # mean user-stack depth
    kernel_fraction: float = 0.2     # fraction of rows with a kernel tail
    max_kernel_depth: int = 16
    mappings_per_pid: int = 4
    # Function pool per object: location entropy knob. The default makes
    # frame addresses near-unique per pid (every stack draws ~24 frames
    # from 4096 functions but a pid owns only ~n_rows/n_pids stacks) —
    # the adversarial case for location dedup. Small pools model real
    # hosts, where a pid's hot frames repeat across most of its stacks.
    n_funcs: int = 4096
    seed: int = 0


def _mapping_layout(spec: SyntheticSpec, rng: np.random.Generator):
    """Build per-PID mapping tables: one main executable + shared objects.

    Shared objects get one object id reused across PIDs (as on a real host,
    where every process maps the same libc) so build-id dedup paths see
    realistic fan-in (reference pkg/debuginfo/manager.go:116-127).
    """
    n_shared = max(1, spec.mappings_per_pid - 1)
    obj_paths = ["/app/bin/worker"] + [f"/usr/lib/libshared{i}.so" for i in range(n_shared)]
    obj_buildids = [f"{i:040x}" for i in range(1, len(obj_paths) + 1)]

    pids = np.repeat(
        np.arange(1000, 1000 + spec.n_pids, dtype=np.int32), spec.mappings_per_pid
    )
    m = len(pids)
    per = spec.mappings_per_pid

    # Main executable at a per-PID ASLR-ish base; shared objs at high bases
    # common across PIDs (same object, same offset pattern).
    exe_base = 0x0000_5500_0000_0000 + (
        rng.integers(0, 1 << 20, spec.n_pids, dtype=np.uint64) << np.uint64(12)
    )
    shared_base = 0x0000_7F00_0000_0000 + (
        np.arange(n_shared, dtype=np.uint64) << np.uint64(28)
    )

    starts = np.zeros(m, np.uint64)
    ends = np.zeros(m, np.uint64)
    offsets = np.zeros(m, np.uint64)
    objs = np.zeros(m, np.int32)
    size = np.uint64(1 << 24)  # 16 MiB of text per mapping
    for j in range(per):
        sl = slice(j, m, per)
        if j == 0:
            starts[sl] = exe_base
            objs[sl] = 0
        else:
            starts[sl] = shared_base[j - 1]
            objs[sl] = j
        ends[sl] = starts[sl] + size
        offsets[sl] = np.uint64(0x1000) * np.uint64(j)

    order = np.lexsort((starts, pids))
    return MappingTable(
        pids[order], starts[order], ends[order], offsets[order], objs[order],
        tuple(obj_paths), tuple(obj_buildids),
    ), exe_base, shared_base, size


def generate(spec: SyntheticSpec) -> WindowSnapshot:
    if spec.mappings_per_pid < 2:
        raise ValueError("mappings_per_pid must be >= 2 (exe + >=1 shared)")
    rng = np.random.default_rng(spec.seed)
    n_rows = spec.n_rows if spec.n_rows is not None else spec.n_unique_stacks
    table, exe_base, shared_base, msize = _mapping_layout(spec, rng)

    # Each unique stack belongs to one pid; pids get a Zipf share of stacks.
    pid_of_stack = rng.integers(0, spec.n_pids, spec.n_unique_stacks)
    depths = np.clip(
        rng.poisson(spec.mean_depth, spec.n_unique_stacks), 2, MAX_STACK_DEPTH - spec.max_kernel_depth
    ).astype(np.int32)

    # Frame addresses: a pool of "functions" per object; leaf-first.
    n_funcs = spec.n_funcs
    func_off = (rng.integers(0, n_funcs, (spec.n_unique_stacks, STACK_SLOTS), dtype=np.uint64)
                << np.uint64(8)) + np.uint64(0x40)
    which_obj = rng.integers(0, len(shared_base) + 1, (spec.n_unique_stacks, STACK_SLOTS))
    base = np.where(
        which_obj == 0,
        exe_base[pid_of_stack][:, None],
        shared_base[np.clip(which_obj - 1, 0, len(shared_base) - 1)],
    ).astype(np.uint64)
    addrs = base + (func_off % msize)

    # Kernel tails for a subset of stacks.
    has_kernel = rng.random(spec.n_unique_stacks) < spec.kernel_fraction
    kdepth = np.where(
        has_kernel, rng.integers(1, spec.max_kernel_depth + 1, spec.n_unique_stacks), 0
    ).astype(np.int32)
    kaddrs = (np.uint64(KERNEL_ADDR_START)
              + (rng.integers(0, 65536, (spec.n_unique_stacks, spec.max_kernel_depth),
                              dtype=np.uint64) << np.uint64(6)))

    slot = np.arange(STACK_SLOTS, dtype=np.int32)[None, :]
    stacks = np.where(slot < depths[:, None], addrs, np.uint64(0))
    # Place kernel frames directly after the user frames.
    kslot = slot - depths[:, None]
    in_kernel = (kslot >= 0) & (kslot < kdepth[:, None])
    kgather = np.take_along_axis(
        kaddrs, np.clip(kslot, 0, spec.max_kernel_depth - 1), axis=1
    )
    stacks = np.where(in_kernel, kgather, stacks)

    # Rows: exactly n_rows DISTINCT (pid, stack) pairs — what a capture-side
    # hash map hands the drain path — with Zipf-skewed counts so heavy
    # hitters exist for the sketch benchmarks. A capture map never holds
    # zero-count entries, so rows drawing zero get 1 and the excess is
    # taken back from the heaviest rows, conserving total_samples exactly.
    n_take = min(n_rows, spec.n_unique_stacks)
    if spec.total_samples < n_take:
        raise ValueError("total_samples must be >= number of distinct rows")
    if n_take == 0:
        return WindowSnapshot(
            pids=np.zeros(0, np.int32), tids=np.zeros(0, np.int32),
            counts=np.zeros(0, np.int64), user_len=np.zeros(0, np.int32),
            kernel_len=np.zeros(0, np.int32),
            stacks=np.zeros((0, STACK_SLOTS), np.uint64),
            mappings=table, time_ns=1_700_000_000_000_000_000,
        )
    uniq = rng.permutation(spec.n_unique_stacks)[:n_take]
    weights = 1.0 / np.arange(1, n_take + 1, dtype=np.float64) ** 1.1
    per_row = rng.multinomial(spec.total_samples, weights / weights.sum())
    counts = np.maximum(per_row, 1).astype(np.int64)
    excess = int(counts.sum()) - spec.total_samples
    if excess > 0:
        order = np.argsort(counts)[::-1]
        for i in order:
            take = min(excess, int(counts[i]) - 1)
            counts[i] -= take
            excess -= take
            if excess == 0:
                break

    sel = np.sort(uniq.astype(np.int64))
    pids = (1000 + pid_of_stack[sel]).astype(np.int32)
    snap = WindowSnapshot(
        pids=pids,
        tids=pids,  # main thread
        counts=counts,
        user_len=depths[sel],
        kernel_len=kdepth[sel],
        stacks=stacks[sel],
        mappings=table,
        time_ns=1_700_000_000_000_000_000,
    )
    snap.validate_padding()
    return snap
