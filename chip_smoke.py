#!/usr/bin/env python3
"""Smoke run of parca_agent_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and this checkout; imports nothing of jax or
of parca_agent_tpu. Phases, each printing one JSON line:

  1. identity  the card (nvidia-smi name and power limit, also printed as
               the raw nvidia-smi line), torch and CUDA versions
  2. build     every CUDA kernel built from csrc/ with nvcc for sm_90a
  3. kernels   each kernel held against its plain PyTorch version on the
               card at full size (table of 2^21 slots, half filled, with
               chains past the probe bound, h1-only collisions and
               empty-slot stops; 2^20 query rows with hits, misses and
               dead rows): outputs must be exactly equal. Prints each
               kernel's time (queued back to back, and with the L2
               flushed before each call), the plain version's time and
               the bound (the least time the card could take for the
               same work, from this run's data)
  4. main path the port's DictAggregator on the card over the bench's
               window (50,000 pids, 2^20 unique stacks, 5M samples): a cold
               window, then steady windows fed as 10 drains each and closed,
               then pprof for every pid. Totals and per-pid masses must
               equal the numpy CPUAggregator's on the same snapshot; every
               feed must launch the fused probe kernel.

Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device":
{...}}. Any failed phase raises and exits nonzero, with no result line.
Without a CUDA device, or without the package beside this file, it exits
nonzero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Card peaks used for the bound (NVIDIA H100 SXM data sheet): HBM3 rate,
# and the scalar (non-tensor-core) float32 rate as the operation rate of
# the probe's integer compares — no integer rate outside the tensor cores
# is published beside it.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# Phase 3 sizes: the default dictionary (--aggregator-capacity 2^21) and
# the bench's one-shot window of 2^20 rows.
CAP = 1 << 21
N_QUERY = 1 << 20
# Phase 4: bench.py's window spec (_bench_spec at 1M rows).
ROWS = 1 << 20
PIDS = 50_000
SAMPLES = 5_000_000
STEADY_WINDOWS = 3
DRAINS = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------


def time_ms(fn, reps: int, flush=None) -> float:
    """Device milliseconds of one fn() call, from CUDA events.

    Without `flush`: the mean over `reps` calls queued back to back
    between two events, behind a spin kernel that keeps the card busy
    while the host queues them, so the host's launch cost is not timed.
    With `flush`: the median over `reps` calls, each between its own
    events and each after flush() (untimed, also queued ahead)."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    if flush is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    times = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# -- phase 3 inputs ----------------------------------------------------------


def build_table(cap: int, seed: int):
    """A half-filled linear-probe table u32[cap, 4] = (h1, h2, h3, id+1)
    and its keys, placed without a Python loop: keys sorted by home slot
    take slot_i = max(home_i, slot_{i-1} + 1), which leaves every key's
    chain from its home slot fully occupied — a valid linear-probe layout.
    Home slots stay clear of the table's end so no chain wraps.

    Forced shapes: cap/1024 groups of 24 keys sharing one home slot
    (chains past the probe bound of 16), and cap/512 pairs of keys with
    EQUAL h1 and different h2/h3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = cap // 2
    n_groups, n_pairs = n // 512, n // 256
    span = cap - cap // 32
    home = rng.integers(0, span, n, dtype=np.int64)
    home[: n_groups * 24] = np.repeat(
        rng.integers(0, span, n_groups, dtype=np.int64), 24)
    hi = rng.integers(0, 1 << 32, n, dtype=np.int64) & ~np.int64(cap - 1)
    h1 = (home | hi).astype(np.uint32)
    a = n_groups * 24
    h1[a: a + n_pairs] = h1[a + n_pairs: a + 2 * n_pairs]
    home[a: a + n_pairs] = home[a + n_pairs: a + 2 * n_pairs]
    h2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    h3 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    order = np.argsort(home, kind="stable")
    ar = np.arange(n, dtype=np.int64)
    slots = np.empty(n, np.int64)
    slots[order] = np.maximum.accumulate(home[order] - ar) + ar
    assert int(slots.max()) < cap and len(np.unique(slots)) == n
    table = np.zeros((cap, 4), np.uint32)
    table[slots, 0], table[slots, 1], table[slots, 2] = h1, h2, h3
    table[slots, 3] = np.arange(1, n + 1, dtype=np.uint32)
    return table, h1, h2, h3


def build_queries(table, h1, h2, h3, n_query: int, seed: int):
    """Query lanes: 1/2 stored keys (hits, and misses past the probe
    bound), 1/8 stored h1 with a changed h3 (walk the chain, miss), 3/8
    unknown keys (mostly empty-slot stops); 1/8 of all rows dead (cnt 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_known, n_alt = n_query // 2, n_query // 8
    pick = rng.integers(0, len(h1), n_known + n_alt)
    q1 = np.concatenate([h1[pick], rng.integers(
        0, 1 << 32, n_query - n_known - n_alt, dtype=np.uint64).astype(
            np.uint32)])
    q2 = np.concatenate([h2[pick], rng.integers(
        0, 1 << 32, n_query - n_known - n_alt, dtype=np.uint64).astype(
            np.uint32)])
    q3 = np.concatenate([h3[pick[:n_known]], h3[pick[n_known:]] ^ np.uint32(1),
                         rng.integers(0, 1 << 32, n_query - n_known - n_alt,
                                      dtype=np.uint64).astype(np.uint32)])
    cnt = rng.integers(1, 100, n_query).astype(np.uint32)
    cnt[rng.random(n_query) < 0.125] = 0
    perm = rng.permutation(n_query)
    return q1[perm], q2[perm], q3[perm], cnt[perm]


def probe_work(table, q1, q2, q3, probes: int):
    """What this run's data makes the probe do, counted on the host:
    (probe steps per row, distinct table slots read, found ids)."""
    import numpy as np

    cap = len(table)
    n = len(q1)
    found = np.full(n, -1, np.int64)
    steps = np.zeros(n, np.int64)
    alive = np.arange(n)
    touched = []
    for k in range(probes):
        idx = (q1[alive].astype(np.int64) + k) & (cap - 1)
        touched.append(idx)
        steps[alive] += 1
        row = table[idx]
        occ = row[:, 3] != 0
        hit = occ & (row[:, 0] == q1[alive]) & (row[:, 1] == q2[alive]) \
            & (row[:, 2] == q3[alive])
        found[alive[hit]] = row[hit, 3].astype(np.int64) - 1
        alive = alive[occ & ~hit]
    slots = len(np.unique(np.concatenate(touched)))
    return steps, slots, found


def phase_kernels(dev) -> dict:
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import probe

    t0 = time.perf_counter()
    table, h1, h2, h3 = build_table(CAP, seed=7)
    q1, q2, q3, cnt = build_queries(table, h1, h2, h3, N_QUERY, seed=8)
    steps, slots, found_np = probe_work(table, q1, q2, q3, probe.PROBES)
    t_in = time.perf_counter() - t0

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
            dev)

    tab, d1, d2, d3, dc = (to_dev(x) for x in (table, q1, q2, q3, cnt))
    id_cap, blk = CAP // 2, 128
    live = cnt.view(np.int32) > 0
    hit_np = (found_np >= 0) & live
    shapes = {
        "hits": int(hit_np.sum()),
        "dead": int((~live).sum()),
        "misses_empty_stop": 0,
        "misses_past_bound": int(((found_np < 0) & (steps == probe.PROBES)
                                  ).sum()),
    }
    shapes["misses_empty_stop"] = int((found_np < 0).sum()) \
        - shapes["misses_past_bound"]

    # batch_probe: the exact counterpart of K1.
    got = probe.batch_probe(tab, d1, d2, d3)
    want = probe.batch_probe_plain(tab, d1, d2, d3)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("batch_probe kernel != plain version")
    if not np.array_equal(got.cpu().numpy(), found_np):
        raise AssertionError("batch_probe != host probe")

    # feed_accumulate: K1 fused with the feed's accumulate.
    outs = []
    for fn in (probe.feed_accumulate, probe.feed_accumulate_plain):
        acc = torch.zeros(id_cap, dtype=torch.int32, device=dev)
        touch = torch.zeros(id_cap // blk, dtype=torch.int32, device=dev)
        outs.append((fn(tab, acc, touch, blk, d1, d2, d3, dc), acc, touch))
    torch.cuda.synchronize()
    (f0, a0, t0_), (f1, a1, t1_) = outs
    for name, x, y in (("found_id", f0, f1), ("acc", a0, a1),
                       ("touch", t0_, t1_)):
        if not torch.equal(x, y):
            raise AssertionError(f"feed_accumulate {name}: kernel != plain")
    max_abs_err = 0

    # Timing. Warm: the 32 MB table stays in the 50 MB L2 between
    # launches, as between back-to-back drains. Cold: 128 MB written
    # between launches evicts it first.
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scrub.add_(1)

    acc = torch.zeros(id_cap, dtype=torch.int32, device=dev)
    touch = torch.zeros(id_cap // blk, dtype=torch.int32, device=dev)
    n_launch_before = dict(probe.LAUNCHES)
    bp_ms = time_ms(lambda: probe.batch_probe(tab, d1, d2, d3), 50)
    bp_cold = time_ms(lambda: probe.batch_probe(tab, d1, d2, d3), 20, flush)
    fa_ms = time_ms(lambda: probe.feed_accumulate(
        tab, acc, touch, blk, d1, d2, d3, dc), 50)
    fa_cold = time_ms(lambda: probe.feed_accumulate(
        tab, acc, touch, blk, d1, d2, d3, dc), 20, flush)
    bp_plain = time_ms(lambda: probe.batch_probe_plain(tab, d1, d2, d3), 5)
    fa_plain = time_ms(lambda: probe.feed_accumulate_plain(
        tab, acc, touch, blk, d1, d2, d3, dc), 5)
    # A steady drain's shape: one tenth of the window, padded to 2^17.
    dr = [x[: 1 << 17] for x in (d1, d2, d3, dc)]
    fa_drain = time_ms(lambda: probe.feed_accumulate(
        tab, acc, touch, blk, *dr), 50)
    # Timing launches are not main-path launches: restore the counts.
    probe.LAUNCHES.update(n_launch_before)

    # Bounds from this run's data: each input read once, each output
    # written once; table bytes are the distinct slots the probes read.
    n = N_QUERY
    n_steps = int(steps.sum())
    ids_hit = found_np[hit_np]
    uniq_ids = len(np.unique(ids_hit))
    uniq_blocks = len(np.unique(ids_hit // blk))
    bp_bytes = 12 * n + 16 * slots + 4 * n
    fa_bytes = 16 * n + 16 * slots + 4 * n + 8 * uniq_ids + 4 * uniq_blocks
    # ~6 integer ops per probe step (add, mask, 4 compares); +2 per hit.
    bp_ops = 6 * n_steps
    fa_ops = 6 * n_steps + 2 * int(hit_np.sum())

    def bound(nbytes, ops):
        b, o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
        return max(b, o) * 1e3, ("bytes" if b >= o else "operations")

    bp_bound, bp_by = bound(bp_bytes, bp_ops)
    fa_bound, fa_by = bound(fa_bytes, fa_ops)
    emit("kernels", inputs_s=t_in, cap=CAP, rows=n, shapes=shapes,
         probe_steps=n_steps, distinct_slots=slots,
         batch_probe={"equal": True, "ms": bp_ms, "ms_l2_flushed": bp_cold,
                      "plain_ms": bp_plain, "bound_ms": bp_bound,
                      "bound_by": bp_by, "bytes": bp_bytes},
         feed_accumulate={"equal": True, "ms": fa_ms,
                          "ms_l2_flushed": fa_cold,
                          "ms_drain_2e17_rows": fa_drain,
                          "plain_ms": fa_plain, "bound_ms": fa_bound,
                          "bound_by": fa_by, "bytes": fa_bytes},
         library_ms=None,
         library_note="no single PyTorch call computes a bounded "
                      "linear probe with early exit")
    return {
        "feed_accumulate": {
            "name": "feed_accumulate",
            "route": "cuda",
            "source": "parca_agent_tpu_torch/csrc/feed_probe.cu",
            "replaces": "parca_agent_tpu/aggregator/pallas_probe.py:78",
            "max_abs_err": max_abs_err,
            "ms": fa_ms,
            "plain_ms": fa_plain,
            "bound_ms": fa_bound,
            "bound_by": fa_by,
            "library_ms": None,
        },
    }


# -- phase 4 -----------------------------------------------------------------


def phase_main_path(dev, rows: int = ROWS, pids: int = PIDS,
                    steady: int = STEADY_WINDOWS) -> dict:
    """The port's main path on `dev`; returns the feed launch counts.
    Raises on any disagreement with the numpy oracle."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import probe
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.synthetic import (
        SyntheticSpec,
        generate,
    )
    from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    snap = generate(SyntheticSpec(
        n_pids=pids, n_unique_stacks=rows, n_rows=rows,
        total_samples=max(SAMPLES, rows + 1), mean_depth=24,
        kernel_fraction=0.2, seed=42))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = CPUAggregator().aggregate(snap)
    oracle_s = time.perf_counter() - t0
    want_mass = {p.pid: p.total() for p in want}
    want_vals = {p.pid: sorted(p.values.tolist()) for p in want}
    total = snap.total_samples()
    emit("main_path_setup", rows=len(snap), pids=pids, samples=total,
         generate_s=gen_s, oracle_s=oracle_s)

    agg = DictAggregator(capacity=CAP, overflow="raise", device=dev)
    t0 = time.perf_counter()
    hashes = agg.hash_rows(snap)  # the capture-carried identity triple
    hash_s = time.perf_counter() - t0

    def check(counts, profiles, label):
        if int(counts.sum()) != total:
            raise AssertionError(f"{label}: total {int(counts.sum())} != "
                                 f"{total}")
        got = {p.pid: p.total() for p in profiles}
        if got != want_mass:
            bad = [p for p in want_mass if got.get(p) != want_mass[p]][:5]
            raise AssertionError(f"{label}: per-pid mass differs, e.g. {bad}")
        for p in profiles[:: max(1, len(profiles) // 500)]:
            if sorted(p.values.tolist()) != want_vals[p.pid]:
                raise AssertionError(f"{label}: pid {p.pid} stack counts")

    # Every count to 0 just before the main path; read just after.
    probe.reset_launches()
    launches_per_feed = []

    t0 = time.perf_counter()
    before = probe.LAUNCHES["feed_accumulate"]
    counts = agg.window_counts(snap, hashes)
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches_per_feed.append(probe.LAUNCHES["feed_accumulate"] - before)
    t0 = time.perf_counter()
    profiles = agg._build_profiles(snap, counts)
    check(counts, profiles, "cold window")
    emit("cold_window", ms=cold_ms, inserts=agg.stats["inserts"],
         build_profiles_ms=(time.perf_counter() - t0) * 1e3,
         hash_s=hash_s, timings_ms={k: v * 1e3
                                    for k, v in agg.timings.items()})

    bounds = np.linspace(0, len(snap), DRAINS + 1).astype(int)
    steady_rows = []
    for w in range(steady):
        feed_ms = []
        t_win = time.perf_counter()
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            before = probe.LAUNCHES["feed_accumulate"]
            agg.feed(snap, hashes, lo=int(lo), hi=int(hi))
            launches_per_feed.append(probe.LAUNCHES["feed_accumulate"]
                                     - before)
            feed_ms.append(agg.timings["feed_dispatch"] * 1e3)
        t_close = time.perf_counter()
        counts = agg.close_window(copy=True)
        close_ms = (time.perf_counter() - t_close) * 1e3
        feed_close_s = time.perf_counter() - t_win
        profiles = agg._build_profiles(snap, counts)
        profiles_ms = (time.perf_counter() - t_close) * 1e3
        last = w == steady - 1
        if last:
            # pprof for every pid of the window.
            blobs = [build_pprof(p) for p in profiles]
        else:
            blobs = [build_pprof(p) for p in profiles[:: len(profiles) // 64]]
        to_pprof_ms = (time.perf_counter() - t_close) * 1e3
        window_ms = (time.perf_counter() - t_win) * 1e3
        check(counts, profiles, f"steady window {w}")
        for b, p in list(zip(blobs, profiles if last else
                             profiles[:: len(profiles) // 64]))[:: 50]:
            parsed = parse_pprof(b)
            if sum(v[0] for _, v, _ in parsed.samples) != p.total():
                raise AssertionError(f"pprof of pid {p.pid} does not parse "
                                     "back to its mass")
        steady_rows.append({
            "window": w, "feed_dispatch_ms": feed_ms,
            "feed_dispatch_ms_sum": sum(feed_ms), "close_ms": close_ms,
            "close_to_profiles_ms": profiles_ms,
            "window_to_pprof_ms": to_pprof_ms,
            "pprof_pids": len(blobs), "window_ms": window_ms,
            "inserts": agg.stats["inserts"],
            "delta_closes": agg.stats.get("delta_closes", 0),
            "fetch_bytes_last": agg.stats.get("fetch_bytes_last"),
            "feeds_and_close_ms": feed_close_s * 1e3,
            "samples_per_s": total / feed_close_s,
            "timings_ms": {k: v * 1e3 for k, v in agg.timings.items()},
        })
        emit("steady_window", **steady_rows[-1])
    launches = dict(probe.LAUNCHES)
    if min(launches_per_feed) < 1:
        raise AssertionError(f"a feed launched no probe kernel: "
                             f"{launches_per_feed}")
    emit("main_path", launches=launches, feeds=len(launches_per_feed),
         launches_per_feed=launches_per_feed)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (HERE / "parca_agent_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: parca_agent_tpu_torch is not beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    emit("identity", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         capability=list(torch.cuda.get_device_capability(0)))

    from parca_agent_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    report = kernels.build()
    emit("build", s=time.perf_counter() - t0, arch=list(kernels.ARCH_FLAGS),
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln
                    or "Compiling" in ln] for k, v in report.items()})

    rows = phase_kernels(dev)
    launches = phase_main_path(dev)
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] < 1:
            raise AssertionError(f"{name} never launched on the main path")
    emit("done", total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
        for row in rows.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
