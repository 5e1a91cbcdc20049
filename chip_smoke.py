#!/usr/bin/env python3
"""Smoke run of parca_agent_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--k1-reference FEED_PROBE_CU]
                          [--rh-reference ROW_HASH_CU ...]

Needs one CUDA device, nvcc and this checkout; imports nothing of jax or
of parca_agent_tpu. Phases, each printing one JSON line:

  1. identity  the card (nvidia-smi name and power limit, also printed as
               the raw nvidia-smi line), torch and CUDA versions
  2. build     every CUDA kernel built from csrc/ with nvcc for sm_90a;
               nvcc's version, ptxas's report and the location table's
               compare-and-swap instructions
  3. kernels   K1 held against its plain PyTorch version on the card at
               full size (table of 2^21 slots, half filled, with chains
               past the probe bound, h1-only collisions and empty-slot
               stops; 2^20 query rows with hits, misses and dead rows) and
               at a steady drain's 2^17 rows: outputs must be exactly
               equal. Prints the kernel's time (queued back to back, and
               with the L2 flushed before each call), the plain version's
               time and the bound (the least time the card could take for
               the same work, from this run's data) at both shapes
  4. main path the port's DictAggregator on the card over the bench's
               window (50,000 pids, 2^20 unique stacks, 5M samples): a cold
               window, then steady windows fed as 10 drains each and closed,
               then pprof for every pid of the last one. Totals and
               per-pid masses must equal the numpy CPUAggregator's on the
               same snapshot; every feed must launch the fused probe
               kernel. Then the probe-step histogram of the window's rows
               in the table, and K1 on that table at one drain's rows,
               against its plain version, timed, with its bound.
  5. one shot  the port's TPUAggregator (--aggregator tpu) on the same
               window: the hash arm twice, the second run checked against
               the same oracle (with per-pid location counts) and its
               row_hash and loc_table launches counted; the sort arm's 10
               outputs and a sample's pprof bytes equal to the hash arm's;
               both kernels against their plain versions at the window's
               shapes (the location table's dense list re-sorted), timed,
               with their bounds, the bytes the row hash fetches, the
               host cost of its wrapper and the table's probe-step
               histogram; the CLI entry; and each dedup arm's device time,
               and the row hash against its plain version, timed, on two
               windows below the aggregator's location warning threshold.

With --k1-reference, a second build of K1 from that source (one with
csrc/feed_probe.cu's C interface, e.g. an earlier commit's) is held
against the kernel and timed in turns with it, in phases 3 and 4. With
--rh-reference (repeatable), each source with csrc/row_hash.cu's C
interface is built, held against the plain version and timed in turns
with the row hash kernel at phase 5's three windows.

Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device":
{...}}. Any failed phase raises and exits nonzero, with no result line.
Without a CUDA device, or without the package beside this file, it exits
nonzero at once.
"""

from __future__ import annotations

import argparse
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
# Phase 5: timed runs of each dedup arm on each small window.
ARM_REPS = 5


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


def time_turns(fns: dict, reps: int, flush=None) -> dict:
    """name -> [ms]: each fn timed by time_ms; two fns in turns (a, b, b,
    a), so that neither gains from its place in the run."""
    names = list(fns)
    order = names if len(names) == 1 else names + names[::-1]
    out = {name: [] for name in names}
    for name in order:
        out[name].append(time_ms(fns[name], reps, flush))
    return out


def bound(nbytes: int, ops: int):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the scalar rate."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


# -- reference builds ------------------------------------------------------


def load_reference(name: str, path: str):
    """The library built from `path`, another source with csrc/<name>.cu's
    C interface (kernels.SIGNATURES[name], e.g. an earlier commit's), built
    as csrc/ is built and typed as the port's own."""
    import ctypes
    import hashlib

    from parca_agent_tpu_torch.ops import kernels

    src = Path(path).resolve()
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = kernels.BUILD_DIR / f"lib{name}-ref-{digest}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(kernels.nvcc_command(src, out), check=True,
                       capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in kernels.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def load_k1_reference(path: str):
    """(batch_probe, feed_accumulate) of a reference build of
    csrc/feed_probe.cu, called as the port's wrappers call theirs;
    launches are not counted."""
    import torch

    from parca_agent_tpu_torch.ops import kernels

    lib = load_reference("feed_probe", path)

    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def batch_probe(table, h1, h2, h3):
        found = torch.empty(h1.shape[0], dtype=torch.int32,
                            device=table.device)
        kernels.check_launch(lib, lib.pa_batch_probe(
            table.data_ptr(), table.shape[0], h1.data_ptr(), h2.data_ptr(),
            h3.data_ptr(), found.data_ptr(), h1.shape[0], stream(table)),
            "reference batch_probe")
        return found

    def feed_accumulate(table, acc, touch, blk, h1, h2, h3, cnt):
        found = torch.empty(h1.shape[0], dtype=torch.int32,
                            device=table.device)
        kernels.check_launch(lib, lib.pa_feed_accumulate(
            table.data_ptr(), table.shape[0], acc.data_ptr(), acc.shape[0],
            touch.data_ptr(), touch.shape[0], max(blk, 1), h1.data_ptr(),
            h2.data_ptr(), h3.data_ptr(), cnt.data_ptr(), found.data_ptr(),
            h1.shape[0], stream(table)), "reference feed_accumulate")
        return found

    return batch_probe, feed_accumulate


def load_rh_reference(path: str):
    """row_hash of a reference build of csrc/row_hash.cu, called as the
    port's wrapper calls its own; launches are not counted."""
    import torch

    from parca_agent_tpu_torch.ops import kernels, row_hash

    lib = load_reference("row_hash", path)

    def rh(shi, slo, pid, ulen, klen):
        n, slots = shi.shape
        coefs, b0, b1 = row_hash._coef_table(shi.device, slots)
        h1 = torch.empty(n, dtype=torch.int32, device=shi.device)
        h2 = torch.empty(n, dtype=torch.int32, device=shi.device)
        kernels.check_launch(lib, lib.pa_row_hash(
            shi.data_ptr(), slo.data_ptr(), pid.data_ptr(), ulen.data_ptr(),
            klen.data_ptr(), n, slots, coefs.data_ptr(), b0, b1,
            h1.data_ptr(), h2.data_ptr(),
            torch.cuda.current_stream(shi.device).cuda_stream),
            "reference row_hash")
        return h1, h2

    return rh


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


def phase_kernels(dev, ref=None) -> dict:
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

    # Both kernels (and the reference build's) exactly equal to their
    # plain versions at full size and at a steady drain's shape (one tenth
    # of the window, padded to 2^17 rows).
    drain = 1 << 17
    impls = {"kernel": (probe.batch_probe, probe.feed_accumulate)}
    if ref is not None:
        impls["reference"] = ref
    for label, (bp_fn, fa_fn) in impls.items():
        for rows in (N_QUERY, drain):
            d = [x[:rows] for x in (d1, d2, d3, dc)]
            got = bp_fn(tab, *d[:3])
            want = probe.batch_probe_plain(tab, *d[:3])
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"batch_probe {label} ({rows} rows) "
                                     "!= plain version")
            if not np.array_equal(got.cpu().numpy(), found_np[:rows]):
                raise AssertionError(f"batch_probe {label} != host probe")
            outs = []
            for fn in (fa_fn, probe.feed_accumulate_plain):
                acc = torch.zeros(id_cap, dtype=torch.int32, device=dev)
                touch = torch.zeros(id_cap // blk, dtype=torch.int32,
                                    device=dev)
                outs.append((fn(tab, acc, touch, blk, *d), acc, touch))
            torch.cuda.synchronize()
            (f0, a0, t0_), (f1, a1, t1_) = outs
            for name, x, y in (("found_id", f0, f1), ("acc", a0, a1),
                               ("touch", t0_, t1_)):
                if not torch.equal(x, y):
                    raise AssertionError(f"feed_accumulate {label} {name} "
                                         f"({rows} rows) != plain")
    max_abs_err = 0

    # Timing. Warm: the 32 MB table stays in the 50 MB L2 between
    # launches, as between back-to-back drains. Cold: 128 MB written
    # between launches evicts it first. With a reference build, each
    # metric is timed in turns (kernel, reference, reference, kernel) and
    # each reports its lower time.
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        scrub.add_(1)

    acc = torch.zeros(id_cap, dtype=torch.int32, device=dev)
    touch = torch.zeros(id_cap // blk, dtype=torch.int32, device=dev)
    dr = [x[:drain] for x in (d1, d2, d3, dc)]
    n_launch_before = dict(probe.LAUNCHES)

    def turns(call, reps, flush=None):
        return time_turns({label: (lambda f=f: call(*f))
                           for label, f in impls.items()}, reps, flush)

    timed = {
        "batch_probe_ms": turns(lambda bp, fa: bp(tab, d1, d2, d3), 50),
        "batch_probe_ms_l2_flushed": turns(
            lambda bp, fa: bp(tab, d1, d2, d3), 20, flush),
        "feed_accumulate_ms": turns(lambda bp, fa: fa(
            tab, acc, touch, blk, d1, d2, d3, dc), 50),
        "feed_accumulate_ms_l2_flushed": turns(lambda bp, fa: fa(
            tab, acc, touch, blk, d1, d2, d3, dc), 20, flush),
        "feed_accumulate_ms_drain_2e17_rows": turns(
            lambda bp, fa: fa(tab, acc, touch, blk, *dr), 50),
    }
    mine = {k: min(v["kernel"]) for k, v in timed.items()}
    bp_ms, bp_cold = mine["batch_probe_ms"], \
        mine["batch_probe_ms_l2_flushed"]
    fa_ms, fa_cold = mine["feed_accumulate_ms"], \
        mine["feed_accumulate_ms_l2_flushed"]
    fa_drain = mine["feed_accumulate_ms_drain_2e17_rows"]
    bp_plain = time_ms(lambda: probe.batch_probe_plain(tab, d1, d2, d3), 5)
    fa_plain = time_ms(lambda: probe.feed_accumulate_plain(
        tab, acc, touch, blk, d1, d2, d3, dc), 5)
    fa_drain_plain = time_ms(lambda: probe.feed_accumulate_plain(
        tab, acc, touch, blk, *dr), 5)
    # Timing launches are not main-path launches: restore the counts.
    probe.LAUNCHES.update(n_launch_before)

    # Bounds from this run's data: each input read once, each output
    # written once; table bytes are the distinct slots the probes read.
    def fa_work(rows: int):
        st, sl, fd = probe_work(table, q1[:rows], q2[:rows], q3[:rows],
                                probe.PROBES)
        hit = (fd >= 0) & live[:rows]
        ids = fd[hit]
        # (h1, h2, h3) and found a row, cnt only where the probe hits
        # (the kernel reads it after a hit), acc read and written a hit id.
        nbytes = 16 * rows + 4 * int((fd >= 0).sum()) + 16 * sl \
            + 8 * len(np.unique(ids)) + 4 * len(np.unique(ids // blk))
        # ~6 integer ops per probe step (add, mask, 4 compares); +2 a hit.
        return nbytes, 6 * int(st.sum()) + 2 * int(hit.sum())

    n = N_QUERY
    n_steps = int(steps.sum())
    bp_bytes = 12 * n + 16 * slots + 4 * n
    bp_ops = 6 * n_steps
    fa_bytes, fa_ops = fa_work(n)
    fad_bytes, fad_ops = fa_work(drain)

    bp_bound, bp_by = bound(bp_bytes, bp_ops)
    fa_bound, fa_by = bound(fa_bytes, fa_ops)
    fad_bound, fad_by = bound(fad_bytes, fad_ops)
    emit("kernels", inputs_s=t_in, cap=CAP, rows=n, shapes=shapes,
         probe_steps=n_steps, distinct_slots=slots,
         probe_step_hist=np.bincount(steps).tolist(),
         ms_turns=timed,
         batch_probe={"equal": True, "ms": bp_ms, "ms_l2_flushed": bp_cold,
                      "plain_ms": bp_plain, "bound_ms": bp_bound,
                      "bound_by": bp_by, "bytes": bp_bytes},
         feed_accumulate={"equal": True, "ms": fa_ms,
                          "ms_l2_flushed": fa_cold,
                          "ms_drain_2e17_rows": fa_drain,
                          "bound_ms_drain_2e17_rows": fad_bound,
                          "bound_by_drain": fad_by,
                          "bytes_drain": fad_bytes,
                          "plain_ms_drain_2e17_rows": fa_drain_plain,
                          "plain_ms": fa_plain, "bound_ms": fa_bound,
                          "bound_by": fa_by, "bytes": fa_bytes},
         library_ms=None,
         library_note="no single PyTorch call computes a bounded "
                      "linear probe with early exit",
         **({"reference": {k: min(v["reference"])
                           for k, v in timed.items()}} if ref else {}))
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


def window_setup(rows: int = ROWS, pids: int = PIDS):
    """bench.py's window (_bench_spec at 1M rows, seed 42) and the numpy
    CPUAggregator's profiles of it: the input and the oracle of both main
    paths."""
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.capture.synthetic import (
        SyntheticSpec,
        generate,
    )

    t0 = time.perf_counter()
    snap = generate(SyntheticSpec(
        n_pids=pids, n_unique_stacks=rows, n_rows=rows,
        total_samples=max(SAMPLES, rows + 1), mean_depth=24,
        kernel_fraction=0.2, seed=42))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = CPUAggregator().aggregate(snap)
    oracle_s = time.perf_counter() - t0
    emit("main_path_setup", rows=len(snap), pids=pids,
         samples=snap.total_samples(), generate_s=gen_s, oracle_s=oracle_s)
    return snap, want


def check_profiles(label: str, snap, want, profiles, sample: int = 500,
                   locations: bool = False) -> None:
    """Raise unless `profiles` hold the window's total, the oracle's mass
    for every pid, and the oracle's sorted stack counts (and, with
    `locations`, its location count) for a sample of pids."""
    total = snap.total_samples()
    got_total = sum(p.total() for p in profiles)
    if got_total != total:
        raise AssertionError(f"{label}: total {got_total} != {total}")
    want_by_pid = {p.pid: p for p in want}
    got = {p.pid: p.total() for p in profiles}
    if got != {p: w.total() for p, w in want_by_pid.items()}:
        bad = [p for p, w in want_by_pid.items()
               if got.get(p) != w.total()][:5]
        raise AssertionError(f"{label}: per-pid mass differs, e.g. {bad}")
    for p in profiles[:: max(1, len(profiles) // sample)]:
        w = want_by_pid[p.pid]
        if sorted(p.values.tolist()) != sorted(w.values.tolist()):
            raise AssertionError(f"{label}: pid {p.pid} stack counts")
        if locations and p.n_locations != w.n_locations:
            raise AssertionError(f"{label}: pid {p.pid} has {p.n_locations} "
                                 f"locations, the oracle {w.n_locations}")


def phase_main_path(dev, snap, want, steady: int = STEADY_WINDOWS,
                    ref=None) -> dict:
    """The dict main path on `dev` over `snap`; returns its kernels'
    launch counts. Raises on any disagreement with the numpy oracle."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import probe
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    total = snap.total_samples()
    agg = DictAggregator(capacity=CAP, overflow="raise", device=dev)
    t0 = time.perf_counter()
    hashes = agg.hash_rows(snap)  # the capture-carried identity triple
    hash_s = time.perf_counter() - t0

    def check(counts, profiles, label):
        if int(counts.sum()) != total:
            raise AssertionError(f"{label}: total {int(counts.sum())} != "
                                 f"{total}")
        check_profiles(label, snap, want, profiles)

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
        # pprof for every pid of the last window, for every 64th before.
        last = w == steady - 1
        sample = profiles if last else profiles[:: len(profiles) // 64]
        blobs = [build_pprof(p) for p in sample]
        to_pprof_ms = (time.perf_counter() - t_close) * 1e3
        window_ms = (time.perf_counter() - t_win) * 1e3
        check(counts, profiles, f"steady window {w}")
        for b, p in list(zip(blobs, sample))[:: 50]:
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
    launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"]}
    if min(launches_per_feed) < 1:
        raise AssertionError(f"a feed launched no probe kernel: "
                             f"{launches_per_feed}")
    # How far the window's rows walk in the dictionary's table (the host
    # mirror of the device table, at this window's load): slots read a
    # row, and rounds of the probe kernel's group a row.
    table = np.zeros((agg._cap, 4), np.uint32)
    table[:, 0], table[:, 1], table[:, 2] = agg._h1, agg._h2, agg._h3
    table[:, 3] = np.where(agg._occ, agg._ids + 1, 0).astype(np.uint32)
    steps, _slots, _found = probe_work(table, *hashes, probe.PROBES)
    emit("main_path", launches=launches, feeds=len(launches_per_feed),
         launches_per_feed=launches_per_feed,
         table_load=float(agg._occ.mean()),
         probe_step_hist=np.bincount(steps).tolist())
    drain_k1(dev, agg, table, snap, hashes, int(bounds[0]), int(bounds[1]),
             ref)
    return launches


def drain_k1(dev, agg, table, snap, hashes, lo: int, hi: int,
             ref=None) -> None:
    """K1 (feed_accumulate) on the main path's own device table, at one
    steady drain: the window's rows lo:hi packed as feed() packs them
    (padded to a power of two with dead rows). The kernel (and the
    reference build) against the plain version, then timed (in turns with
    the reference) beside the plain version and the bound of this drain's
    data."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import probe

    nd = hi - lo
    n_pad = 1 << max(4, (nd - 1).bit_length())
    packed = np.zeros((4, n_pad), np.uint32)
    for k in range(3):
        packed[k, :nd] = hashes[k][lo:hi]
    packed[3, :nd] = snap.counts[lo:hi].astype(np.uint32)
    lanes = [torch.from_numpy(packed[k].view(np.int32)).to(dev)
             for k in range(4)]
    blk = agg._blk
    n_blocks = agg._n_blocks

    def run(fn):
        acc = torch.zeros(agg._id_cap, dtype=torch.int32, device=dev)
        touch = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
        return fn(agg._dev, acc, touch, blk, *lanes), acc, touch

    impls = {"kernel": probe.feed_accumulate}
    if ref is not None:
        impls["reference"] = ref[1]
    want = run(probe.feed_accumulate_plain)
    for label, fn in impls.items():
        got = run(fn)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"feed_accumulate {label} != plain at the "
                                 "main path's drain")
    acc = torch.zeros(agg._id_cap, dtype=torch.int32, device=dev)
    touch = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    saved = dict(probe.LAUNCHES)
    timed = time_turns({label: (lambda fn=fn: fn(
        agg._dev, acc, touch, blk, *lanes)) for label, fn in impls.items()},
        50)
    plain_ms = time_ms(lambda: probe.feed_accumulate_plain(
        agg._dev, acc, touch, blk, *lanes), 5)
    probe.LAUNCHES.update(saved)
    steps, slots, found = probe_work(table, *packed[:3], probe.PROBES)
    hit = (found >= 0) & (packed[3].view(np.int32) > 0)
    ids = found[hit]
    # As phase 3 counts it: 16 B a row, 4 B of cnt a row the probe finds.
    nbytes = 16 * n_pad + 4 * int((found >= 0).sum()) + 16 * slots \
        + 8 * len(np.unique(ids)) + 4 * len(np.unique(ids // blk))
    b_ms, b_by = bound(nbytes, 6 * int(steps.sum()) + 2 * int(hit.sum()))
    emit("main_path_drain_k1", rows=nd, n_pad=n_pad, hits=int(hit.sum()),
         probe_step_hist=np.bincount(steps).tolist(), ms_turns=timed,
         ms=min(timed["kernel"]), plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, bytes=nbytes, equal=True,
         **({"reference_ms": min(timed["reference"])} if ref else {}))


# -- phase 5 -----------------------------------------------------------------


def row_hash_fetch(depth, slots: int) -> dict:
    """Bytes each row hash design fetches at these depths, in 32-byte
    sectors of 8 frames: "live_sectors" reads only the sectors that hold
    a row's live frames (the parent kernel; the header-first variant),
    "step0_whole" reads frames 0-31 of both halves of every row before it
    knows the depth, then the live sectors past them (the shipped
    kernel). Both add 12 B of header and 8 B of hashes a row."""
    d = depth.long().clamp(0, slots)
    head = 20 * d.numel()
    first = min(slots, 32)
    return {
        "live_sectors": head + 64 * int(((d + 7) // 8).sum()),
        "step0_whole": head + d.numel() * 8 * first
        + 64 * int((((d - first).clamp_min(0) + 7) // 8).sum()),
    }


def row_hash_turns(args, impls: dict, reps: int) -> dict:
    """Every row hash build of `impls` (label -> fn) held bit for bit
    against row_hash_plain on one window's operands (pack_window_inputs'
    order), then timed in turns, with the bound and the bytes each
    design fetches. Launches made here are not counted."""
    import torch

    from parca_agent_tpu_torch.ops import row_hash

    pid, _cnt, ulen, klen, shi, slo = args[:6]
    want = row_hash.row_hash_plain(shi, slo, pid, ulen, klen)
    saved = dict(row_hash.LAUNCHES)
    for label, fn in impls.items():
        got = fn(shi, slo, pid, ulen, klen)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"row_hash {label} != plain version "
                                 f"({shi.shape[0]} rows)")
    timed = time_turns({label: (lambda fn=fn: fn(shi, slo, pid, ulen, klen))
                        for label, fn in impls.items()}, reps)
    row_hash.LAUNCHES.update(saved)
    depth = ulen.long() + klen.long()
    frames, n = int(depth.sum()), shi.shape[0]
    # Each row's live frames (8 B) and header (12 B) read, 8 B of hashes
    # written; 2 families x 2 lanes x (multiply + add) a frame.
    nbytes = 8 * frames + 20 * n
    b_ms, b_by = bound(nbytes, 8 * frames + 20 * n)
    return {"rows": n, "live_frames": frames, "equal": list(impls),
            "ms": {label: min(v) for label, v in timed.items()},
            "ms_turns": timed, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes,
            "fetched_bytes": row_hash_fetch(depth, shi.shape[1])}


def row_hash_host_cost(dev, args, reps: int = 200) -> dict:
    """What window_program's row_hash stage holds besides the kernel. The
    program records the stage's start event with the card idle, so the
    stage is the wrapper's host cost up to the launch, then the kernel.

    host_us: host microseconds a call of the wrapper and of each of its
    parts, each loop of `reps` calls queued behind a spin kernel, so the
    card never waits on the host and the host clock times the host alone
    (`covered`: the spin outlasted every loop). Then CUDA events around
    calls made after the card idled 20 ms (medians of 9): stage_idle_ms,
    one wrapper call, as the program reads it (host_us_after_idle: that
    call's host time); stage_idle_raw_ms, the bare C launch instead of the wrapper
    (host_us_raw_after_idle); wake_ms, a spin of 1,000 cycles instead, and
    stage_after_wake_ms, a wrapper call behind that spin; stage_busy_ms,
    a wrapper call behind a spin that outlasts the host's call. Launches
    made here are not counted."""
    import torch

    from parca_agent_tpu_torch.ops import kernels, row_hash

    pid, _cnt, ulen, klen, shi, slo = args[:6]
    n, slots = shi.shape
    lib = kernels.load("row_hash")
    coefs, b0, b1 = row_hash._coef_table(dev, slots)
    h1, h2 = (torch.empty(n, dtype=torch.int32, device=dev)
              for _ in range(2))
    ptrs = [x.data_ptr() for x in (shi, slo, pid, ulen, klen)]
    out_ptrs = [h1.data_ptr(), h2.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        row_hash.row_hash(shi, slo, pid, ulen, klen)

    def raw():
        lib.pa_row_hash(*ptrs, n, slots, coefs.data_ptr(), b0, b1,
                        *out_ptrs, stream)

    parts = {
        "row_hash": call,
        "check": lambda: row_hash._check(shi, slo, pid, ulen, klen),
        "load": lambda: kernels.load("row_hash"),
        "coef_table": lambda: row_hash._coef_table(dev, slots),
        "empty_x2": lambda: (torch.empty(n, dtype=torch.int32, device=dev),
                             torch.empty(n, dtype=torch.int32, device=dev)),
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_launch": raw,
    }
    saved = dict(row_hash.LAUNCHES)
    host_us, covered = {}, True
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        spin = torch.cuda.Event()
        spin.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us[name] = (time.perf_counter() - t0) / reps * 1e6
        covered &= not spin.query()
        torch.cuda.synchronize()

    def after_idle(first, second):
        t1, t2, host = [], [], []
        for _ in range(9):
            torch.cuda.synchronize()
            time.sleep(0.02)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            t0 = time.perf_counter()
            first()
            host.append((time.perf_counter() - t0) * 1e6)
            ev[1].record()
            second()
            ev[2].record()
            ev[2].synchronize()
            t1.append(ev[0].elapsed_time(ev[1]))
            t2.append(ev[1].elapsed_time(ev[2]))
        return sorted(t1)[4], sorted(t2)[4], sorted(host)[4]

    out = {"host_us": host_us, "covered": covered, "reps": reps}
    out["stage_idle_ms"], _, out["host_us_after_idle"] = after_idle(
        call, lambda: None)
    out["stage_idle_raw_ms"], _, out["host_us_raw_after_idle"] = \
        after_idle(raw, lambda: None)
    out["wake_ms"], out["stage_after_wake_ms"], _ = after_idle(
        lambda: torch.cuda._sleep(1000), call)
    _, out["stage_busy_ms"], _ = after_idle(
        lambda: torch.cuda._sleep(5_000_000), call)
    row_hash.LAUNCHES.update(saved)
    return out


def dedup_arms(dev, spec, rh_impls: dict, reps: int = None) -> dict:
    """window_program's device time with dedup "hash" and "sort" on one
    packed window, the arms alternating, after one untimed run of each
    whose 10 outputs must be equal. Per arm: the median of the stage
    sums, every run's sum, and the stages of the median run. Then the
    row hash builds of `rh_impls` on the window (row_hash_turns)."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import tpu
    from parca_agent_tpu_torch.capture.synthetic import generate

    reps = ARM_REPS if reps is None else reps
    snap = tpu._coalesce_snapshot_rows(generate(spec))
    host, dims = tpu.pack_window_inputs(snap)
    args = tpu.to_device(host, dev)
    runs = {"hash": [], "sort": []}
    outs = {}
    for rep in range(reps + 1):
        for dedup in runs:
            clock = tpu.StageClock(dev)
            out = tpu.window_program(*args, dedup=dedup, clock=clock, **dims)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if rep == 0:
                outs[dedup] = [x.cpu() for x in out]
            else:
                runs[dedup].append(clock.read_ms())
    if not all(torch.equal(a, b) for a, b in zip(outs["hash"],
                                                 outs["sort"])):
        raise AssertionError("dedup arms disagree on a small window")
    n_locs = int(outs["hash"][1])
    if n_locs > dims["l_cap"]:
        raise AssertionError(f"{n_locs} locations over l_cap "
                             f"{dims['l_cap']}")
    row = {"rows": len(snap), "n_locs": n_locs,
           "live_frames": int((host[2].astype(np.int64)
                               + host[3].astype(np.int64)).sum()),
           "f_cap": dims["f_cap"], "l_cap": dims["l_cap"]}
    for dedup, stages in runs.items():
        totals = [sum(st.values()) for st in stages]
        mid = sorted(range(len(totals)), key=totals.__getitem__)[
            len(totals) // 2]
        row[dedup] = {"device_ms": totals[mid], "device_ms_runs": totals,
                      "stages_ms": stages[mid]}
    row["faster_arm"] = min(("hash", "sort"),
                            key=lambda d: row[d]["device_ms"])
    row["row_hash"] = row_hash_turns(args, rh_impls, 50)
    return row


def phase_one_shot(dev, snap, want, rh_refs=None) -> dict:
    """The one-shot aggregator (--aggregator tpu) on `dev` over the same
    window: (b) the hash arm twice, the second run checked against the
    oracle with its kernel launches counted; (c) the sort arm's outputs
    and pprof against the hash arm's; (a) both kernels against their
    plain versions at the window's shapes, timed (the row hash in turns
    with the reference builds `rh_refs`, label -> fn, at this window and
    at (e)'s two), with the row hash stage's host cost; (d) the CLI
    entry; (e) the dedup arms on two windows below the location warning
    threshold. Returns the kernel rows of row_hash and loc_table."""
    import tempfile

    import numpy as np
    import torch

    from parca_agent_tpu_torch import cli
    from parca_agent_tpu_torch.aggregator import probe, tpu
    from parca_agent_tpu_torch.ops import row_hash
    from parca_agent_tpu_torch.ops.hashing import u32_wide
    from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof

    def sync():
        torch.cuda.synchronize(dev)

    def ms(seconds: dict) -> dict:
        return {k: v * 1e3 for k, v in seconds.items()}

    # (b) The main path: the first run pays the kernels' load; counts go
    # to 0 just before the second run and are read just after it.
    agg = tpu.TPUAggregator(dedup="hash", device=dev)
    t0 = time.perf_counter()
    agg.aggregate(snap)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    probe.reset_launches()
    row_hash.reset_launches()
    t0 = time.perf_counter()
    profiles = agg.aggregate(snap)
    sync()
    window_ms = (time.perf_counter() - t0) * 1e3
    launches = {"row_hash": row_hash.LAUNCHES["row_hash"],
                "loc_table": probe.LAUNCHES["loc_table"]}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the one-shot window never launched "
                                 f"{name}")
    check_profiles("one-shot hash arm", snap, want, profiles,
                   locations=True)
    stats = dict(agg.stats)
    emit("one_shot_window", first_window_ms=first_ms, window_ms=window_ms,
         launches=launches, host_ms=ms(agg.timings),
         device_ms=agg.device_ms, profiles=len(profiles), **stats)

    # (c) The sort arm: the same 10 outputs, bit for bit, and pprof bytes.
    snap_h, outs_h = agg.window_outputs(snap)
    agg_s = tpu.TPUAggregator(dedup="sort", device=dev)
    snap_s, outs_s = agg_s.window_outputs(snap)
    for i, (a, b) in enumerate(zip(outs_h, outs_s)):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"sort arm output {i} != hash arm's")
    profiles_s = agg_s._build_profiles(snap_s, snap_s.mappings,
                                       int(outs_s[0]), int(outs_s[1]),
                                       *outs_s[2:])
    pick = list(range(0, len(profiles), max(1, len(profiles) // 64)))[:64]
    for i in pick:
        if build_pprof(profiles[i], compress=False) != \
                build_pprof(profiles_s[i], compress=False):
            raise AssertionError(f"pid {profiles[i].pid}: sort arm pprof "
                                 "bytes != hash arm's")
    emit("one_shot_sort_arm", outputs_equal=10, pprof_pids_equal=len(pick),
         host_ms=ms(agg_s.timings), device_ms=agg_s.device_ms)

    # (a) The kernels against their plain versions, at the window's shapes.
    host, dims = tpu.pack_window_inputs(snap_h, l_cap=stats["l_cap"])
    args = tpu.to_device(host, dev)
    pid, cnt, ulen, klen, shi, slo, valid = args[:7]
    rh_impls = {"kernel": row_hash.row_hash, **(rh_refs or {})}
    rh_row = row_hash_turns(args, rh_impls, 20)
    rh_row["host"] = row_hash_host_cost(dev, args)
    rh_row["program_stage_ms"] = agg.device_ms["row_hash"]
    rh = row_hash.row_hash(shi, slo, pid, ulen, klen)
    (_, out_pid, out_ulen, out_klen, out_shi, out_slo, _values,
     group_live) = tpu.stack_dedup(pid, cnt, ulen, klen, shi, slo, valid,
                                   *rh, n_pad=dims["n_pad"])
    fpid, fhi, flo, _fsrc = tpu.compact_frames(
        out_pid, out_shi, out_slo, out_ulen + out_klen, group_live,
        f_cap=dims["f_cap"])
    l_cap = dims["l_cap"]
    cap_loc = 2 * l_cap
    lt = probe.build_loc_table(fpid, fhi, flo, None, cap_loc, l_cap)
    lt_plain = probe.build_loc_table_plain(fpid, fhi, flo, None, cap_loc,
                                           l_cap)
    sync()
    slot, epid, ehi, elo, eslot, n_ent = lt
    live, placed = fpid != -1, slot >= 0
    if not torch.equal(placed, lt_plain[0] >= 0) or \
            not torch.equal(placed, live):
        raise AssertionError("loc_table: the -1 set differs from the plain "
                             "version's, or a live lane did not place")
    n_entries = int(n_ent[0])
    if n_entries != int(lt_plain[5][0]) or n_entries > l_cap:
        raise AssertionError(f"loc_table: {n_entries} entries, the plain "
                             f"version {int(lt_plain[5][0])}, l_cap {l_cap}")
    entry = torch.full((cap_loc + 1,), -1, dtype=torch.int64, device=dev)
    entry[eslot[:n_entries].long()] = torch.arange(n_entries, device=dev)
    e = entry[slot[placed].long()]
    if bool((e < 0).any()) or not all(
            torch.equal(lst[e], lane[placed])
            for lst, lane in ((epid, fpid), (ehi, fhi), (elo, flo))):
        raise AssertionError("loc_table: a lane's slot holds another key")
    pad = slice(n_entries, None)
    if bool((eslot[pad] != cap_loc).any() | (epid[pad] != -1).any()
            | (ehi[pad] != 0).any() | (elo[pad] != 0).any()):
        raise AssertionError("loc_table: the list's padding is not "
                             "(U32_MAX, 0, 0, cap_loc)")
    ko, po = tpu.argsort3(epid, ehi, elo), tpu.argsort3(*lt_plain[1:4])
    for x, y in zip((epid, ehi, elo), lt_plain[1:4]):
        if not torch.equal(x[ko], y[po]):
            raise AssertionError("loc_table: the re-sorted list differs "
                                 "from the plain version's")

    # Probe steps this run's data needed: each placed lane visited the
    # slots from its base to its slot.
    mask = cap_loc - 1
    base = probe.loc_base(fpid, fhi, flo)
    lane_steps = ((slot[placed].long() - (u32_wide(base[placed]) & mask))
                  & mask) + 1
    steps = int(lane_steps.sum())
    step_hist = torch.bincount(lane_steps).tolist()[1:]
    keys = torch.stack([u32_wide(x[live]) for x in (fpid, fhi, flo)], 1)
    del lt_plain, entry, e, base, lane_steps
    saved = (dict(probe.LAUNCHES), dict(row_hash.LAUNCHES))
    rh_plain_ms = time_ms(
        lambda: row_hash.row_hash_plain(shi, slo, pid, ulen, klen), 2)
    lt_ms = time_ms(lambda: probe.build_loc_table(fpid, fhi, flo, None,
                                                  cap_loc, l_cap), 10)
    lt_plain_ms = time_ms(lambda: probe.build_loc_table_plain(
        fpid, fhi, flo, None, cap_loc, l_cap), 1)
    lib_ms = time_ms(lambda: torch.unique(keys, dim=0, return_inverse=True),
                     2)
    probe.LAUNCHES.update(saved[0])
    row_hash.LAUNCHES.update(saved[1])

    n_pad, f_cap = dims["n_pad"], dims["f_cap"]
    rh_ms = rh_row["ms"]["kernel"]
    # loc_table: a live lane reads its 12 B key, a dead lane its 4 B pid,
    # every lane writes its 4 B slot, and each of the l_cap dense entries
    # is 16 B written (the table is scratch); ~12 integer ops a live lane
    # for its base hash and ~8 a probe step (CAS, compare x3, advance,
    # mask, loop).
    live_lanes = int(live.sum())
    lt_bytes = 12 * live_lanes + 4 * (f_cap - live_lanes) + 4 * f_cap \
        + 16 * l_cap
    lt_bound, lt_by = bound(lt_bytes, 12 * live_lanes + 8 * steps)
    emit("one_shot_kernels", rows=n_pad, live_frames=rh_row["live_frames"],
         lanes=f_cap, live_lanes=live_lanes, table_slots=cap_loc,
         l_cap=l_cap, distinct_keys=n_entries, probe_steps=steps,
         probe_step_hist=step_hist,
         row_hash={**rh_row, "plain_ms": rh_plain_ms, "library_ms": None},
         loc_table={"invariants_hold": True, "ms": lt_ms,
                    "plain_ms": lt_plain_ms, "bound_ms": lt_bound,
                    "bound_by": lt_by, "bytes": lt_bytes,
                    "library_ms": lib_ms},
         row_hash_library_note="no single PyTorch call computes a "
                               "multilinear hash mod 2^32 of each row",
         loc_table_library="torch.unique of the live keys as int64 [n, 3], "
                           "dim=0, return_inverse=True")
    del args, rh, out_shi, out_slo, lt, keys

    # (d) The CLI entry on the card.
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli.run(["--aggregator", "tpu", "--windows", "2",
                      "--profiling-duration", "0.1",
                      "--local-store-directory", tmp])
        files = sorted(Path(tmp).glob("*.pb.gz"))
        if rc != 0 or not files:
            raise AssertionError(f"CLI --aggregator tpu: rc {rc}, "
                                 f"{len(files)} profiles written")
        parsed = parse_pprof(files[0].read_bytes())
        if not parsed.samples or min(v[0] for _, v, _ in parsed.samples) < 1:
            raise AssertionError("CLI --aggregator tpu wrote an empty "
                                 "profile")
    emit("one_shot_cli", rc=rc, profiles_written=len(files))

    # (e) The two dedup arms below LOC_WARN_THRESHOLD, where the one-shot
    # path is meant to run: the CLI's synthetic window, and the bench's
    # spec cut to 2^17 rows.
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec

    arms = {
        "cli_window": dedup_arms(dev, SyntheticSpec(seed=1), rh_impls),
        "bench_2e17_rows": dedup_arms(dev, SyntheticSpec(
            n_pids=PIDS, n_unique_stacks=1 << 17, n_rows=1 << 17,
            total_samples=SAMPLES, mean_depth=24, kernel_fraction=0.2,
            seed=42), rh_impls),
    }
    emit("one_shot_arms", threshold=tpu.TPUAggregator.LOC_WARN_THRESHOLD,
         reps=ARM_REPS, **arms)

    return {
        "row_hash": {
            "name": "row_hash", "route": "cuda",
            "source": "parca_agent_tpu_torch/csrc/row_hash.cu",
            "replaces": "parca_agent_tpu/aggregator/tpu.py:109",
            "launches": launches["row_hash"], "max_abs_err": 0,
            "ms": rh_ms, "plain_ms": rh_plain_ms,
            "bound_ms": rh_row["bound_ms"], "bound_by": rh_row["bound_by"],
            "library_ms": None,
        },
        "loc_table": {
            "name": "loc_table", "route": "cuda",
            "source": "parca_agent_tpu_torch/csrc/loc_table.cu",
            "replaces": "parca_agent_tpu/aggregator/pallas_probe.py:134",
            "launches": launches["loc_table"], "max_abs_err": 0,
            "ms": lt_ms, "plain_ms": lt_plain_ms, "bound_ms": lt_bound,
            "bound_by": lt_by, "library_ms": lib_ms,
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1-reference", metavar="FEED_PROBE_CU",
                    help="another source with csrc/feed_probe.cu's C "
                         "interface, built and timed in turns with K1")
    ap.add_argument("--rh-reference", metavar="ROW_HASH_CU",
                    action="append", default=[],
                    help="another source with csrc/row_hash.cu's C "
                         "interface, built and timed in turns with the row "
                         "hash kernel (may be given more than once)")
    opts = ap.parse_args()
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
    build_s = time.perf_counter() - t0
    nvcc = kernels.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    # The location table's claim: which compare-and-swap the build emitted
    # (a 128-bit one shows as a CAS of .128 in the SASS).
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    cas_sass = None
    if cuobjdump.exists():
        sass = subprocess.run(
            [str(cuobjdump), "--dump-sass",
             str(kernels.library_path("loc_table"))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        cas_sass = sorted({ln.split("*/")[1].strip().split(" ")[0]
                           for ln in sass.splitlines()
                           if "CAS" in ln and "*/" in ln})
    emit("build", s=build_s, arch=list(kernels.ARCH_FLAGS),
         nvcc=version.strip().splitlines()[-2:], loc_table_cas=cas_sass,
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln
                    or "Compiling" in ln] for k, v in report.items()})

    ref = None
    if opts.k1_reference:
        ref = load_k1_reference(opts.k1_reference)
        emit("k1_reference", source=opts.k1_reference)
    rh_refs = {Path(path).stem: load_rh_reference(path)
               for path in opts.rh_reference}
    if rh_refs:
        emit("rh_reference", sources=opts.rh_reference)
    rows = phase_kernels(dev, ref)
    snap, want = window_setup()
    launches = phase_main_path(dev, snap, want, ref=ref)
    for name, row in rows.items():
        row["launches"] = launches[name]
    rows.update(phase_one_shot(dev, snap, want, rh_refs))
    for name, row in rows.items():
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
