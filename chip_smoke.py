#!/usr/bin/env python3
"""Smoke run of parca_agent_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--k1-reference FEED_PROBE_CU]
                          [--rh-reference ROW_HASH_CU ...]
                          [--close-reference CLOSE_PACK_CU ...]
                          [--b7-reference SHARDED_FEED_CU]
                          [--fleet-reference FLEET_MERGE_CU]
                          [--sketch-reference SKETCH_BUILD_CU]

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
               the same work, from this run's data) at both shapes. Then
               the close kernels B2 (close_pack) and B3 (close_pack_delta)
               against their plain versions at id_cap 2^20: widths 4, 8
               and 16, n_fetch 2^18 and 2^20, with and without sideband
               and touched-block overruns and guard mass (every word
               equal, every guard nonzero once and zero once), then each
               timed with its bound, the device kernels one call enqueues
               (torch.profiler: must be 1) and the wrapper's host cost
               (with the earlier wrapper's per-call extras timed apart).
               Last, the sketch build B6 at a phase-6 window's 2^16
               rows (the shape rule's global kernel) against its plain
               version and the numpy paths, timed, beside the library
               calls (count-min index_add_, HLL scatter_reduce_ amax) and
               its bound; and both B6 kernels, called directly, timed in
               turns at 2^16 to 2^22 rows (sketch_b6_rows: where the rule
               hands the stream to the cluster kernel)
  4. main path the port's DictAggregator on the card over the bench's
               window (50,000 pids, 2^20 unique stacks, 5M samples): a cold
               window, then a steady window fed as 10 drains and closed,
               every window's pprof for every pid through one
               WindowEncoder (--fast-encode; the cold window pays the
               statics build); the last steady window again through an
               EncodePipeline (its bytes equal to the inline encode's),
               then once more through an EncodePipeline carrying a
               HotspotStore, a RegressionSentinel and a SinkRegistry
               (pprof, AutoFDO and alerts into a temporary directory,
               series) through its rollup, rollup_capture and
               sink_capture hooks, as the CLI attaches them: every pid's
               shipped bytes equal to the same window's without the
               sinks; the store's top 50 the oracle's top 50 of
               the window's exact (h1, h2) -> count, each count exact
               (one window: its candidates are its heaviest stacks, cut
               or not), and with a pid selector each exact count between
               the answer's count and its count-min estimate (or the
               oracle's where the cut is 0); the fold, query, sentinel,
               AutoFDO and series costs printed. Totals
               and per-pid masses must equal the numpy CPUAggregator's on
               the same snapshot, and every 64th pid's sorted stack counts;
               every live pid has one blob, every 64th
               pid's parses to build_pprof's samples; every feed must
               launch the fused probe kernel, every close the close
               kernel. Then the probe-step histogram of the window's rows
               in the table, and K1 on that table at one drain's rows,
               against its plain version, timed, with its bound.
  5. one shot  the port's TPUAggregator (--aggregator tpu) on the same
               window: aggregate() with the hash arm once, checked against
               the same oracle (with per-pid location counts), its
               row_hash and loc_table launches counted; the sort arm's 10
               outputs equal to those that run computed, and a sample's
               pprof bytes equal;
               both kernels against their plain versions at the window's
               shapes (the location table's dense list re-sorted), timed,
               with their bounds, the bytes the row hash fetches, the
               host cost of its wrapper and the table's probe-step
               histogram; the CLI entry, and the CLI with --fast-encode
               (dict and dict+cm, through the encode pipeline) against the
               CLI without it, window by window (these four CLIs, like
               phase 11's hang CLI, start before the window's set-up and
               run beside it); and each dedup arm's
               device time,
               and the row hash against its plain version, timed, on two
               windows below the aggregator's location warning threshold.
  6. bounded   --aggregator dict+cm: DictAggregator(overflow="sketch") on
               the card, started by load_state from phase 4's full
               dictionary (2^20 ids), 8 windows of the bench window's
               first 200,000 rows plus 65,536 new stacks (a bench row's
               leaf moved inside its mapping), 10 drains each: new stacks
               absorbed into the count-min sketch while full (delta
               closes), the rotation once the cold ids are 6 windows
               unseen, exact windows after it, 50 pids invalidated at
               once and one deferred. Every window: exact + absorbed mass
               equals
               the window's, the sketch never underestimates an absorbed
               row, and a CPU twin from the same state gives the same
               counts, ids and sketch. One WindowEncoder encodes every
               window; after the rotation and after the invalidations its
               bytes equal a fresh encoder's for every pid and
               build_pprof's for every 64th. B2 and B3 timed on its own
               accumulators.
  7. streaming the streaming window: DictAggregator(carry=True) on the
               card, fed drain by drain by StreamingWindowFeeder inside the
               fast loop (CPUProfiler with the encode pipeline and a
               StaticsStore in a temporary directory), the bench window cut
               into 10 drains on pid boundaries, each drain's mapping
               table rebuilt from the window's own: a cold window, then a
               window of the same rows plus 65,536 new stacks (carried
               rows fold on the host, the rest launch K1; each
               close launches B2 or, when the touched blocks are few, B3).
               Every window: per-pid mass equal to the
               numpy oracle, one blob per live pid, every 64th pid's blob
               equal to build_pprof's; no window re-aggregated, no carry
               fallback. The path's kernels against their plain versions
               at its shapes, timed, with their bounds: the first full and
               the first delta close on the window's own accumulator (id_cap
               2^21), and K1 on the dictionary's table (2^22 slots) at the
               first steady window's last drain, the rows the carry left.
               The worker writes the statics snapshot after the
               last window; a fresh dictionary and encoder adopt it and
               stream the last window's first 2 drains again (whole pids),
               whose bytes must equal a cold encoder's for every pid. The
               runtime edges are the CLI's
               at its defaults (the feeder's 3 s and 60 s first-feed
               watchdogs, the 60 s device watchdog, the device-health and
               quarantine registries, the flight recorder, device
               telemetry): no feed may hang or fail, no window cool the
               feeder down or fall back, no device wait hang.
  8. sharded   --aggregator sharded: ShardedDictAggregator(capacity 2^21,
               8 shards, overflow "sketch") on the card, 8 home
               sub-tables of 2^18 slots: a cold window of the bench
               window, then a steady window of 10 drains, each checked
               against the numpy oracle (totals, per-pid mass, every 64th
               pid's sorted stack counts); every feed must launch B7-feed
               (csrc/sharded_feed.cu) exactly once, every close B7-close
               (close_pack.cu's pa_close_pack_sharded). Per drain the H2D,
               dispatch and settle host times, n_pad and the rows a shard.
               Both kernels against their plain versions at the path's
               shapes, timed, with their bounds: B7-feed at three drains
               (the steady window's last drain on the window's table, the
               cold window's feed on the empty table it met, and the
               skewed router's drain on its table), acc, n_miss and every
               shard's miss-row prefix equal, one device kernel a steady
               feed (torch.profiler); B7-close on the window's own [8, 2^20]
               accumulator at widths 4, 8 and 16, and at one shard beside
               B2. A pid router that sends three pids of
               four to shard 0 at 1/8 of the window (capacity 2^18): shard
               0's sub-table fills, the sketch absorbs the rest, exact +
               absorbed mass equals the window's and every exact key its
               rows' count. Admission on the sharded path, a path of its
               own: the skew drain's 2^17 rows and 6,250 pids in 64 pod
               cgroups of Zipf-skewed mass on a seeded fake filesystem,
               an AdmissionController's shard_of installed with
               set_shard_router on a fresh ShardedDictAggregator
               (capacity 2^21), 10 drains and a close (B7-feed and
               B7-close launched): every row and key in its tenant's
               home shard, the close's and every pid's mass the
               oracle's; at a quota of the median tenant's mass exactly
               the tenants over it on the ladder, and an overloaded
               window shedding the heaviest tenants first; route_h2's ms
               a drain and the rows a shard; route_h2 with admission's
               router on the bench window's 10 drains (50,000 pids), the
               resolver's cache cold and warm. The CLI with --aggregator
               sharded --fast-encode (one shard on one card), 2 windows.
  9. fleet     the fleet merge (parallel/, BASELINE config #5) on the
               card: 8 nodes, each the bench window's 2^20 rows (phase
               4's hashes, counts 1-9 a node) plus 65,536 node-private
               new stacks, a [8, 1,114,112] stream: fleet_merge_sketches
               (B6's cluster kernel, the table in a thread-block
               cluster's shared memory), fleet_merge_exact64 and
               fleet_merge_exact (B8: the rows partitioned by key and
               each bucket reduced in shared memory, no sort), held
               against numpy's count-min, HLL, int64 total and exact
               merge; fleet_merge_profiles of 8 node windows of 2^17 rows
               (each node's own pids plus 16,384 rows every node holds)
               against CPUAggregator on concat_snapshots; the process
               boundary through NCCL at world size 1 (fleet_initialize on
               a localhost port; node 0's first 2^18 rows, a node below
               the cluster kernel's 2^20, so its sketch merge takes B6's
               global kernel; the _dist merges against the one-process
               merges of that node, two FleetWindowMerger rounds against
               numpy, a HotspotStore attached to them: each round's
               fleet_fold gets B8's groups of node 0's rows, counted as
               a path of their own, and the fleet-scope answer's top 50
               is their exact top 50). B6 (the cluster kernel at the stream, in turns
               with the global one; the global kernel at NCCL's node) and
               B8 against their plain versions, timed (B8 from the
               unsorted rows), with their bounds and library yardsticks;
               B8 also on two fleets of the stream's shape that share few
               stacks (every key distinct; 1/8 of a node's stacks on
               every node), and at 2^10..2^13 first-level buckets.
 10. live      the host native layer (native/*.cc, built by g++) and the
               CLI on this machine: row_hash_np's C++ pass against its
               numpy version on the bench window (equal bits, both
               timed); phase 4's cold encode's varint and ragged-copy
               calls (recorded there) replayed through the C++ passes and
               the numpy ones (equal bytes, both timed); the bench
               window's rows written as the sampler's v1 and v1d records
               with numpy and decoded back to them (the C++ decoders and
               the plain Python loop, timed), and pa_stack_hash equal to
               row_hash_np on every row; then the CLI in this process,
               --capture procfs --aggregator dict --fast-encode, 3
               windows of 2 s beside a CPU-burning child: profiles with
               mass, the child's pid among them, K1 and the close
               launched, each held against its plain version on the
               run's last drain and last close. Where the kernel permits
               perf_event_open, the same with --capture perf
               --streaming-window (3 windows of 3 s: windows streamed,
               drains fed, the hash carry on); where it refuses it for
               lack of permission or has no perf events, a line
               "perf: {...}" says so, with the errno.
 11. runtime   the runtime edges on the card: DictAggregator at bench.py's
               option settings at full width — id_cap from bench.py's
               formula (2^21, not capacity // 2), delta_fetch False and
               True, coalesce False — each loaded from phase 4's state
               without its per-pid location registries (the checks are
               totals and per-pid masses) and fed the bench window, then
               twice its first eighth of rows, 10 drains a window, each
               window's total and every pid's mass held to the numpy
               oracle; K1 and B2 launched in every arm, B3 in every arm but
               delta_fetch=False (there never). Device telemetry installed
               for the phase: every kernel's first-launch and launch
               events, the H2D bytes equal to those the windows' rows
               make (16 B a lane of each feed's power-of-two buffer) and
               the D2H bytes to those each close pack's plan makes (its
               lanes, block ids, sideband and counters), the identity
               naming this card. Then the CLI with an injected
               device.dispatch hang (started before the window's set-up,
               collected here): it must exit non-zero within
               --device-timeout plus a margin, the health snapshot on its
               last line (with the bring-up probe it ran first, a child
               that launches the row hash kernel, timed and passed), the
               incident file written.
 12. symbolize the path without --fast-encode, named and walked: (a) on
               phase 7's first-run dictionary (capacity 2^22, warm with
               the bench window), aggregate() of the bench window
               plus two new stacks for one pid in 8, whose user frames run
               in an anonymous JIT region (K1 and the close launched),
               then the Symbolizer over a FakeFS made from the seed: a
               kallsyms of 20,000 symbols over the synthetic kernel
               addresses, and a perf map in each JIT pid's mount
               namespace; every 64th pid's names (each of them a JIT
               pid) equal to an oracle written here (a sorted address table
               and np.searchsorted; the perf map's ranges), in the
               profile and in its build_pprof parsed back; the close ms
               and the symbolize ms. (b) On the host it runs on: a nonzero
               /proc/kallsyms address resolved to its name through
               KsymCache (unless kptr_restrict zeroes them all), and
               three entries of a `python3 -X perf` child's perf map
               through PerfMapCache and namespaced_pid (unless the
               interpreter writes none). (c) A frameless C fixture built
               with gcc -O2 -fomit-frame-pointer, which recurses through
               outer/middle/leaf 6 times and dumps its registers and 16 KiB
               of its stack: its unwind tables built by
               UnwindTableCache.build_now from its real maps (the binary,
               libc, ld.so), the sample walked 16,000 times (100 Hz x 16
               CPUs x 10 s) by unwind_records from an FP chain of depth 1,
               every walk reaching main at depth 19 through the expected
               functions, then the walked records through
               records_to_snapshot and the scalar loop on the card (mass
               equal to the samples). (d) The CLI without --fast-encode,
               3 windows each: procfs with process identity on, procfs
               with --fault-inject process.identity:error, and synthetic
               (kernel frames) with --fault-inject symbolize.kernel:error;
               each exits 0, names the symbolize span, and counts the
               faults.
 13. transport the CLI's ship path (agent/, labels/), after phase 12: (a)
               phase 4's steady window as the encode pipeline shipped it
               (50,000 pids, after K1 and the close kernel) through
               RemoteProfileWriter -> MatchingProfileListener ->
               BatchWriteClient at the CLI's defaults (64 MiB and 100,000
               samples a buffer, retry budget 8) with a SpoolDir in a
               temporary directory, under the LabelsManager's labels
               (--node, external labels, kernel_release dropped), to a
               GRPCStoreClient on an in-process store on 127.0.0.1 (where
               grpc does not import, an in-process StoreClient through the
               WriteRaw codec), flushed until the buffer and the spool are
               empty: every pid's profile arrives exactly once, gunzipped
               equal to the encoder's bytes, under its labels. Prints the
               gzip ms, the raw and gzipped bytes, the flushes, the
               largest request against the channel's MAX_MSG_BYTES and
               the largest batch as one request (as the original's client
               sends it), the overflow spills, the drops (0 with a spool)
               and the replay ms; then the same window without a spool,
               and its drops. (b) Where grpc imports, the CLI in this
               process, --aggregator dict --fast-encode, replaying 3
               procfs windows of a CPU-burning child recorded here (their
               mapping tables rebuilt with the objects' build ids), to an
               in-process store with its debuginfo service, with --node,
               --metadata-external-labels and, where yaml imports, a
               --config-path relabel rule: every window's mass arrives,
               the last window's included, under the labels asked for,
               every upload finishes by build id, and K1 and the close
               kernel launch. The phase prints grpc, yaml and
               cryptography as this host has them, on a line of its own.
 14. shell     the agent shell (web.py, discovery/, the self-profiler):
               started in a child process once phase 4's window is made
               and collected after phase 13 (it is host-bound, and runs
               beside phases 4-13), the CLI in that process,
               --aggregator dict --fast-encode,
               replaying 3 windows of every 8th row of phase 4's window
               (2^17 rows of the bench's 50,000 pids; windows 2 and 3 the
               first's, but for 16 user stacks whose leaf is in one
               binary, 5,000 and 10,000 samples heavier), with
               --enable-cgroup-discovery,
               --enable-systemd-discovery, --log-level debug,
               --hotspots, --regression (its interval the window's 1 s,
               a baseline of 1 rollup), --sink
               pprof,autofdo,series,alerts, tenant quotas and
               --http-address on a port picked here. Before each window
               the capture source waits until the encode worker has
               folded the windows taken (so every window is folded);
               before the last it waits until every window taken has
               printed its line, then scrapes: /metrics (the strict
               parser of tests/test_metrics_format.py; the loop's attempts
               and profiles written equal to those lines'; the stage
               histogram present), /, /healthy, /healthz (the discovery
               actor present), /query of the windows' heaviest pid (its
               profile's mass that pid's in window 2 or 3),
               /debug/windows, /debug/trace/<seq> (and 404 for a seq not
               in the ring), /debug/device, /debug/pprof/cmdline,
               profile?seconds=1 (a pprof naming the window loop's thread)
               and heap?seconds=1, /hotspots and /diff (200; /metrics
               carries the hotspot, regression, admission and sink
               families). Once the source is exhausted and the last
               window folded: /diff and the alerts file hold regressed or
               new_hotspot verdicts on the shifted stacks, every verdict
               of that one build; /hotspots' top 50 holds to the windows'
               summed exact counts; the AutoFDO directory holds
               profdata. Prints the scrape ms, the folds' seconds, what
               discovery found on this host (groups by provider, failed
               updates) and the phase's seconds; K1 and the close kernel
               must launch.

With --k1-reference, a second build of K1 from that source (one with
csrc/feed_probe.cu's C interface, e.g. an earlier commit's) is held
against the kernel and timed in turns with it, in phases 3 and 4. With
--rh-reference (repeatable), each source with csrc/row_hash.cu's C
interface is built, held against the plain version and timed in turns
with the row hash kernel at phase 5's three windows. With
--close-reference (repeatable), each source with csrc/close_pack.cu's C
interface is built, held against the plain versions in phase 3's cases
and on phase 6's accumulators, and timed in turns with the close kernels
there (a source without the sharded entry point loads all the same).
With --b7-reference, a source with the two-stage B7-feed's C interface
(parent commits before the one-launch feed: pa_sharded_feed over a host
partition, found ids out) is built, its kernel plus the torch miss
compaction that followed it held against the one-launch kernel at phase
8's steady drain, on a partition made here for that timing only, and
timed in turns with it. With --fleet-reference, a source with the
segment pass's C interface (pa_fleet_segment, the commits before the
partition and reduce) is built, and its route (torch.sort of the rows,
the counts' gather, its kernel) held against fleet_group and timed in
turns with it at phase 9's stream and on its two low-overlap fleets.
With --sketch-reference, a source
with csrc/sketch_build.cu's pa_sketch_build is built, held against the
cluster kernel and timed in turns with it at phase 9's stream.

Every CLI run serves its HTTP surface on a free port of its own
(--http-address 127.0.0.1:0; phase 14 picks its port), and phase 11's
incident file must carry a self-profile of the agent.

Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device":
{...}}. Any failed phase raises and exits nonzero, with no result line.
Without a CUDA device, or without the package beside this file, it exits
nonzero at once.
"""

from __future__ import annotations

import argparse
import atexit
import json
import re
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
STEADY_WINDOWS = 1
DRAINS = 10
# Phase 5: timed runs of each dedup arm on each small window; windows of
# each CLI run.
ARM_REPS = 3
CLI_WINDOWS = 2
# Phase 11: bench.py's id_cap at the bench window (`1 << (2*top -
# 1).bit_length()`, bench.py:2394), the hang CLI's watchdog and the margin
# its exit may take past it (interpreter start, the probe child, CUDA).
RUNTIME_ID_CAP = 1 << (2 * ROWS - 1).bit_length()
HANG_TIMEOUT_S = 5.0
HANG_MARGIN_S = 90.0
# The CLI runs of phases 5, 8 and 10 check their aggregators and skip the
# bring-up probe child (~10 s each on the card host); phase 11 checks the
# probe, alone and at the start of its CLI run.
NO_PROBE = ("--device-probe-timeout", "0")
# Every CLI run serves its HTTP surface on a port of its own: any free
# one (phase 14 picks its port to scrape it).
HTTP_ANY = ("--http-address", "127.0.0.1:0")


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
        # An earlier source may lack an entry point added since (the
        # sharded close): only those it has are typed.
        if hasattr(lib, fn):
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


def load_close_reference(path: str):
    """(close_pack, close_pack_delta) of a reference build of
    csrc/close_pack.cu, called as the port's wrappers call theirs, with a
    scratch zeroed once per id_cap and kept (what every design of the
    close takes: the three-launch one overwrites its scratch, the
    look-back one needs it zeroed once). Launches are not counted."""
    import torch

    from parca_agent_tpu_torch.ops import kernels

    lib = load_reference("close_pack", path)
    scratch = {}

    def launch(name, acc, n_out, *args):
        dev = acc.device
        key = (dev.index, acc.shape[0])
        if key not in scratch:
            scratch[key] = torch.zeros(
                lib.pa_close_scratch_words(acc.shape[0]), dtype=torch.int32,
                device=dev)
        out = torch.empty(n_out, dtype=torch.int32, device=dev)
        kernels.check_launch(lib, getattr(lib, name)(
            *args, scratch[key].data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "reference " + name)
        return out

    def close_pack(acc, n_fetch, width, n_over_buf):
        return launch("pa_close_pack", acc,
                      n_fetch * width // 32 + 2 * n_over_buf + 2,
                      acc.data_ptr(), acc.shape[0], n_fetch, width,
                      n_over_buf)

    def close_pack_delta(acc, touch, n_fetch, width, n_over_buf, n_blk_buf,
                         blk):
        return launch("pa_close_pack_delta", acc,
                      n_blk_buf * blk * width // 32 + n_blk_buf
                      + 2 * n_over_buf + 4,
                      acc.data_ptr(), touch.data_ptr(), acc.shape[0], n_fetch,
                      width, n_over_buf, n_blk_buf)

    return close_pack, close_pack_delta


# Sessions device_kernels takes at most: late in a long run, at phase 8,
# torch.profiler has dropped the device activity of 4 sessions in a row
# and, once, of 5.
PROFILER_SESSIONS = 20


def device_kernels(fn):
    """(names, sessions): the device activities (kernels, memsets,
    copies) that one fn() call enqueues, from torch.profiler, after one
    untimed call. Each session launches a spin kernel first, as its
    control: torch.profiler at times returns a session with no device
    activity at all, and a session whose control does not show is taken
    again, up to PROFILER_SESSIONS sessions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for sessions in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if sum("spin_kernel" in n for n in names) == 1:
            return [n for n in names if "spin_kernel" not in n], sessions
    raise AssertionError(f"torch.profiler showed no control kernel in "
                         f"{PROFILER_SESSIONS} sessions")


def kernel_us(fn, reps: int = 10):
    """Device microseconds a call of each kernel that fn() launches, the
    mean over `reps` calls, from torch.profiler's key_averages (None when
    a session shows no device time: torch.profiler at times drops it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0 and e.count > 0:
            name = re.search(r"(\w+)\(", e.key)
            out[name.group(1) if name else e.key] = t / reps
    return out or None


def host_us(fn, reps: int = 200):
    """(host microseconds a call, covered): `reps` calls queued behind a
    spin kernel, so the card never waits on the host and the host clock
    times the host alone (`covered`: the spin outlasted the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    spin = torch.cuda.Event()
    spin.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    covered = not spin.query()
    torch.cuda.synchronize()
    return us, covered


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


# -- phase 3, the close kernels -----------------------------------------------

# The dictionary's id space at the CLI's default capacity (2^21 slots).
ID_CAP = CAP // 2
BLK = 128


def close_case(seed: int, n_fetch: int, width: int, n_big: int, tail: bool,
               n_touch: int = 0, untouched_mass: bool = False):
    """An accumulator int32 [ID_CAP] of small counts with `n_big` counts at
    or above the width's sentinel (and the sentinel's edges), mass past
    n_fetch only when `tail` (7 x 2^30: the u32 guard wraps, to nonzero).
    With `n_touch`: touch flags int32 [ID_CAP / 128] for that many prefix
    blocks (two more past the prefix, which count for nothing), the big
    counts inside them, and mass in untouched prefix blocks only when
    `untouched_mass`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acc = np.where(rng.random(ID_CAP) < 0.3,
                   rng.integers(1, 15, ID_CAP), 0).astype(np.int32)
    acc[n_fetch:] = 0
    touch, cand = None, np.arange(n_fetch)
    if n_touch:
        nb_prefix, n_blocks = n_fetch // BLK, ID_CAP // BLK
        hit = np.sort(rng.choice(nb_prefix, n_touch, replace=False))
        touch = np.zeros(n_blocks, np.int32)
        touch[hit] = rng.integers(1, 3, n_touch)
        if n_blocks > nb_prefix:
            touch[nb_prefix + rng.choice(n_blocks - nb_prefix, 2)] = 1
        if not untouched_mass:
            blocks = acc[:n_fetch].reshape(nb_prefix, BLK)
            cold = np.ones(nb_prefix, bool)
            cold[hit] = False
            blocks[cold] = 0
        cand = (hit[:, None] * BLK + np.arange(BLK)).ravel()
    big = rng.choice(cand, n_big, replace=False)
    acc[big] = rng.integers((1 << width) - 1, 1 << 24, n_big)
    edge = rng.choice(np.setdiff1d(cand, big), 3, replace=False)
    acc[edge] = (1 << width) - 2 + np.arange(3)
    if tail:
        acc[n_fetch + rng.choice(ID_CAP - n_fetch, 7, replace=False)] = 1 << 30
    return acc, touch


def close_bound(out_words: int, nb_prefix: int = 0, unfetched: int = 0,
                id_cap: int = ID_CAP):
    """(bound ms, by) of one close: acc (`id_cap` ids) read once, except
    the touched blocks past n_blk_buf (no output depends on them), the
    touch flags of the prefix read once, the buffer written once; ~4
    integer operations an id (compare, select, shift, add)."""
    acc_bytes = 4 * (id_cap - BLK * unfetched)
    return bound(acc_bytes + 4 * nb_prefix + 4 * out_words, 4 * id_cap)


def close_turns(impls: dict, args: tuple, delta: bool, reps: int = 50,
                count: bool = False):
    """Each close build of `impls` (label -> (close_pack, close_pack_delta))
    held bit for bit against the plain version on `args`, then timed in
    turns. With `count`: the device kernels one call of each enqueues (the
    kernel must show 1) and the host cost of the wrapper a call. Launches
    made here are not counted."""
    import torch

    from parca_agent_tpu_torch.aggregator import close
    from parca_agent_tpu_torch.ops import kernels

    saved = dict(close.LAUNCHES)
    plain = close.close_pack_delta_plain if delta else close.close_pack_plain
    want = plain(*args)
    fns = {label: (lambda f=f[delta]: f(*args))
           for label, f in impls.items()}
    for label, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"close {label} != plain "
                                 f"({'delta' if delta else 'full'})")
    turns = time_turns(fns, reps)
    out = {"ms": min(turns["kernel"]), "ms_turns": turns,
           "plain_ms": time_ms(lambda: plain(*args), 5),
           **{label + "_ms": min(turns[label]) for label in fns
              if label != "kernel"}}
    close.LAUNCHES.update(saved)
    if not count:
        return out
    for label, fn in fns.items():
        key = "" if label == "kernel" else label + "_"
        names, sessions = device_kernels(fn)
        out[key + "device_kernels_per_call"] = len(names)
        out[key + "device_kernels"] = sorted(set(names))
        out[key + "profiler_sessions"] = sessions
    if out["device_kernels_per_call"] != 1:
        raise AssertionError(f"one close call enqueued "
                             f"{out['device_kernels']} on the card")
    # The wrapper's host cost a call; apart, what the earlier wrapper did
    # besides on every call: allocate the scratch, size it by ctypes.
    lib = kernels.load("close_pack")
    n = args[0].shape[0]
    out["host_us"], covered = {}, True
    for part, fn in (("wrapper", fns["kernel"]),
                     ("scratch_alloc", lambda: torch.empty(
                         lib.pa_close_scratch_words(n), dtype=torch.int32,
                         device=args[0].device)),
                     ("scratch_words_ctypes",
                      lambda: lib.pa_close_scratch_words(n))):
        out["host_us"][part], ok = host_us(fn)
        covered &= ok
    out["host_covered"] = covered
    close.LAUNCHES.update(saved)
    return out


def handle_close(h, impls: dict) -> dict:
    """close_turns on a dictionary's closed window (its close handle `h`,
    taken before the accumulator is reused): the form the close launched
    first, full or delta, at the handle's shape, with the bound of this
    accumulator's data. A delta close that grew its block buffer to the
    touched blocks is taken at the grown buffer, the one that held the
    window."""
    id_cap = int(h.acc.shape[0])
    if h.delta_blks:
        n_touched = int((h.touch[:h.n_fetch // BLK] > 0).sum())
        n_blk = h.delta_blks
        if n_touched > n_blk and (1 << (n_touched - 1).bit_length()) * BLK \
                <= h.n_fetch // 2:
            n_blk = 1 << (n_touched - 1).bit_length()
        args = (h.acc, h.touch, h.n_fetch, h.width, h.n_over_buf, n_blk,
                BLK)
        out_words = (n_blk * BLK * h.width // 32 + n_blk
                     + 2 * h.n_over_buf + 4)
        b_ms, b_by = close_bound(out_words, h.n_fetch // BLK,
                                 max(0, n_touched - n_blk), id_cap)
    else:
        args = (h.acc, h.n_fetch, h.width, h.n_over_buf)
        n_touched = n_blk = None
        b_ms, b_by = close_bound(h.n_fetch * h.width // 32
                                 + 2 * h.n_over_buf + 2, id_cap=id_cap)
    return {**close_turns(impls, args, bool(h.delta_blks)),
            "bound_ms": b_ms, "bound_by": b_by, "id_cap": id_cap,
            "n_fetch": h.n_fetch, "width": h.width,
            "n_over_buf": h.n_over_buf, "n_blk_buf": n_blk,
            "planned_blk_buf": h.delta_blks or None, "touched": n_touched}


def phase_close_kernels(dev, close_refs=None) -> None:
    """B2 and B3 against their plain versions on the card at id_cap 2^20:
    widths 4, 8, 16 and n_fetch 2^18, 2^20; each with a sideband that
    overruns its buffer (delta: also more touched blocks than n_blk_buf,
    mass in untouched blocks) and mass past n_fetch, and each without.
    Every word must be equal (the reference build's too), and every guard
    must read nonzero once and zero once. Then each kernel timed against
    its plain version at n_fetch 2^20, width 8, with its bound, in turns
    with the reference builds, with the device kernels a call (must be 1)
    and the wrapper's host cost. Then B6's library calls."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    impls = {"kernel": (close.close_pack, close.close_pack_delta),
             **(close_refs or {})}
    saved = dict(close.LAUNCHES)
    t0 = time.perf_counter()
    seen = {"n_over_full": set(), "tail_full": set(), "n_touched": set(),
            "n_over_delta": set(), "untouched": set(), "tail_delta": set()}
    cases = 0
    for width in (4, 8, 16):
        for n_fetch in (1 << 18, 1 << 20):
            for overrun in (False, True):
                tail = overrun and n_fetch < ID_CAP
                n_over_buf = 1 << 10
                acc, _ = close_case(width + n_fetch, n_fetch, width,
                                    n_over_buf + 100 if overrun
                                    else n_over_buf // 2, tail)
                a = to_dev(acc)
                want = close.close_pack_plain(a, n_fetch, width, n_over_buf)
                for label, (full, _d) in impls.items():
                    got = full(a, n_fetch, width, n_over_buf)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"close_pack {label} != plain (width {width}, "
                            f"n_fetch {n_fetch}, overrun {overrun})")
                host = want.cpu().numpy().view(np.uint32)
                seen["n_over_full"].add(int(host[-2]) > n_over_buf)
                seen["tail_full"].add(int(host[-1]) != 0)
                nb_prefix = n_fetch // BLK
                n_blk_buf = nb_prefix // 8
                acc, touch = close_case(
                    width + n_fetch + 1, n_fetch, width, 192, tail,
                    n_touch=n_blk_buf + 5 if overrun else n_blk_buf // 2,
                    untouched_mass=overrun)
                n_over_buf = 64 if overrun else 1 << 12
                a, t = to_dev(acc), to_dev(touch)
                want = close.close_pack_delta_plain(
                    a, t, n_fetch, width, n_over_buf, n_blk_buf, BLK)
                for label, (_f, delta) in impls.items():
                    got = delta(a, t, n_fetch, width, n_over_buf, n_blk_buf,
                                BLK)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"close_pack_delta {label} != plain (width "
                            f"{width}, n_fetch {n_fetch}, overrun "
                            f"{overrun})")
                host = want.cpu().numpy().view(np.uint32)
                seen["n_touched"].add(int(host[-4]) > n_blk_buf)
                seen["n_over_delta"].add(int(host[-3]) > n_over_buf)
                seen["untouched"].add(int(host[-2]) != 0)
                seen["tail_delta"].add(int(host[-1]) != 0)
                cases += 2
    for name, vals in seen.items():
        if vals != {False, True}:
            raise AssertionError(f"close guard {name} read only {vals}")
    check_s = time.perf_counter() - t0

    # Timing at the main path's largest prefix: width 8, n_fetch 2^20; the
    # delta form with 4,096 fetched blocks, phase 6's shape.
    n_fetch, width = ID_CAP, 8
    acc, _ = close_case(1, n_fetch, width, 512, False)
    full = close_turns(impls, (to_dev(acc), n_fetch, width, 4096), False,
                       count=True)
    full["bound_ms"], full["bound_by"] = close_bound(
        n_fetch * width // 32 + 2 * 4096 + 2)
    n_blk_buf = 4096
    acc, touch = close_case(2, n_fetch, width, 512, False, n_touch=1563)
    delta = close_turns(impls, (to_dev(acc), to_dev(touch), n_fetch, width,
                                1024, n_blk_buf, BLK), True, count=True)
    delta["bound_ms"], delta["bound_by"] = close_bound(
        n_blk_buf * BLK * width // 32 + n_blk_buf + 2 * 1024 + 4,
        n_fetch // BLK)
    close.LAUNCHES.update(saved)
    # What any one launch costs here: an empty kernel, queued back to back.
    floor_ms = time_ms(lambda: torch.cuda._sleep(1), 50)
    emit("close_kernels", equal_cases=cases, equal_builds=list(impls),
         guards_nonzero_and_zero=True, check_s=check_s, id_cap=ID_CAP,
         launch_floor_ms=floor_ms,
         close_pack={"n_fetch": n_fetch, "width": width, "n_over_buf": 4096,
                     **full},
         close_pack_delta={"n_fetch": n_fetch, "width": width,
                           "n_blk_buf": n_blk_buf, "touched": 1563,
                           "n_over_buf": 1024, **delta},
         library_ms=None,
         library_note="no single PyTorch call packs with an ordered "
                      "sideband")
    sketch_library(dev)


# The count-min and HLL of the dict+cm path (ops/sketch.py's shapes) at a
# phase-6 window's absorb.
SKETCH_ROWS = 1 << 16
# Streams of the default specs at which both B6 kernels are timed (the
# shape rule's CLUSTER_MIN_ROWS lies among them).
SKETCH_SWEEP_ROWS = (1 << 16, 1 << 18, 1 << 20, 1 << 21, 1 << 22)


def sketch_direct(lib, kind, ht, ct, cm_spec, hll_spec, live_counts):
    """One B6 kernel of `lib` called as ops/sketch.py calls it, whatever
    the shape rule says: "global" (pa_sketch_build, PR 11's C interface)
    or "cluster" (pa_sketch_build_cluster). Returns (cm, regs, totals);
    launches are not counted."""
    import torch

    from parca_agent_tpu_torch.ops import kernels, sketch

    dev = ht.device
    n_nodes = ht.shape[0] if ht.dim() == 2 else 1
    r = ht.shape[-1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    cm = zeros(cm_spec.depth, cm_spec.width)
    regs, totals = zeros(hll_spec.m), zeros(n_nodes)
    seeds = tuple(sketch._ROW_SEEDS[:cm_spec.depth]) \
        + (0,) * (sketch._MAX_DEPTH - cm_spec.depth)
    mode = 2 if live_counts else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind == "global":
        code = lib.pa_sketch_build(
            ht.data_ptr(), ct.data_ptr(), None, n_nodes, r, mode,
            cm.data_ptr(), cm_spec.depth, cm_spec.width, *seeds,
            regs.data_ptr(), hll_spec.p, sketch._HLL_SEED,
            int(hll_spec.p <= sketch.SHARED_REGS_MAX_P), totals.data_ptr(),
            stream)
    else:
        parts = lib.pa_sketch_cluster_parts(n_nodes, r, cm_spec.depth,
                                            cm_spec.width, hll_spec.p, 1)
        if parts < 0:
            kernels.check_launch(lib, -parts, "sketch_build_cluster")
        code = lib.pa_sketch_build_cluster(
            ht.data_ptr(), ct.data_ptr(), None, n_nodes, r, mode,
            cm.data_ptr(), cm_spec.depth, cm_spec.width, *seeds,
            regs.data_ptr(), hll_spec.p, sketch._HLL_SEED, totals.data_ptr(),
            parts, stream)
    kernels.check_launch(lib, code, f"direct sketch_build ({kind})")
    return cm, regs, totals


def b6_case(dev, h, cnt, live_counts: bool, reps: int = 20, cm_spec=None,
            ref=None, want=None) -> dict:
    """B6, the sketch build (csrc/sketch_build.cu, replacing
    parca_agent_tpu/ops/sketch.py cm_build and hll_build) on one stream:
    hashes `h` (u32) and counts `cnt` (int32), [R] or [n_nodes, R], into a
    count-min table (cm_spec, default 4 x 2^18 int32) and 2^12 HLL
    registers, with each node's total; HLL liveness count > 0 when
    `live_counts` (the fleet's), else every row. `kernel` is the shape
    rule's choice (ops/sketch.py:sketch_kernel_for). The wrapper must
    equal its plain version on the card and the numpy paths (cm_build,
    hll_build, the int64 totals) word for word. Times the wrapper, the
    plain version, the library calls given the buckets, registers and
    ranks (index_add_ into the flattened table; scatter_reduce_ "amax"),
    and the bound: hashes and counts read once, each cell and register
    the rows touch read and written once. Where the cluster kernel takes
    the stream: the global kernel (PR 11's) and `ref` (a reference
    build's, --sketch-reference) held against it and timed in turns with
    it. `want`: the numpy paths' (cm, registers) when the caller has them.
    Its launches are restored."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.ops import kernels, sketch
    from parca_agent_tpu_torch.ops.hashing import mix32

    saved = dict(sketch.LAUNCHES)
    cm_spec = cm_spec or sketch.CountMinSpec()
    hll_spec = sketch.HLLSpec()
    kind = sketch.sketch_kernel_for(h.size, cm_spec, hll_spec)
    fh, fc = h.ravel(), cnt.ravel()
    live = fc > 0 if live_counts else np.ones(len(fh), bool)
    ht = torch.from_numpy(np.ascontiguousarray(h).view(np.int32)).to(dev)
    ct = torch.from_numpy(np.ascontiguousarray(cnt)).to(dev)
    arg = "counts" if live_counts else None
    want_cm, want_hll = want or (sketch.cm_build(fh, fc, cm_spec),
                                 sketch.hll_build(fh, hll_spec, live=live))
    want_tot = cnt.reshape(-1, cnt.shape[-1]).astype(np.int64).sum(axis=1)
    got = [x.cpu().numpy() for x in sketch.sketch_build(ht, ct, cm_spec,
                                                        hll_spec, arg)]
    plain = [x.cpu().numpy() for x in sketch.sketch_build_plain(
        ht, ct, cm_spec, hll_spec, arg)]
    for name, g, p_, w in zip(("count-min", "registers", "totals"), got,
                              plain, (want_cm, want_hll, want_tot)):
        if not (np.array_equal(g, p_) and np.array_equal(g, w)):
            raise AssertionError(f"B6: the kernel's {name} differ from the "
                                 "plain version's or the numpy paths'")
    # The library calls' inputs, from the numpy paths.
    cells = (sketch.cm_buckets(fh, cm_spec).astype(np.int64)
             + np.arange(cm_spec.depth)[:, None] * cm_spec.width).ravel()
    hm = mix32(fh[live], sketch._HLL_SEED)
    reg = (hm >> np.uint32(32 - hll_spec.p)).astype(np.int64)
    suffix = (hm << np.uint32(hll_spec.p)).astype(np.uint64)
    nbits = 32 - hll_spec.p
    rank = np.full(len(hm), nbits + 1, np.int32)
    for b in range(nbits - 1, -1, -1):
        rank = np.where((suffix >> np.uint64(31 - b)) & np.uint64(1), b + 1,
                        rank)
    regs = np.zeros(hll_spec.m, np.int32)
    np.maximum.at(regs, reg, rank)
    if not np.array_equal(regs, want_hll):
        raise AssertionError("B6: the HLL ranks differ from hll_build's")
    cells_t = torch.from_numpy(cells).to(dev)
    src = ct.reshape(-1).repeat(cm_spec.depth)
    reg_t, rank_t = (torch.from_numpy(x).to(dev) for x in (reg, rank))
    table = torch.zeros(cm_spec.depth * cm_spec.width, dtype=torch.int32,
                        device=dev)
    hll = torch.zeros(hll_spec.m, dtype=torch.int32, device=dev)
    out = {
        "rows": int(len(fh)), "shape": list(h.shape), "kernel": kind,
        "cm": [cm_spec.depth, cm_spec.width], "hll_p": hll_spec.p,
        "live": "count > 0" if live_counts else "every row",
        "ms": time_ms(lambda: sketch.sketch_build(ht, ct, cm_spec, hll_spec,
                                                  arg), reps),
        "plain_ms": time_ms(lambda: sketch.sketch_build_plain(
            ht, ct, cm_spec, hll_spec, arg), 3),
        "library_calls_ms": {
            "cm_index_add": time_ms(lambda: table.index_add_(
                0, cells_t, src), reps),
            "hll_scatter_reduce_amax": time_ms(lambda: hll.scatter_reduce_(
                0, reg_t, rank_t, "amax"), reps)},
        "touched_cells": int(len(np.unique(cells))),
        "touched_registers": int(len(np.unique(reg)))}
    if kind == "cluster":
        lib = kernels.load("sketch_build")
        out["parts"] = lib.pa_sketch_cluster_parts(
            *((h.shape[0], h.shape[1]) if h.ndim == 2 else (1, h.shape[0])),
            cm_spec.depth, cm_spec.width, hll_spec.p, 1)
        impls = {
            "cluster": lambda: sketch.sketch_build(ht, ct, cm_spec, hll_spec,
                                                   arg),
            "global": lambda: sketch_direct(lib, "global", ht, ct, cm_spec,
                                            hll_spec, live_counts)}
        if ref is not None:
            impls["reference"] = lambda: sketch_direct(
                ref, "global", ht, ct, cm_spec, hll_spec, live_counts)
        for name, fn in impls.items():
            if not all(np.array_equal(x.cpu().numpy(), w) for x, w in
                       zip(fn(), (want_cm, want_hll, want_tot))):
                raise AssertionError(f"B6: {name} differs from the numpy "
                                     "paths")
        out["turns_ms"] = time_turns(impls, reps)
    out["library_ms"] = sum(out["library_calls_ms"].values())
    nbytes = 8 * len(fh) + 8 * (out["touched_cells"]
                                + out["touched_registers"])
    # fmix32 a row per count-min row and for the HLL (~8 operations each),
    # an add a cell, the rank's leading-zero count and a max.
    ops = len(fh) * (8 * (cm_spec.depth + 1) + cm_spec.depth + 2)
    out["bytes"] = nbytes
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops)
    sketch.LAUNCHES.update(saved)
    return out


def sketch_library(dev) -> None:
    """B6 at a phase-6 window's absorb: SKETCH_ROWS rows of random hashes
    and counts into the dict+cm path's sketch shapes (the port absorbs
    on the host; this is the yardstick of the kernel's row in PERF.md at
    that shape); then both B6 kernels, called directly and held against
    the numpy paths, timed in turns at SKETCH_SWEEP_ROWS rows (where the
    shape rule's CLUSTER_MIN_ROWS comes from)."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.ops import kernels, sketch

    rng = np.random.default_rng(6)
    h = rng.integers(0, 1 << 32, SKETCH_SWEEP_ROWS[-1], dtype=np.uint64
                     ).astype(np.uint32)
    cnt = rng.integers(1, 16, len(h)).astype(np.int32)
    emit("sketch_b6", **b6_case(dev, h[:SKETCH_ROWS], cnt[:SKETCH_ROWS],
                                live_counts=False, reps=50))
    lib = kernels.load("sketch_build")
    spec, hll = sketch.CountMinSpec(), sketch.HLLSpec()
    sweep = {}
    for rows in SKETCH_SWEEP_ROWS:
        ht = torch.from_numpy(h[:rows].view(np.int32)).to(dev)
        ct = torch.from_numpy(cnt[:rows]).to(dev)
        want = sketch.sketch_build_plain(ht, ct, spec, hll)
        impls = {k: (lambda k=k: sketch_direct(lib, k, ht, ct, spec, hll,
                                               False))
                 for k in ("global", "cluster")}
        for k, fn in impls.items():
            if not all(torch.equal(x, w) for x, w in zip(fn(), want)):
                raise AssertionError(f"B6: the {k} kernel differs from the "
                                     f"plain version at {rows} rows")
        sweep[rows] = {"rule": sketch.sketch_kernel_for(rows, spec, hll),
                       **time_turns(impls, 50)}
    emit("sketch_b6_rows", cluster_min_rows=sketch.CLUSTER_MIN_ROWS,
         ms_turns=sweep)


# -- phase 4 -----------------------------------------------------------------


def window_setup(rows: int = ROWS, pids: int = PIDS,
                 label: str = "main_path_setup"):
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
    emit(label, rows=len(snap), pids=pids, samples=snap.total_samples(),
         generate_s=gen_s, oracle_s=oracle_s)
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


def sample_profiles(agg, snap, counts, every: int = 64):
    """_build_profiles of every `every`-th live pid (in pid order), built
    from those pids' counts alone."""
    import numpy as np

    id_pid = agg._id_pid[:len(counts)]
    live = np.unique(id_pid[counts > 0])
    keep = np.isin(id_pid, live[::every]) & (counts > 0)
    return agg._build_profiles(snap, np.where(keep, counts, 0))


def check_window(label: str, agg, snap, counts, blobs, mass: dict,
                 values, pprof: bool = True) -> dict:
    """Raise unless check_counts holds and the encoder's blobs are one for
    every live pid and (with `pprof`) build_pprof's samples for every
    64th. Returns check_encoded's fields."""
    profiles = check_counts(label, agg, snap, counts, mass, values)
    return check_encoded(label, agg, snap, counts, blobs,
                         every=1 if pprof else 0, profiles=profiles)


def check_counts(label: str, agg, snap, counts, mass: dict, values):
    """Raise unless `counts` hold the window's total and, for every pid,
    the oracle's mass (`mass`: pid -> samples), and every 64th live pid
    its oracle's sorted stack counts (`values(pid)`). Returns those pids'
    profiles."""
    import numpy as np

    if int(counts.sum()) != snap.total_samples():
        raise AssertionError(f"{label}: total {int(counts.sum())} != "
                             f"{snap.total_samples()}")
    id_pid = agg._id_pid[:len(counts)].astype(np.int64)
    got = np.bincount(id_pid, weights=counts.astype(np.float64))
    live = np.flatnonzero(got)
    if {int(p): int(got[p]) for p in live} != mass:
        raise AssertionError(f"{label}: per-pid mass differs")
    profiles = sample_profiles(agg, snap, counts)
    for p in profiles:
        if sorted(p.values.tolist()) != sorted(values(p.pid)):
            raise AssertionError(f"{label}: pid {p.pid} stack counts")
    return profiles


def check_encoded(label: str, agg, snap, counts, blobs, every: int = 64,
                  profiles=None) -> dict:
    """Raise unless the window encoder's [(pid, bytes)] hold exactly one
    blob for every pid with samples, and (unless `every` is 0) every
    `every`-th pid's blob parses to the samples, locations and mappings
    of build_pprof of _build_profiles (`profiles`, all of the window's;
    by default only those pids' are built). Returns the pids checked and
    build_pprof's time."""
    import numpy as np

    from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof

    pids = [p for p, _ in blobs]
    live = np.unique(agg._id_pid[:len(counts)][np.asarray(counts) > 0])
    if len(set(pids)) != len(pids) or sorted(pids) != live.tolist():
        raise AssertionError(f"{label}: {len(pids)} blobs for {len(live)} "
                             "live pids")
    if not every:
        return {}
    if profiles is None:
        sample = sample_profiles(agg, snap, counts, every)
    else:
        sample = profiles[::every]
    by_pid = dict(blobs)
    t0 = time.perf_counter()
    want = [parse_pprof(build_pprof(p, compress=False)) for p in sample]
    build_ms = (time.perf_counter() - t0) * 1e3
    for prof, w in zip(sample, want):
        have = parse_pprof(bytes(by_pid[prof.pid]))
        if {k: v for k, v in have.stacks_by_address().items() if v > 0} \
                != w.stacks_by_address() or have.locations != w.locations \
                or have.mappings != w.mappings or have.period != w.period:
            raise AssertionError(f"{label}: pid {prof.pid}'s encoded "
                                 "profile != build_pprof's")
    return {"pids_checked": len(sample), "build_pprof_ms": build_ms}


def phase_main_path(dev, snap, want, steady: int = STEADY_WINDOWS,
                    ref=None, vec_rec=None):
    """The dict main path on `dev` over `snap`, every window encoded by
    one WindowEncoder (--fast-encode), the last one also through the
    encode pipeline, then through one carrying the analytics
    (main_path_analytics); returns its kernels' launch counts, the
    dictionary's exported state after its last window, the window's
    hashes and the last window's [(pid, pprof bytes)] as the pipeline
    shipped them (phase 13 ships them to a store). Raises on any disagreement with the numpy oracle or with
    build_pprof. `vec_rec` (a VecRecorder) records the cold encode's
    varint and ragged-copy calls."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
    from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    total = snap.total_samples()
    vec_rec = vec_rec or VecRecorder()
    agg = DictAggregator(capacity=CAP, overflow="raise", device=dev)
    t0 = time.perf_counter()
    hashes = agg.hash_rows(snap)  # the capture-carried identity triple
    hash_s = time.perf_counter() - t0
    want_mass = {p.pid: p.total() for p in want}
    want_by_pid = {p.pid: p for p in want}

    def want_values(pid):
        return want_by_pid[pid].values.tolist()

    # Every count to 0 just before the main path; read just after.
    probe.reset_launches()
    close.reset_launches()
    launches_per_feed = []

    t0 = time.perf_counter()
    before = probe.LAUNCHES["feed_accumulate"]
    counts = agg.window_counts(snap, hashes)
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches_per_feed.append(probe.LAUNCHES["feed_accumulate"] - before)
    # The cold window's pprof: the encoder builds every pid's statics.
    # Its varint and ragged-copy calls are recorded for phase 10 (the
    # copies' time is taken out of encode_ms and printed apart).
    enc = WindowEncoder(agg)
    args = (snap.time_ns, snap.window_ns, snap.period_ns)
    t0 = time.perf_counter()
    with vec_rec:
        blobs = enc.encode(counts, *args)
    encode_ms = (time.perf_counter() - t0) * 1e3 - vec_rec.record_ms
    checked = check_window("cold window", agg, snap, counts, blobs,
                           want_mass, want_values)
    emit("cold_window", ms=cold_ms, inserts=agg.stats["inserts"],
         encode_ms=encode_ms, window_to_pprof_ms=cold_ms + encode_ms,
         encode_timings_ms={k: v * 1e3 for k, v in enc.timings.items()},
         statics_build_ms=enc.stats["statics_build_s_total"] * 1e3,
         pprof_pids=len(blobs), pprof_bytes=sum(len(b) for _, b in blobs),
         encode_record_ms=vec_rec.record_ms, vec_calls=len(vec_rec.calls),
         **checked, hash_s=hash_s, timings_ms={k: v * 1e3
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
        # pprof for every pid through the encoder: close start to the last
        # pid's bytes.
        t0 = time.perf_counter()
        blobs = enc.encode(counts, snap.time_ns + w + 1, *args[1:])
        encode_ms = (time.perf_counter() - t0) * 1e3
        to_pprof_ms = (time.perf_counter() - t_close) * 1e3
        window_ms = (time.perf_counter() - t_win) * 1e3
        # The yardstick: build_pprof of every 64th pid.
        checked = check_window(f"steady window {w}", agg, snap, counts,
                               blobs, want_mass, want_values)
        steady_rows.append({
            "window": w, "feed_dispatch_ms": feed_ms,
            "feed_dispatch_ms_sum": sum(feed_ms), "close_ms": close_ms,
            "close_dispatch_ms": agg.timings.get("close_dispatch", 0.0) * 1e3,
            "encode_ms": encode_ms,
            "encode_timings_ms": {k: v * 1e3
                                  for k, v in enc.timings.items()},
            "window_to_pprof_ms": to_pprof_ms,
            "pprof_pids": len(blobs),
            "pprof_bytes": sum(len(b) for _, b in blobs),
            **checked, "window_ms": window_ms,
            "inserts": agg.stats["inserts"],
            "delta_closes": agg.stats.get("delta_closes", 0),
            "fetch_bytes_last": agg.stats.get("fetch_bytes_last"),
            "feeds_and_close_ms": feed_close_s * 1e3,
            "samples_per_s": total / feed_close_s,
            "timings_ms": {k: v * 1e3 for k, v in agg.timings.items()},
        })
        emit("steady_window", **steady_rows[-1])
    launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                "close_pack": close.LAUNCHES["close_pack"]}
    # The last window again, handed to the encode pipeline's worker: it
    # must ship the inline bytes.
    shipped = []
    pipe = EncodePipeline(enc, ship=lambda out, prep: shipped.extend(
        (pid, bytes(b)) for pid, b in out))
    t0 = time.perf_counter()
    if pipe.submit(counts, snap.time_ns + steady, *args[1:]) is None:
        raise AssertionError("the encode pipeline refused the window")
    handoff_ms = (time.perf_counter() - t0) * 1e3
    if not pipe.close(600):
        raise AssertionError("the encode pipeline did not flush")
    pipe_ms = (time.perf_counter() - t0) * 1e3
    bad = {k: pipe.stats[k] for k in ("backpressure_fallbacks",
                                      "encoder_exceptions", "windows_lost")
           if pipe.stats[k]}
    if bad or pipe.stats["windows_pipelined"] != 1:
        raise AssertionError(f"encode pipeline stats: {pipe.stats}")
    if shipped != [(pid, bytes(b)) for pid, b in blobs]:
        raise AssertionError("pipelined blobs != the inline encode's")
    emit("main_path_pipeline", handoff_ms=handoff_ms, submit_to_ship_ms=pipe_ms,
         encode_ms=pipe.stats["last_encode_s"] * 1e3,
         ship_ms=pipe.stats["last_ship_s"] * 1e3, pids=len(shipped),
         bytes=sum(len(b) for _, b in shipped),
         encoder_stats=dict(enc.stats))
    # And once more through a pipeline carrying the analytics.
    main_path_analytics(agg, enc, counts, shipped, snap.time_ns + steady,
                        *args[1:], want_mass)
    del blobs
    if min(launches_per_feed) < 1:
        raise AssertionError(f"a feed launched no probe kernel: "
                             f"{launches_per_feed}")
    if launches["close_pack"] < 1 + steady:
        raise AssertionError(f"the windows' closes launched the close "
                             f"kernel {launches['close_pack']} times")
    # How far the window's rows walk in the dictionary's table (the host
    # mirror of the device table, at this window's load): slots read a
    # row, and rounds of the probe kernel's group a row.
    table = host_table(agg)
    steps, _slots, _found = probe_work(table, *hashes, probe.PROBES)
    emit("main_path", launches=launches, feeds=len(launches_per_feed),
         launches_per_feed=launches_per_feed,
         table_load=float(agg._occ.mean()),
         probe_step_hist=np.bincount(steps).tolist())
    drain_k1(dev, agg, table,
             drain_packed(snap, hashes, int(bounds[0]), int(bounds[1])),
             "main_path_drain_k1", ref)
    return launches, agg.export_state(), hashes, shipped


HOTSPOT_K = 50


def hotspot_oracle(agg, counts):
    """The window's exact (h1 << 32 | h2) -> count: the ids' counts
    summed by their 64-bit content hash."""
    import numpy as np

    ids = np.flatnonzero(counts)
    h1, h2 = agg.id_hashes(int(ids.max()) + 1)
    key = (h1[ids].astype(np.uint64) << np.uint64(32)) \
        | h2[ids].astype(np.uint64)
    uniq, inv = np.unique(key, return_inverse=True)
    mass = np.bincount(inv, weights=counts[ids].astype(np.float64))
    return uniq, mass.astype(np.int64)


def check_hotspots(label: str, answer: dict, uniq, mass,
                   exact_top: bool = False) -> dict:
    """Hold a /hotspots answer to the exact counts `uniq` -> `mass`
    (docs/hotspots.md's contract): with cut 0 its top K is the oracle's
    top K, each count exact; otherwise each stack's exact count lies
    between the answer's count and its count-min estimate. With
    `exact_top` (an answer from one summary of distinct stacks, whose
    candidates are the stream's heaviest) its top K is the oracle's
    whatever the cut."""
    import numpy as np

    entries = answer["entries"]
    keys = np.array([int(e["stack"], 16) for e in entries], np.uint64)
    pos = np.searchsorted(uniq, keys)
    want_n = min(HOTSPOT_K, len(uniq))
    complete = exact_top or answer["cut"] == 0
    if len(entries) > want_n or (complete and len(entries) < want_n) \
            or (pos >= len(uniq)).any() or (uniq[pos] != keys).any():
        raise AssertionError(f"{label}: {len(entries)} entries, or a stack "
                             "the window does not hold")
    exact = mass[pos]
    got = np.array([e["count"] for e in entries], np.int64)
    est = np.array([e["estimate"] for e in entries], np.int64)
    if complete:
        top = np.sort(mass)[::-1][:HOTSPOT_K]
        if not (np.array_equal(got, exact) and np.array_equal(got, top)):
            raise AssertionError(f"{label}: the top {HOTSPOT_K} differs "
                                 "from the oracle's")
    elif ((got > exact) | (exact > est)).any():
        raise AssertionError(f"{label}: an exact count outside [count, "
                             "estimate]")
    return {"cut": answer["cut"], "exact": answer["exact"],
            "top_count": int(got[0]) if len(got) else 0,
            "oracle_top_count": int(mass.max()),
            "max_estimate_over": int((est - exact).max()) if len(got) else 0}


def main_path_analytics(agg, enc, counts, blobs, time_ns: int,
                        window_ns: int, period_ns: int, want_mass):
    """Phase 4's analytics (module docs): the last steady window's
    `counts` through an EncodePipeline carrying a HotspotStore, a
    RegressionSentinel and a SinkRegistry (pprof, AutoFDO and alerts
    into a temporary directory, series), attached through the
    pipeline's rollup, rollup_capture and sink_capture hooks as the CLI
    attaches them. Every pid's shipped bytes must equal `blobs`, the
    same window's bytes without the sinks; the store's top K is held to
    the window's exact counts. The analytics launch no kernel: the
    window's K1 and B2 launches are the dict path's."""
    import os
    import tempfile

    import numpy as np

    from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline
    from parca_agent_tpu_torch.runtime.hotspots import (
        HotspotStore,
        RegistryView,
    )
    from parca_agent_tpu_torch.runtime.regression import RegressionSentinel
    from parca_agent_tpu_torch.sinks import (
        AlertsSink,
        AutoFDOSink,
        PprofSink,
        SeriesSink,
        SinkRegistry,
    )

    args = (time_ns, window_ns, period_ns)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-analytics-")
    store = HotspotStore()
    sentinel = RegressionSentinel()
    afdo = AutoFDOSink(os.path.join(tmp, "afdo"), flush_windows=1)
    series = SeriesSink()
    registry = SinkRegistry([PprofSink(), afdo, series,
                             AlertsSink(os.path.join(tmp, "alerts.jsonl"),
                                        sentinel=sentinel)])
    sentinel.bind_staleness(afdo.mark_stale)
    shipped = []
    registry.bind(ship=lambda out: shipped.extend(
        (pid, bytes(b)) for pid, b in out))

    def capture(prep):
        return RegistryView(agg)

    def rollup(prep, ctx):
        try:
            store.fold_from_aggregator(ctx, prep.idx, prep.vals,
                                       prep.time_ns, prep.duration_ns)
        finally:
            sentinel.fold_from_prepared(ctx, prep)

    pipe = EncodePipeline(enc, ship=registry.emit_window, rollup=rollup,
                          rollup_capture=capture, sink_capture=capture)
    t0 = time.perf_counter()
    if pipe.submit(counts, *args) is None:
        raise AssertionError("the encode pipeline refused the window")
    handoff_ms = (time.perf_counter() - t0) * 1e3
    if not pipe.close(600):
        raise AssertionError("the encode pipeline did not flush")
    pipe_ms = (time.perf_counter() - t0) * 1e3
    registry.close()
    bad = {k: pipe.stats[k] for k in (
        "backpressure_fallbacks", "encoder_exceptions", "windows_lost",
        "ship_errors", "rollup_errors", "sink_capture_errors")
        if pipe.stats[k]}
    if bad or pipe.stats["windows_pipelined"] != 1 \
            or pipe.stats["windows_rolled"] != 1:
        raise AssertionError(f"encode pipeline stats: {pipe.stats}")
    if shipped != blobs:
        raise AssertionError("the pipeline's bytes with the sinks != the "
                             "same window's without them")

    uniq, mass = hotspot_oracle(agg, counts)
    heavy = max(want_mass, key=want_mass.get)
    t0 = time.perf_counter()
    answer = store.query(k=HOTSPOT_K)
    query_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    by_pid = store.query(k=HOTSPOT_K, selector={"pid": str(heavy)})
    query_pid_ms = (time.perf_counter() - t0) * 1e3
    # One window's summary: its candidates are the window's heaviest.
    checked = check_hotspots("analytics hotspots", answer, uniq, mass,
                             exact_top=True)
    mine = agg._id_pid[:len(counts)] == heavy
    checked_pid = check_hotspots(
        "analytics hotspots pid", by_pid,
        *hotspot_oracle(agg, np.where(mine, counts, 0)))
    sm = sentinel.metrics()
    if store.stats["windows_folded"] != 1 or store.stats["fold_errors"] \
            or sm["windows_folded"] != 1 or sm["fold_errors"]:
        raise AssertionError(f"analytics folds: {store.stats}, {sm}")
    files = sorted(os.listdir(os.path.join(tmp, "afdo")))
    afdo_bytes = sum(os.path.getsize(os.path.join(tmp, "afdo", f))
                     for f in files)
    if not any(f.endswith(".afdo.txt") for f in files):
        raise AssertionError(f"no AutoFDO profdata: {files}")
    sinks = registry.metrics()
    if any(st.get("errors") for k, st in sinks.items() if k != "_registry"):
        raise AssertionError(f"sink errors: {sinks}")
    row = {"handoff_ms": handoff_ms, "submit_to_ship_ms": pipe_ms,
           "encode_ms": pipe.stats["last_encode_s"] * 1e3,
           "ship_ms": pipe.stats["last_ship_s"] * 1e3,
           "rollup_ms": pipe.stats["last_rollup_s"] * 1e3,
           "pids": len(shipped), "bytes": sum(len(b) for _, b in shipped),
           "hotspots": {"fold_ms": store.stats["last_fold_s"] * 1e3,
                        "query_ms": query_ms, "query_pid_ms": query_pid_ms,
                        "rows": int(np.count_nonzero(counts)),
                        "stacks": int(len(uniq)),
                        "top": checked, "pid": heavy, "top_pid": checked_pid},
           "regression": {"fold_ms": sm["last_fold_s"] * 1e3,
                          "groups": sm["groups"],
                          "rows_dropped": sm["rows_dropped"],
                          "windows_folded": sm["windows_folded"]},
           "autofdo": {"files": len(files), "bytes": afdo_bytes,
                       "samples": sinks["autofdo"]["samples"],
                       "emit_ms": sinks["autofdo"]["last_emit_s"] * 1e3},
           "series": {"records": len(series.series()),
                      "emit_ms": sinks["series"]["last_emit_s"] * 1e3},
           "sink_emit_ms": {k: st["last_emit_s"] * 1e3
                            for k, st in sinks.items() if k != "_registry"}}
    emit("main_path_analytics", **row)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)


def drain_packed(snap, hashes, lo: int, hi: int):
    """The window's rows lo:hi packed as feed() packs a drain: uint32
    [4, n_pad] (h1, h2, h3, count), padded to a power of two with dead
    rows."""
    import numpy as np

    nd = hi - lo
    packed = np.zeros((4, 1 << max(4, (nd - 1).bit_length())), np.uint32)
    for k in range(3):
        packed[k, :nd] = hashes[k][lo:hi]
    packed[3, :nd] = snap.counts[lo:hi].astype(np.uint32)
    return packed


def host_table(agg):
    """The host mirror of a dictionary's device table, as the probe reads
    it: (h1, h2, h3, id + 1, or 0 for a free slot) a slot."""
    import numpy as np

    table = np.zeros((agg._cap, 4), np.uint32)
    table[:, 0], table[:, 1], table[:, 2] = agg._h1, agg._h2, agg._h3
    table[:, 3] = np.where(agg._occ, agg._ids + 1, 0).astype(np.uint32)
    return table


def drain_k1(dev, agg, table, packed, label: str, ref=None) -> dict:
    """K1 (feed_accumulate) on a dictionary's own device table (`table`
    its host mirror) at one drain's dispatched rows `packed` (uint32
    [4, n_pad], as feed() packs them). The kernel (and the reference
    build) against the plain version, then timed (in turns with the
    reference) beside the plain version and the bound of this drain's
    data. Launches made here are not counted. Emits `label` and returns
    its fields."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import probe

    saved = dict(probe.LAUNCHES)
    n_pad = packed.shape[1]
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
    for name, fn in impls.items():
        got = run(fn)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"feed_accumulate {name} != plain at "
                                 f"{label}")
    acc = torch.zeros(agg._id_cap, dtype=torch.int32, device=dev)
    touch = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    timed = time_turns({name: (lambda fn=fn: fn(
        agg._dev, acc, touch, blk, *lanes)) for name, fn in impls.items()},
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
    row = {"rows": int((packed[3] > 0).sum()), "n_pad": n_pad,
           "hits": int(hit.sum()), "table_slots": len(table),
           "id_cap": agg._id_cap,
           "probe_step_hist": np.bincount(steps).tolist(), "ms_turns": timed,
           "ms": min(timed["kernel"]), "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "equal": True,
           **({"reference_ms": min(timed["reference"])} if ref else {})}
    emit(label, **row)
    return row


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
    part_us, covered = {}, True
    for name, fn in parts.items():
        part_us[name], ok = host_us(fn, reps)
        covered &= ok

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

    out = {"host_us": part_us, "covered": covered, "reps": reps}
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


def phase_one_shot(dev, snap, want, fast_encode, rh_refs=None) -> dict:
    """The one-shot aggregator (--aggregator tpu) on `dev` over the same
    window: (b) aggregate() with the hash arm once, checked against the
    oracle with its kernel launches counted; (c) the sort arm's outputs
    and pprof against that run's; (a) both kernels against their
    plain versions at the window's shapes, timed (the row hash in turns
    with the reference builds `rh_refs`, label -> fn, at this window and
    at (e)'s two), with the row hash stage's host cost; (d) the CLI
    entry, and fast_encode_cli's runs (`fast_encode`, started by
    start_background); (e) the dedup arms on two windows below the location warning
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

    # (b) The main path, once (its kernels were built in phase 2): counts
    # go to 0 just before the run and are read just after it.
    agg = tpu.TPUAggregator(dedup="hash", device=dev)
    # The entry point, keeping the window outputs it computes so that the
    # sort arm below is held to this run's.
    kept = []

    def keep_outputs(s, window_outputs=agg.window_outputs):
        kept.append(window_outputs(s))
        return kept[-1]

    agg.window_outputs = keep_outputs
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
    emit("one_shot_window", window_ms=window_ms,
         launches=launches, host_ms=ms(agg.timings),
         device_ms=agg.device_ms, profiles=len(profiles), **stats)

    # (c) The sort arm: the same 10 outputs, bit for bit, and pprof bytes.
    (snap_h, outs_h), = kept
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
        rc = cli.run([*NO_PROBE, *HTTP_ANY, "--aggregator", "tpu",
                      "--windows", "2",
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
    fast_encode_cli(fast_encode)

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


class Collected:
    """A started process, drained from its start by a thread (a full pipe
    never stalls it) and killed past `timeout_s` or at this script's
    exit; result() waits for (returncode, stdout, stderr, wall seconds
    from its start to its exit)."""

    def __init__(self, argv: list, env: dict, timeout_s: float):
        import threading

        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=HERE, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        proc = self.proc
        atexit.register(lambda: proc.poll() is None and proc.kill())
        self._out = None
        self._thread = threading.Thread(target=self._drain,
                                        args=(timeout_s,), daemon=True)
        self._thread.start()

    def _drain(self, timeout_s: float) -> None:
        try:
            out, err = self.proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, err = self.proc.communicate()
        self._out = (self.proc.returncode, out, err,
                     time.perf_counter() - self._t0)

    def result(self) -> tuple:
        self._thread.join()
        return self._out


def cli_env() -> dict:
    """The environment of a CLI child: this checkout first on its path."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def start_cli(store: Path, *flags, period: float = 0.1):
    """`python -m parca_agent_tpu_torch` on the card over the CLI's
    synthetic windows, one every `period` seconds, into `store`, started
    (finish_cli waits for it; killed past 600 s)."""
    argv = [sys.executable, "-m", "parca_agent_tpu_torch", "--capture",
            "synthetic", "--windows", str(CLI_WINDOWS), "--profiling-duration",
            str(period), "--local-store-directory", str(store), *NO_PROBE,
            *HTTP_ANY, *flags]
    return Collected(argv, cli_env(), 600), flags


def finish_cli(started) -> list:
    """The started CLI's JSON lines by window, once it exits; raises
    unless it exits 0 with one line a window."""
    run, flags = started
    rc, out, err, _ = run.result()
    if rc != 0:
        raise AssertionError(f"CLI {' '.join(flags)}: rc {rc}: "
                             f"{err[-2000:]}")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    runtime = [ln["runtime"] for ln in lines if "runtime" in ln]
    lines = sorted((ln for ln in lines if "window" in ln),
                   key=lambda ln: ln["window"])
    if [ln["window"] for ln in lines] != list(range(1, CLI_WINDOWS + 1)):
        raise AssertionError(f"CLI {' '.join(flags)}: windows "
                             f"{[ln['window'] for ln in lines]}")
    cli_runtime_clean(f"CLI {' '.join(flags)}", runtime)
    return lines


def cli_runtime_clean(label: str, runtime: list) -> None:
    """A clean CLI run's one {"runtime": ...} exit line: no hang or
    dispatch error under the default watchdogs, the card healthy."""
    if len(runtime) != 1 or runtime[0]["watchdog"]["hangs"] \
            or runtime[0]["watchdog"]["errors"] \
            or runtime[0]["device"]["state"] != "healthy":
        raise AssertionError(f"{label}: runtime lines {runtime}")



FAST_ENCODE_ARMS = (("dict", ("--aggregator", "dict")),
                    ("dict+cm", ("--aggregator", "dict+cm",
                                 "--aggregator-capacity", str(1 << 15))))


def start_fast_encode_cli():
    """fast_encode_cli's four runs, started (start_background)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-fast-encode-"))
    # A window a second: the worker ships each window before the next
    # closes.
    return tmp, {name: (start_cli(tmp / name / "fast", *flags,
                                  "--fast-encode", period=1.0),
                        start_cli(tmp / name / "scalar", *flags))
                 for name, flags in FAST_ENCODE_ARMS}


def fast_encode_cli(started) -> None:
    """The CLI with --fast-encode (through the encode pipeline) on the
    card, --aggregator dict and dict+cm (a capacity the windows overflow):
    every stored profile parses, the store holds each window's mass, and
    each window's mass and profile count equal the same CLI's without
    --fast-encode. The four runs overlap (start_fast_encode_cli)."""
    import shutil

    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    out = {}
    tmp, started = started
    try:
        runs = {name: [finish_cli(x) for x in pair]
                for name, pair in started.items()}
        runs_s = max(run.result()[3] for pair in started.values()
                     for run, _ in pair)
        stores = {}
        for name, _ in FAST_ENCODE_ARMS:
            files = sorted((tmp / name / "fast").glob("*.pb.gz"))
            stores[name] = (len(files), sum(
                v[0] for f in files
                for _, v, _ in parse_pprof(f.read_bytes()).samples))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, (fast, scalar) in runs.items():
        n_files, mass = stores[name]
        if "pipeline" not in {ln["encode_path"] for ln in fast}:
            raise AssertionError(f"CLI {name}: no window went through the "
                                 "encode pipeline")
        got = [(ln["mass"], ln["profiles"]) for ln in fast]
        if got != [(ln["mass"], ln["profiles"]) for ln in scalar]:
            raise AssertionError(f"CLI {name}: --fast-encode windows {got} "
                                 "!= the CLI's without it")
        if n_files != sum(p for _, p in got) \
                or mass != sum(m for m, _ in got) or not mass:
            raise AssertionError(f"CLI {name}: the store holds {n_files} "
                                 f"profiles of mass {mass}, the windows "
                                 f"{got}")
        out[name] = {"windows": fast, "profiles": n_files, "mass": mass}
    emit("fast_encode_cli", runs_s=runs_s, **out)


# -- phase 6 -----------------------------------------------------------------

# The bounded-memory dictionary (--aggregator dict+cm) at the CLI's
# defaults: capacity 2^21 (id_cap 2^20), rotation after 6 windows unseen,
# 10 drains a window; per window the bench window's first HOT rows (ids
# 0..HOT-1 in phase 4's dictionary) and FRESH new stacks.
HOT = 200_000
FRESH = 65_536
ROTATE_MIN_AGE = 6
BOUNDED_WINDOWS = 8
INVALIDATE_NOW = 6      # after this window's close: N_INVALIDATE hot pids
INVALIDATE_DEFERRED = 6  # during this window's close: one pid, deferred
# Each immediate invalidate_pid compacts the whole id space, as in
# parca_agent_tpu.
N_INVALIDATE = 50


def window_rows(snap, idx, leaf_shift: int = 0):
    """The snapshot's rows `idx`; with `leaf_shift`, every row's leaf frame
    moves that many bytes inside its mapping (a new stack, a new
    location)."""
    import dataclasses

    import numpy as np

    stacks = snap.stacks[idx]
    if leaf_shift:
        stacks[:, 0] += np.uint64(leaf_shift)
    return dataclasses.replace(
        snap, pids=snap.pids[idx], tids=snap.tids[idx],
        counts=snap.counts[idx], user_len=snap.user_len[idx],
        kernel_len=snap.kernel_len[idx], stacks=stacks)


def bounded_window(snap, hashes, w: int):
    """Window w of phase 6: the hot rows, then FRESH rows of the bench
    window past them (another slice each window), leaf moved by 4 (w + 1)
    bytes; the window's snapshot and its (h1, h2, h3)."""
    import dataclasses

    import numpy as np

    from parca_agent_tpu_torch.ops.hashing import row_hash_np

    f0 = HOT + w * FRESH
    fresh = window_rows(snap, np.arange(f0, f0 + FRESH), 4 * (w + 1))
    fh = row_hash_np(fresh.stacks, fresh.pids, fresh.user_len,
                     fresh.kernel_len, n_hashes=3)
    win = dataclasses.replace(
        fresh, **{k: np.concatenate([getattr(snap, k)[:HOT],
                                     getattr(fresh, k)])
                  for k in ("pids", "tids", "counts", "user_len",
                            "kernel_len", "stacks")})
    return win, tuple(np.concatenate([h[:HOT], f]) for h, f in
                      zip(hashes, fh))


def reinsert_turns(agg) -> dict:
    """A compaction's re-insertion of the dictionary's keys as it stands
    (in id order, into an empty table): the vectorized placement the
    dictionary uses against one _probe_free call a key, as
    parca_agent_tpu re-inserts them. Fails unless the slots are equal."""
    import numpy as np

    from parca_agent_tpu_torch.aggregator.dict import _fcfs_slots, _probe_free

    occ = np.flatnonzero(agg._occ)
    home = np.empty(agg._next_id, np.int64)
    home[agg._ids[occ]] = agg._h1[occ].astype(np.int64) & (agg._cap - 1)
    t0 = time.perf_counter()
    got = _fcfs_slots(home, agg._cap)
    vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = np.zeros(agg._cap, bool)
    want = np.empty(len(home), np.int64)
    for i, h in enumerate(home.tolist()):
        want[i] = _probe_free(table, h)
        table[want[i]] = True
    one_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError("vectorized re-insertion != one key at a time")
    return {"keys": len(home), "vectorized_ms": vec_s * 1e3,
            "one_by_one_ms": one_s * 1e3}


def phase_bounded(dev, snap, hashes, state, close_refs=None) -> dict:
    """The dict+cm path on the card from phase 4's full dictionary
    (load_state), window by window, beside the same windows on the CPU
    from the same state: absorption while full, the rotation once the
    cold ids are ROTATE_MIN_AGE windows unseen, exact windows after it,
    pid invalidation at once and deferred. Returns the kernel rows of the
    close kernels, timed on this path's own accumulators, and the path's
    launch counts."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder

    aggs = {}
    t0 = time.perf_counter()
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        aggs[name] = DictAggregator(capacity=CAP, overflow="sketch",
                                    rotate_min_age=ROTATE_MIN_AGE, device=d)
        # The twin is held to the card's ids, counts and sketch; the
        # per-pid location registries serve only the card's encoder, and
        # loading them takes tens of seconds.
        aggs[name].load_state(state if name == "cuda"
                              else {**state, "registries": {}})
    load_s = time.perf_counter() - t0
    agg, twin = aggs["cuda"], aggs["cpu"]
    if agg._next_id != agg._id_cap:
        raise AssertionError(f"phase 4's dictionary holds {agg._next_id} "
                             f"ids, not id_cap {agg._id_cap}")
    hot_pids = np.unique(snap.pids[:HOT])
    inv_now = [int(p) for p in hot_pids[:N_INVALIDATE]]
    inv_later = int(hot_pids[N_INVALIDATE])
    emit("bounded_setup", load_state_s_both=load_s, id_cap=agg._id_cap,
         hot=HOT, fresh=FRESH, rotate_min_age=ROTATE_MIN_AGE,
         windows=BOUNDED_WINDOWS, windows_before=agg.stats["windows"])
    # One encoder across every window: absorption, the rotation, both
    # invalidations' compactions.
    enc = WindowEncoder(agg)

    timed = {}

    def run_window(d, win, whashes, w, record):
        """Feed the window as DRAINS drains, close it (a deferred
        invalidation while the close is in flight at INVALIDATE_DEFERRED);
        returns (counts, per-window host timings)."""
        keys = ("feed_dispatch", "feed_settle", "feed_miss", "compact",
                "sketch_absorb", "close_dispatch", "close_fetch",
                "close_unpack")
        t = dict.fromkeys(keys, 0.0)

        def take():
            for k in keys:
                t[k] += d.timings.pop(k, 0.0)

        for k in keys:  # a boundary's invalidation is not this window's
            d.timings.pop(k, None)
        bounds = np.linspace(0, len(win), DRAINS + 1).astype(int)
        t_win = time.perf_counter()
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            d.feed(win, whashes, lo=int(lo), hi=int(hi))
            take()
        t_close = time.perf_counter()
        h = d.close_dispatch()
        if w == INVALIDATE_DEFERRED and d.invalidate_pid(inv_later):
            raise AssertionError("invalidate_pid applied during a close")
        counts = d.close_collect(h, copy=True)
        if d.device.type == "cuda":
            torch.cuda.synchronize(d.device)
        t["close"] = time.perf_counter() - t_close
        t["window"] = time.perf_counter() - t_win
        take()
        if record is not None and h.acc is not None:
            record(h)
        return counts, {k: v * 1e3 for k, v in t.items()}

    impls = {"kernel": (close.close_pack, close.close_pack_delta),
             **(close_refs or {})}

    def record(h):
        """Time this window's close kernel on its own accumulator against
        the plain version, in turns with the reference builds (first full
        and first delta close)."""
        name = "close_pack_delta" if h.delta_blks else "close_pack"
        if name not in timed:
            timed[name] = handle_close(h, impls)

    # Every count to 0 just before the path; read just after.
    probe.reset_launches()
    close.reset_launches()
    twin_s, rows = 0.0, []
    for w in range(BOUNDED_WINDOWS):
        t0 = time.perf_counter()
        win, whashes = bounded_window(snap, hashes, w)
        build_s = time.perf_counter() - t0
        total = win.total_samples()
        before = {k: agg.stats.get(k, 0) for k in (
            "sketch_rows", "sketch_samples", "rotations", "delta_closes",
            "full_closes", "pid_invalidations")}
        counts, ms = run_window(agg, win, whashes, w, record)
        args = (win.time_ns + w, win.window_ns, win.period_ns)
        t0 = time.perf_counter()
        blobs = enc.encode(counts, *args)
        encoded = {"encode_ms": (time.perf_counter() - t0) * 1e3,
                   "registry_epoch": agg.registry_epoch,
                   "pids": len(blobs),
                   "bytes": sum(len(b) for _, b in blobs)}
        if w >= INVALIDATE_NOW:
            # After the rotation (window 6), then the immediate
            # invalidations and the deferred one: a fresh encoder's bytes.
            t0 = time.perf_counter()
            fresh_blobs = WindowEncoder(agg).encode(counts, *args)
            encoded["fresh_encode_ms"] = (time.perf_counter() - t0) * 1e3
            if sorted(fresh_blobs) != sorted(blobs):
                raise AssertionError(f"window {w}: the long-lived encoder "
                                     "!= a fresh one")
            del fresh_blobs
            # And build_pprof of every 64th pid.
            encoded.update(check_encoded(f"bounded window {w}", agg, win,
                                         counts, blobs))
        else:
            check_encoded(f"bounded window {w}", agg, win, counts, blobs,
                          every=0)
        del blobs
        t0 = time.perf_counter()
        counts_cpu, _ = run_window(twin, win, whashes, w, None)
        twin_s += time.perf_counter() - t0
        diff = {k: agg.stats.get(k, 0) - v for k, v in before.items()}
        absorbed = diff["sketch_samples"]
        if int(counts.sum()) + absorbed != total:
            raise AssertionError(f"window {w}: exact {int(counts.sum())} + "
                                 f"absorbed {absorbed} != {total}")
        fresh_h1 = whashes[0][HOT:]
        if diff["sketch_rows"]:
            if diff["sketch_rows"] != FRESH:
                raise AssertionError(f"window {w} absorbed "
                                     f"{diff['sketch_rows']} rows")
            est = agg.sketch_estimate(fresh_h1)
            if bool((est < win.counts[HOT:]).any()):
                raise AssertionError(f"window {w}: the sketch underestimates "
                                     "an absorbed row")
        if agg.stats.get("rotations", 0) and absorbed:
            raise AssertionError(f"window {w} absorbed after the rotation")
        # The CPU twin, from the same state through the same windows.
        if not np.array_equal(counts, counts_cpu) \
                or agg._next_id != twin._next_id \
                or agg._key_to_id != twin._key_to_id \
                or agg.sketch_info() != twin.sketch_info() \
                or not np.array_equal(agg._cm, twin._cm) \
                or not np.array_equal(agg._over_hll, twin._over_hll):
            raise AssertionError(f"window {w}: the card and the CPU differ")
        inv = None
        if w == INVALIDATE_NOW:
            reinsert = reinsert_turns(agg)
            t0 = time.perf_counter()
            for d in (agg, twin):
                if not all(d.invalidate_pid(p) for p in inv_now):
                    raise AssertionError("invalidate_pid at a boundary "
                                         "was deferred")
            inv_s = time.perf_counter() - t0
            inv = {"pids": len(inv_now), "s_both": inv_s,
                   "ms_per_call": inv_s / (2 * len(inv_now)) * 1e3,
                   "ids_after": agg._next_id, "reinsert": reinsert}
            if bool(np.isin(agg._id_pid[:agg._next_id], inv_now).any()) \
                    or any(p in agg._pids for p in inv_now):
                raise AssertionError("invalidated pids still hold ids")
            if agg._key_to_id != twin._key_to_id:
                raise AssertionError("invalidation: card and CPU differ")
        if w == INVALIDATE_NOW + 1 and not all(p in agg._pids
                                               for p in inv_now):
            raise AssertionError("invalidated pids did not re-register")
        if w == INVALIDATE_DEFERRED + 1 and (
                inv_later not in agg._pids
                or agg.stats.get("pid_invalidations") != N_INVALIDATE + 1):
            raise AssertionError("the deferred invalidation did not apply")
        form = "delta" if diff["delta_closes"] else "full"
        rows.append({
            "window": w, "rows": len(win), "samples": total,
            "exact": int(counts.sum()), "absorbed_samples": absorbed,
            "absorbed_rows": diff["sketch_rows"],
            "rotated": bool(diff["rotations"]), "ids": agg._next_id,
            "close_form": form,
            "fetch_bytes": agg.stats.get("fetch_bytes_last"),
            "build_s": build_s, "host_ms": ms, "invalidated": inv,
            "pprof": encoded,
        })
        emit("bounded_window", **rows[-1])
    launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                "close_pack": close.LAUNCHES["close_pack"],
                "close_pack_delta": close.LAUNCHES["close_pack_delta"]}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"phase 6 never launched {name}")
    st = agg.stats
    if not (st.get("rotations", 0) >= 1 and st.get("delta_closes", 0) >= 1
            and st.get("full_closes", 0) >= 1
            and st.get("pid_invalidations") == N_INVALIDATE + 1):
        raise AssertionError(f"phase 6 stats: {st}")
    if set(timed) != {"close_pack", "close_pack_delta"}:
        raise AssertionError(f"phase 6 timed only {sorted(timed)}")
    emit("bounded_path", launches=launches, cpu_twin_s=twin_s,
         sketch_info=agg.sketch_info(),
         stats={k: st.get(k) for k in (
             "windows", "rotations", "pid_invalidations",
             "invalidation_compactions", "sketch_rows", "sketch_samples",
             "delta_closes", "full_closes", "delta_retries",
             "delta_fallbacks", "close_retries", "inserts")},
         close_kernels=timed)
    source = "parca_agent_tpu_torch/csrc/close_pack.cu"
    return {name: {"name": name, "route": "cuda", "source": source,
                   "replaces": "parca_agent_tpu/aggregator/dict.py:" + line,
                   "max_abs_err": 0, "ms": timed[name]["ms"],
                   "plain_ms": timed[name]["plain_ms"],
                   "bound_ms": timed[name]["bound_ms"],
                   "bound_by": timed[name]["bound_by"], "library_ms": None}
            for name, line in (("close_pack", "170"),
                               ("close_pack_delta", "232"))}, launches


# -- phase 7 -----------------------------------------------------------------

# The streaming window with the cross-drain carry cache (the north star's
# --streaming-window), on the bench window: a cold window, then a steady
# window of the same rows plus STREAM_FRESH new stacks, 10 drains a
# window cut on pid boundaries (per-pid location registration is
# batch-local), closed through the feeder; the encode pipeline's worker
# writes the warm statics snapshot after the last window, and a restart
# adopts it and streams the last window's first RESTART_DRAINS drains
# again (whole pids: the adoption and the cold encoder's bytes are checked
# on them; the re-insert of the whole window was depth, cut for the time
# limit). Capacity 2^22: the window's 2^20 stacks plus the steady window's
# new ones exceed id_cap 2^20 of the default 2^21 table under overflow
# "raise".
STREAM_CAP = 1 << 22
STREAM_FRESH = 65_536
STREAM_WINDOWS = 2
RESTART_DRAINS = 2


class MappedObject:
    """An object file as the mapping table build reads it: its base."""

    __slots__ = ("_base",)

    def __init__(self, base: int):
        self._base = base

    def base(self) -> int:
        return self._base


class WindowMaps:
    """The mapping and object caches of a window's own MappingTable (the
    port has no /proc reader): each pid's rows as ProcMappings, the
    table's build ids by path, and each row's normalization base."""

    def __init__(self, table):
        from parca_agent_tpu_torch.process.maps import ProcMapping

        self._rows: dict = {}
        self._objs: dict = {}
        for pid, start, end, off, obj, base in zip(
                table.pids.tolist(), table.starts.tolist(),
                table.ends.tolist(), table.offsets.tolist(),
                table.objs.tolist(), table.bases.tolist()):
            m = ProcMapping(start, end, "r-xp", off, "08:01", 1 + obj,
                            table.obj_paths[obj])
            self._rows.setdefault(pid, []).append(m)
            self._objs[(pid, start)] = MappedObject(base)
        self._ids = dict(zip(table.obj_paths, table.obj_buildids))

    def executable_mappings(self, pid):
        if pid not in self._rows:
            raise OSError(f"pid {pid} has no mappings")
        return self._rows[pid]

    def build_ids(self, per_pid):
        return dict(self._ids)

    def get(self, pid, m):
        return self._objs[(pid, m.start)]


def stream_windows(snap):
    """The phase's windows: the bench window's rows (window 0), then the
    same rows plus STREAM_FRESH rows of the bench window with the leaf
    moved by 4 w bytes (new stacks, new locations); each ordered by pid,
    with its 10 drain bounds on pid boundaries. Returns [(window,
    bounds, fresh rows or None)]."""
    import dataclasses

    import numpy as np

    cols = ("pids", "tids", "counts", "user_len", "kernel_len", "stacks")
    out = []
    for w in range(STREAM_WINDOWS):
        fresh = None
        win = snap
        if w:
            fresh = window_rows(snap, np.arange((w - 1) * STREAM_FRESH,
                                                w * STREAM_FRESH), 4 * w)
            win = dataclasses.replace(snap, **{
                k: np.concatenate([getattr(snap, k), getattr(fresh, k)])
                for k in cols})
        order = np.argsort(win.pids, kind="stable")
        win = dataclasses.replace(win, **{k: getattr(win, k)[order]
                                          for k in cols})
        edges = np.flatnonzero(np.diff(win.pids)) + 1
        n = len(win)
        bounds = [0]
        for k in range(1, DRAINS):
            i = int(np.searchsorted(edges, k * n / DRAINS))
            e = int(edges[min(i, len(edges) - 1)])
            if e > bounds[-1]:
                bounds.append(e)
        bounds.append(n)
        out.append((win, bounds, fresh))
    return out


def phase_streaming(dev, snap, want) -> dict:
    """The streaming path on `dev`: DictAggregator(carry=True) fed by the
    StreamingWindowFeeder through the fast loop (CPUProfiler with the
    encode pipeline and a StaticsStore), STREAM_WINDOWS windows, then a
    restart that adopts the snapshot and streams the last window again.
    The runtime edges are the CLI's, at its defaults: the feeder's and
    the device watchdogs, the device-health and quarantine registries,
    the flight recorder and device telemetry; no window may hang, fail
    a feed, cool the feeder down or fall back to a re-aggregation.
    Every window's per-pid mass equals the numpy oracle's, every live
    pid has one blob, every 64th pid's blob parses to build_pprof's
    samples; the restart's bytes equal a cold encoder's for every pid.
    Returns the path's kernel launch counts and the first run's
    dictionary (capacity 2^22), warm with the bench window."""
    import dataclasses
    import tempfile

    import numpy as np

    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.pprof.statics_store import StaticsStore
    from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
    from parca_agent_tpu_torch.process.maps import build_mapping_table
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.profiler.streaming import (
        StreamingWindowFeeder,
    )
    from parca_agent_tpu_torch.runtime import device_telemetry as dtel
    from parca_agent_tpu_torch.runtime import trace as trace_mod
    from parca_agent_tpu_torch.runtime.device_health import (
        DeviceHealthRegistry,
    )
    from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry

    t0 = time.perf_counter()
    maps = WindowMaps(snap.mappings)
    pids = np.unique(snap.mappings.pids).tolist()
    per_pid = {p: maps.executable_mappings(p) for p in pids}
    rebuilt = build_mapping_table(per_pid, maps.build_ids(per_pid),
                                  objcache=maps)
    for k in ("pids", "starts", "ends", "offsets", "objs", "bases"):
        if not np.array_equal(getattr(rebuilt, k), getattr(snap.mappings, k)):
            raise AssertionError(f"the drains' mapping table differs in {k}")
    if rebuilt.obj_paths != snap.mappings.obj_paths \
            or rebuilt.obj_buildids != snap.mappings.obj_buildids:
        raise AssertionError("the drains' mapping table differs in objects")
    windows = stream_windows(snap)
    # The oracle: the numpy CPUAggregator's profiles of the bench rows
    # (phase 4's) and of each window's fresh rows (distinct stacks).
    base_mass = {p.pid: p.total() for p in want}
    base_vals = {p.pid: p.values.tolist() for p in want}
    oracles = []
    for _win, _bounds, fresh in windows:
        mass, extra = dict(base_mass), {}
        if fresh is not None:
            for p in CPUAggregator().aggregate(fresh):
                mass[p.pid] = mass.get(p.pid, 0) + p.total()
                extra[p.pid] = p.values.tolist()
        oracles.append((mass, extra))
    emit("streaming_setup", s=time.perf_counter() - t0,
         windows=STREAM_WINDOWS, rows=[len(w) for w, _, _ in windows],
         drains=[len(b) - 1 for _, b, _ in windows], fresh=STREAM_FRESH,
         capacity=STREAM_CAP, mapping_rows=len(rebuilt))

    class KeptAggregator(DictAggregator):
        """The dictionary, keeping a copy of the last drain's dispatched
        rows (what the carry left for K1) and the last close's handle, for
        the kernel checks at this path's shapes."""

        kept_packed = kept_handle = None

        def _feed_dispatch_async(self, packed, reset):
            self.kept_packed = packed.copy()
            return super()._feed_dispatch_async(packed, reset)

        def close_dispatch(self):
            self.kept_handle = super().close_dispatch()
            return self.kept_handle

    class KeptFeeder(StreamingWindowFeeder):
        """The feeder, keeping a copy of each streamed window's counts
        for the checks."""

        kept = None

        def take_window_if_complete(self, snapshot):
            counts = super().take_window_if_complete(snapshot)
            self.kept = None if counts is None else counts.copy()
            return counts

    class Source:
        """poll() tees the next window's drains to the feeder (as the
        sampler's drain tee does), then returns the window."""

        def __init__(self, feeder, agg, todo):
            self.feeder, self.agg, self.todo = feeder, agg, list(todo)
            self.miss_s = 0.0

        def poll(self):
            if not self.todo:
                return None
            win, bounds, _fresh = self.todo.pop(0)
            self.miss_s = 0.0
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                self.feeder.on_drain((
                    win.pids[lo:hi], win.tids[lo:hi], win.user_len[lo:hi],
                    win.kernel_len[lo:hi], win.stacks[lo:hi],
                    win.counts[lo:hi]))
                self.miss_s += self.agg.timings.pop("feed_miss", 0.0)
            return win

    class Writer:
        def __init__(self):
            self.blobs = []

        def write(self, labels, blob):
            self.blobs.append((int(labels["pid"]), bytes(blob)))

    def check(label, agg, win, counts, blobs, oracle, pprof=True):
        mass, extra = oracle
        return check_window(
            label, agg, win, counts, blobs, mass,
            lambda pid: base_vals.get(pid, []) + extra.get(pid, []), pprof)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_statics_")
    path = str(Path(tmp.name) / "statics.snap")
    rows_out = []

    def run(agg, feeder, prof, src, writer, w, record_list):
        """One window through the fast loop; its record and stats."""
        before = {k: agg.stats.get(k, 0) for k in (
            "coalesce_rows_out", "carry_hits", "carry_mass", "inserts")}
        k1 = probe.LAUNCHES["feed_accumulate"]
        b2 = close.LAUNCHES["close_pack"]
        b3 = close.LAUNCHES["close_pack_delta"]
        prebuilt = feeder.stats["statics_prebuilt"]
        prebuilds = prof.pipeline.stats["prebuilds"]
        enc = prof.encoder
        statics0 = enc.stats["statics_build_s_total"]
        built0 = enc.stats["statics_bytes_built"]
        writer.blobs = []
        t_win = time.perf_counter()
        if not prof.run_iteration():
            raise AssertionError("the source ended early")
        miss_s = src.miss_s + agg.timings.pop("feed_miss", 0.0)
        if not prof.pipeline.flush(600):
            raise AssertionError("the encode pipeline did not flush")
        window_s = time.perf_counter() - t_win
        rec = record_list[-1]
        if not rec.get("streamed"):
            raise AssertionError(f"window {w} did not stream: {rec}")
        d = {k: agg.stats.get(k, 0) - v for k, v in before.items()}
        return {
            "window": w, "rows_in": rec["rows"],
            "rows_dispatched": d["coalesce_rows_out"] - d["carry_hits"],
            "carry_hits": d["carry_hits"], "carry_mass": d["carry_mass"],
            "inserts": d["inserts"],
            "k1_launches": probe.LAUNCHES["feed_accumulate"] - k1,
            "b2_launches": close.LAUNCHES["close_pack"] - b2,
            "b3_launches": close.LAUNCHES["close_pack_delta"] - b3,
            "feeder_ms": {k: v * 1e3 for k, v in rec["feeder_s"].items()},
            "miss_settle_ms": miss_s * 1e3,
            "close_ms": rec["feeder_s"]["close"] * 1e3,
            "aggregate_ms": rec["aggregate_ms"],
            "handoff_ms": rec.get("handoff_ms"),
            "encode_ms": rec["encode_ms"],
            "statics_build_ms": (enc.stats["statics_build_s_total"]
                                 - statics0) * 1e3,
            "statics_bytes_built": enc.stats["statics_bytes_built"] - built0,
            "statics_prebuilt": feeder.stats["statics_prebuilt"] - prebuilt,
            "worker_prebuilds": prof.pipeline.stats["prebuilds"] - prebuilds,
            "window_s": window_s, "pprof_pids": len(writer.blobs),
            "pprof_bytes": sum(len(b) for _, b in writer.blobs),
        }

    # The CLI's runtime edges at its defaults (cli.py): the watchdogs'
    # timeouts are the constructors' own.
    health = DeviceHealthRegistry()
    quarantine = QuarantineRegistry()
    recorder = trace_mod.FlightRecorder()
    telemetry = dtel.DeviceTelemetry(device=dev)

    def stack():
        agg = KeptAggregator(capacity=STREAM_CAP, overflow="raise",
                             device=dev, carry=True)
        feeder = KeptFeeder(agg, maps, maps,
                            prebuild_period_ns=snap.period_ns,
                            quarantine=quarantine)
        return agg, feeder

    def profiler(src, agg, feeder, writer, store, records, every):
        return CPUProfiler(src, agg, profile_writer=writer,
                           statics_store=store, statics_snapshot_every=every,
                           streaming_feeder=feeder, on_window=records.append,
                           device_health=health, quarantine=quarantine,
                           trace_recorder=recorder)

    def runtime_clean(label, feeder, prof):
        """The watchdogs' counts of a run at the defaults: all zero."""
        got = {k: feeder.stats[k] for k in (
            "feed_errors", "feed_hangs", "cooldowns", "windows_fallback")}
        got["device_hangs"] = prof.watchdog.stats["hangs"]
        got["device_errors"] = prof.watchdog.stats["errors"]
        if any(got.values()) or health.state != "healthy":
            raise AssertionError(f"{label} at the default watchdogs: {got}, "
                                 f"device {health.snapshot()}")
        return {**got, "feed_timeout_s": feeder._timeout,
                "first_feed_timeout_s": feeder._first_timeout,
                "device_timeout_s": prof.watchdog.timeout_s}

    kernel_rows = {}
    close_impls = {"kernel": (close.close_pack, close.close_pack_delta)}
    # Every count to 0 just before the path; read just after.
    dtel.install(telemetry)
    probe.reset_launches()
    close.reset_launches()
    agg, feeder = stack()
    src = Source(feeder, agg, windows)
    writer, records = Writer(), []
    store = StaticsStore(path)
    prof = profiler(src, agg, feeder, writer, store, records, STREAM_WINDOWS)
    for w, (win, _bounds, _fresh) in enumerate(windows):
        row = run(agg, feeder, prof, src, writer, w, records)
        row.update(check(f"streaming window {w}", agg, win, feeder.kept,
                         writer.blobs, oracles[w]))
        if w and not row["carry_hits"]:
            raise AssertionError(f"streaming window {w} carried nothing")
        if row["k1_launches"] < 1 \
                or row["b2_launches"] + row["b3_launches"] < 1:
            raise AssertionError(f"streaming window {w} launched K1 "
                                 f"{row['k1_launches']}, B2 "
                                 f"{row['b2_launches']}, B3 "
                                 f"{row['b3_launches']} times")
        rows_out.append(row)
        emit("streaming_window", **row)
        # The path's kernels against their plain versions at its shapes:
        # the first full and the first delta close on the window's own
        # accumulator (intact until the next window but one), and K1 on
        # the dictionary's table at the first steady window's last drain,
        # the rows the carry left to dispatch.
        h = agg.kept_handle
        form = "close_pack_delta" if h and h.delta_blks else "close_pack"
        if h is not None and h.acc is not None and form not in kernel_rows:
            kernel_rows[form] = handle_close(h, close_impls)
            emit("streaming_close_kernel", window=w, kernel=form,
                 **kernel_rows[form])
        if w == 1:
            kernel_rows["feed_accumulate"] = drain_k1(
                dev, agg, host_table(agg), agg.kept_packed,
                "streaming_drain_k1")
    prof.close()
    fs, st = dict(feeder.stats), dict(agg.stats)
    if fs["windows_streamed"] != STREAM_WINDOWS or fs["windows_fallback"] \
            or st.get("carry_fallbacks", 0):
        raise AssertionError(f"streaming stats: {fs}, "
                             f"carry_fallbacks {st.get('carry_fallbacks')}")
    watchdogs = {"run": runtime_clean("streaming run", feeder, prof)}
    saved = dict(store.stats)
    if saved["snapshots_written"] != 1 or saved["snapshot_write_errors"]:
        raise AssertionError(f"statics snapshot: {saved}")
    emit("streaming_snapshot", **{k: saved[k] for k in (
        "snapshot_bytes", "snapshot_records", "records_dropped_cap",
        "snapshot_save_ms")}, file_bytes=Path(path).stat().st_size,
         pids=len(agg._pids), carry_entries=st.get("carry_entries"),
         footprint=agg.footprint_bytes())
    # The first run's encoder goes before the restart's; its dictionary,
    # warm with the bench window, is phase 12's.
    del prof, writer, records, src, feeder
    # The restart: a fresh dictionary and encoder adopt the snapshot, then
    # the last window's first RESTART_DRAINS drains stream again.
    agg2, feeder2 = stack()
    win, bounds, fresh = windows[-1]
    cut = bounds[RESTART_DRAINS]
    win = dataclasses.replace(win, **{k: getattr(win, k)[:cut] for k in (
        "pids", "tids", "counts", "user_len", "kernel_len", "stacks")})
    bounds = bounds[:RESTART_DRAINS + 1]
    restart_pids = set(np.unique(win.pids).tolist())
    mass, extra = oracles[-1]
    restart_oracle = ({p: m for p, m in mass.items() if p in restart_pids},
                      extra)
    src2 = Source(feeder2, agg2, [(win, bounds, fresh)])
    writer2, records2 = Writer(), []
    store2 = StaticsStore(path)
    prof2 = profiler(src2, agg2, feeder2, writer2, store2, records2, 1000)
    adopt = store2.adopt(agg2, prof2.encoder, snap.period_ns)
    if not adopt["adopted"] or adopt["corrupt"]:
        raise AssertionError(f"adoption: {adopt}")
    emit("streaming_adopt", adopt_ms=store2.stats["snapshot_adopt_ms"],
         **adopt, statics_adopted_pids=prof2.encoder.stats[
             "statics_adopted_pids"], registries=len(agg2._pids))
    row = run(agg2, feeder2, prof2, src2, writer2, STREAM_WINDOWS, records2)
    prof2.close()
    dtel.install(None)
    watchdogs["restart"] = runtime_clean("streaming restart", feeder2, prof2)
    # Its bytes are held to a cold encoder's below, for every pid.
    row.update(check("restarted window", agg2, win, feeder2.kept,
                     writer2.blobs, restart_oracle, pprof=False))
    t0 = time.perf_counter()
    cold = WindowEncoder(agg2).encode(feeder2.kept, win.time_ns,
                                      win.window_ns, win.period_ns)
    cold_ms = (time.perf_counter() - t0) * 1e3
    if sorted((p, bytes(b)) for p, b in cold) != sorted(writer2.blobs):
        raise AssertionError("the adopted encoder's bytes != a cold "
                             "encoder's")
    launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                "close_pack": close.LAUNCHES["close_pack"]}
    if close.LAUNCHES["close_pack_delta"]:
        launches["close_pack_delta"] = close.LAUNCHES["close_pack_delta"]
    emit("streaming_restart", **row, cold_encoder_ms=cold_ms,
         cold_window={k: rows_out[0][k] for k in (
             "miss_settle_ms", "encode_ms", "statics_build_ms",
             "statics_bytes_built", "aggregate_ms")},
         bytes_equal_cold_encoder=True)
    stages = recorder.percentiles()
    emit("streaming_runtime", watchdogs=watchdogs,
         trace_stats=dict(recorder.stats),
         stage_ms={k: {q: v[q] for q in ("p50_ms", "max_ms", "count")}
                   for k, v in stages.items()},
         telemetry_stats=telemetry.snapshot()["stats"],
         quarantine=quarantine.snapshot()["stats"])
    emit("streaming_path", launches=launches, feeder_stats=fs,
         carry={k: v for k, v in st.items() if k.startswith("carry_")},
         kernels={k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")}
                  for k, r in kernel_rows.items()})
    tmp.cleanup()
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"phase 7 never launched {name}")
        if name not in kernel_rows:
            raise AssertionError(f"phase 7 launched {name} but never held "
                                 "it against its plain version")
    return launches, agg


# -- phase 8 -----------------------------------------------------------------

# The sharded dictionary (--aggregator sharded) on the bench window: 8 home
# sub-tables of 2^18 slots (capacity 2^21) on the one card, as the JAX
# package's tests run 8 shards on 8 devices of one host; the 2^20 stacks
# fill each sub-table to about half and id_cap is 2^20. A cold window,
# then a steady window of 10 drains. Then a pid router that sends three
# pids of four to shard 0, at 1/8 of the window (SKEW_*), so that shard
# 0's sub-table overflows into the sketch while the table is half empty.
SHARDS = 8
SKEW_ROWS = 1 << 17
SKEW_PIDS = 6_250
SKEW_CAP = 1 << 18


def skewed_shard(pid: int) -> int:
    """Three pids of four to shard 0, the rest spread over the shards."""
    return 0 if pid % 4 else (pid // 4) % SHARDS


def recorded_sharded(**kw):
    """A ShardedDictAggregator that keeps each feed's lane count and live
    rows a shard, and its first and last packed buffers, taken from the
    buffer the dispatch was given after feed() returns (outside the timed
    dispatch)."""
    import numpy as np

    from parca_agent_tpu_torch.aggregator.sharded import ShardedDictAggregator

    class Recorded(ShardedDictAggregator):
        def _feed_dispatch_async(self, packed, reset):
            self.given = packed
            return super()._feed_dispatch_async(packed, reset)

        def feed(self, *a, **k):
            self.given = None
            super().feed(*a, **k)
            if self.given is None:
                return
            p = self.given
            live = p[3] > 0
            self.feeds.append((p.shape[1], np.bincount(
                p[1, live] % np.uint32(self._n_shards),
                minlength=self._n_shards).tolist()))
            self.last_packed = p.copy()
            if self.first_packed is None:
                self.first_packed = self.last_packed

    agg = Recorded(**kw)
    agg.feeds = []
    agg.first_packed = agg.last_packed = None
    return agg


def partition_packed(packed, n_shards: int):
    """The host partition of the two-stage B7-feed: packed's live rows by
    home shard (h2 % n_shards) into uint32 [n_shards, 5, n_pad_s], packed
    order kept within a shard, each row's packed position as channel 4,
    n_pad_s the largest shard's row count rounded up to a quarter power of
    two. Made here only for --b7-reference."""
    import numpy as np

    live = np.flatnonzero(packed[3] > 0)
    shard = (packed[1, live] % np.uint32(n_shards)).astype(np.int64)
    order = np.argsort(shard, kind="stable")
    rows, shard = live[order], shard[order]
    per = np.bincount(shard, minlength=n_shards)
    n_max = max(int(per.max(initial=0)), 1)
    step = 1 << max(2, n_max.bit_length() - 3)
    n_pad_s = 16 if n_max <= 16 else -(-n_max // step) * step
    out = np.zeros((n_shards, 5, n_pad_s), np.uint32)
    lane = np.arange(len(rows)) - (np.cumsum(per) - per)[shard]
    for c in range(4):
        out[shard, c, lane] = packed[c, rows]
    out[shard, 4, lane] = rows
    return out


def load_b7_reference(path: str):
    """The two-stage B7-feed of a reference build: its pa_sharded_feed
    (table, n_shards, cap_s, acc, id_cap, part [S, 5, n], n, found,
    stream) over a partition, then the torch miss compaction that
    followed it; returns step(table, acc, part) -> (n_miss, miss_rows).
    Launches are not counted."""
    import ctypes

    import torch

    from parca_agent_tpu_torch.ops import kernels

    lib = load_reference("sharded_feed", path)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pa_sharded_feed.argtypes = [ptr, i64, i64, ptr, i64, ptr, i64, ptr,
                                    ptr]
    lib.pa_sharded_feed.restype = ctypes.c_int

    def step(table, acc, part):
        n_shards, cap_s = table.shape[0], table.shape[1]
        n = part.shape[2]
        found = torch.empty((n_shards, n), dtype=torch.int32,
                            device=table.device)
        kernels.check_launch(lib, lib.pa_sharded_feed(
            table.data_ptr(), n_shards, cap_s, acc.data_ptr(), acc.shape[1],
            part.data_ptr(), n, found.data_ptr(),
            torch.cuda.current_stream(table.device).cuda_stream),
            "reference sharded_feed")
        miss = (part[:, 3] > 0) & (found < 0)
        tgt = torch.where(miss, torch.cumsum(miss, 1) - 1, n)
        out = torch.full((n_shards, n + 1), -1, dtype=torch.int32,
                         device=table.device)
        out.scatter_(1, tgt, part[:, 4])
        return miss.sum(1, dtype=torch.int32), out[:, :n]

    return step


def sharded_feed_kernel(dev, drain: str, table, host, id_cap: int, packed,
                        ref=None, profile: bool = False) -> dict:
    """B7-feed (sharded_feed_step) at one drain's packed buffer `packed`
    (uint32 [4, n_pad]) on `table` (the card's int32 [S, cap_s, 4]; `host`
    its uint32 copy) against sharded_feed_step_plain: the accumulator,
    each shard's miss count and miss-row prefix equal, and with `profile`
    the device kernels one feed enqueues (torch.profiler: the one kernel,
    nothing else). Then the kernel and the plain version timed, and the
    bound of
    this drain's data. With `ref` (--b7-reference), the two-stage design
    over a partition of the same buffer held to the same lists and timed
    in turns with the kernel, and the partition's host time. Launches made
    here are not counted."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import probe, sharded

    saved = dict(sharded.LAUNCHES)
    n_shards, cap_s = table.shape[0], table.shape[1]
    n = packed.shape[1]
    dpacked = torch.from_numpy(packed.view(np.int32)).to(dev)

    def acc0():
        return torch.zeros((n_shards, id_cap), dtype=torch.int32, device=dev)

    def prefixes(n_miss, rows):
        per = n_miss.cpu().tolist()
        return per, [rows[s, :k].cpu() for s, k in enumerate(per)]

    outs = []
    for fn in (sharded.sharded_feed_step, sharded.sharded_feed_step_plain):
        acc = acc0()
        n_miss, rows = fn(table, acc, dpacked, True)
        outs.append((acc, *prefixes(n_miss, rows)))
    torch.cuda.synchronize()
    (acc_k, per, lists), (acc_p, per_p, lists_p) = outs
    if not torch.equal(acc_k, acc_p) or per != per_p \
            or not all(torch.equal(a, b) for a, b in zip(lists, lists_p)):
        raise AssertionError(f"sharded_feed != plain at the {drain} drain")
    acc = acc0()
    row = {"drain": drain, "n_pad": n, "table": [n_shards, cap_s, 4],
           "id_cap": id_cap}
    if profile:
        names, sessions = device_kernels(
            lambda: sharded.sharded_feed_step(table, acc, dpacked, False))
        if len(names) != 1 or "sharded_feed" not in names[0]:
            raise AssertionError(f"a feed enqueued {names}, not the one "
                                 "kernel")
        row.update(device_kernels_per_feed=names, profiler_sessions=sessions)
    row["ms"] = time_ms(lambda: sharded.sharded_feed_step(
        table, acc, dpacked, False), 50)
    row["plain_ms"] = time_ms(lambda: sharded.sharded_feed_step_plain(
        table, acc, dpacked, False), 5)
    if ref is not None:
        t0 = time.perf_counter()
        part = partition_packed(packed, n_shards)
        row["reference_partition_ms"] = (time.perf_counter() - t0) * 1e3
        dpart = torch.from_numpy(part.view(np.int32)).to(dev)
        r_per, r_lists = prefixes(*ref(table, acc0(), dpart))
        if r_per != per or not all(torch.equal(a, b)
                                   for a, b in zip(lists, r_lists)):
            raise AssertionError("the reference B7-feed's miss lists differ")
        row["reference_shape"] = list(part.shape)
        row["ms_turns"] = time_turns({
            "sharded_feed": lambda: sharded.sharded_feed_step(
                table, acc, dpacked, False),
            "reference": lambda: ref(table, acc, dpart)}, 50)
    sharded.LAUNCHES.update(saved)
    # What this drain's data makes the kernel do, on the host copy.
    live = packed[3].view(np.int32) > 0
    home = packed[1] % np.uint32(n_shards)
    steps = slots = hits = 0
    ids = []
    for s in range(n_shards):
        mine = live & (home == s)
        st, sl, f = probe_work(host[s], *packed[:3][:, mine], probe.PROBES)
        steps, slots = steps + int(st.sum()), slots + sl
        f = f[f >= 0]
        hits += len(f)
        ids.append(s * id_cap + f[f < id_cap])
    uniq = len(np.unique(np.concatenate(ids)))
    rows, misses = int(live.sum()), sum(per)
    n_tiles = -(-n // sharded.FEED_TILE)
    # Each live row's 16 B of packed, each dead lane's count, each chain
    # slot once, each hit id's count read and written, each miss row
    # written, the status records written, n_miss.
    nbytes = (16 * rows + 4 * (n - rows) + 16 * slots + 8 * uniq
              + 4 * misses + 8 * n_tiles * n_shards + 4 * n_shards)
    b_ms, b_by = bound(nbytes, 6 * steps + 2 * hits)
    row.update({"rows": rows, "rows_per_shard": np.bincount(
        home[live], minlength=n_shards).tolist(), "hits": hits,
        "misses": misses, "misses_per_shard": per, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "equal": True})
    emit("sharded_feed_kernel", **row)
    return row


def sharded_close_kernel(dev, acc, n_over_buf: int) -> dict:
    """B7-close (close_pack_sharded) on the window's own accumulator
    (int32 [S, id_cap]) at widths 4, 8 and 16 against
    close_pack_sharded_plain, every word equal; each timed back to back,
    the plain version, and the bound (acc read once, the buffer written
    once). Beside it, in the same call, B2 (close_pack) on shard 0's row
    and the sharded kernel on that row alone (n_shards = 1): the shard
    loop's cost at one shard. Launches made here are not counted."""
    import torch

    from parca_agent_tpu_torch.aggregator import close

    saved = dict(close.LAUNCHES)
    n_shards, id_cap = acc.shape
    n_fetch = id_cap
    widths = {}
    for width in (4, 8, 16):
        got = close.close_pack_sharded(acc, n_fetch, width, n_over_buf)
        want = close.close_pack_sharded_plain(acc, n_fetch, width,
                                              n_over_buf)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"close_pack_sharded != plain at width "
                                 f"{width}")
        out_words = got.numel()
        b_ms, b_by = bound(4 * n_shards * id_cap + 4 * out_words,
                           4 * n_shards * id_cap)
        widths[width] = {
            "ms": time_ms(lambda w=width: close.close_pack_sharded(
                acc, n_fetch, w, n_over_buf), 50),
            "plain_ms": time_ms(lambda w=width: close.close_pack_sharded_plain(
                acc, n_fetch, w, n_over_buf), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "n_over": int(got[-2].item()), "out_words": out_words}
    one = acc[:1].contiguous()
    if not torch.equal(close.close_pack(one[0], n_fetch, 8, n_over_buf),
                       close.close_pack_sharded(one, n_fetch, 8,
                                                n_over_buf)):
        raise AssertionError("close_pack_sharded at one shard != B2")
    turns = time_turns({
        "close_pack": lambda: close.close_pack(one[0], n_fetch, 8,
                                               n_over_buf),
        "close_pack_sharded_1": lambda: close.close_pack_sharded(
            one, n_fetch, 8, n_over_buf)}, 50)
    close.LAUNCHES.update(saved)
    row = {"shape": [n_shards, id_cap], "n_fetch": n_fetch,
           "n_over_buf": n_over_buf, "widths": widths,
           "one_shard_ms_turns": turns, "equal": True}
    emit("sharded_close_kernel", **row)
    return row


def sharded_skew(dev) -> dict:
    """The skewed router at 1/8 of the bench window on a fresh aggregator
    (capacity 2^18, 8 sub-tables of 2^15): shard 0's sub-table fills and
    the rest of its keys go to the sketch while the other sub-tables stay
    nearly empty. Exact mass + sketch samples equals the window's; every
    key that stayed exact has the count of its rows; every absorbed key's
    count-min estimate is at least its count; every pid none of whose
    keys was absorbed has the oracle's mass, and every 64th of them its
    sorted stack counts. Then B7-feed at the window's drain on the table
    it left (three rows of four in shard 0, its absorbed keys missing past
    the probe bound)."""
    import numpy as np

    snap, want = window_setup(SKEW_ROWS, SKEW_PIDS, label="sharded_skew_setup")
    agg = recorded_sharded(capacity=SKEW_CAP, n_shards=SHARDS,
                           overflow="sketch", shard_of_pid=skewed_shard,
                           device=dev)
    t0 = time.perf_counter()
    hashes = agg.hash_rows(snap)
    hash_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = agg.window_counts(snap, hashes)
    window_ms = (time.perf_counter() - t0) * 1e3
    total = snap.total_samples()
    absorbed = agg.stats.get("sketch_samples", 0)
    free = agg._shard_free()
    if not absorbed or free[0] != 0 or free[1:].min() == 0:
        raise AssertionError(f"skew: absorbed {absorbed}, free {free}")
    if int(counts.sum()) + absorbed != total:
        raise AssertionError(f"skew: exact {int(counts.sum())} + absorbed "
                             f"{absorbed} != {total}")
    # The rows' keys and each key's mass.
    key = np.stack(hashes, axis=1).astype(np.uint32)
    uk, first, inv = np.unique(key.view(np.dtype((np.void, 12))).ravel(),
                               return_index=True, return_inverse=True)
    mass = np.bincount(inv, weights=snap.counts.astype(np.float64)).astype(
        np.int64)
    k2i = agg._key_to_id
    sid = np.array([k2i.get(tuple(map(int, key[r])), -1) for r in first])
    exact = sid >= 0
    if not np.array_equal(counts[sid[exact]], mass[exact]):
        raise AssertionError("skew: an exact key's count differs")
    if int(mass[~exact].sum()) != absorbed:
        raise AssertionError("skew: absorbed keys' mass != sketch samples")
    est = agg.sketch_estimate(key[first[~exact], 0])
    if (est < mass[~exact]).any():
        raise AssertionError("skew: the sketch underestimates a key")
    lost = set(snap.pids[first[~exact]].tolist())
    id_pid = agg._id_pid[:len(counts)].astype(np.int64)
    got = np.bincount(id_pid, weights=counts.astype(np.float64))
    whole = [p for p in want if p.pid not in lost]
    for p in whole:
        if int(got[p.pid]) != p.total():
            raise AssertionError(f"skew: pid {p.pid} mass")
    keep = np.isin(id_pid, [p.pid for p in whole[::64]]) & (counts > 0)
    by_pid = {p.pid: p for p in want}
    for p in agg._build_profiles(snap, np.where(keep, counts, 0)):
        if sorted(p.values.tolist()) != sorted(by_pid[p.pid].values.tolist()):
            raise AssertionError(f"skew: pid {p.pid} stack counts")
    row = {"rows": len(snap), "keys": len(uk), "exact_keys": int(exact.sum()),
           "absorbed_keys": int((~exact).sum()), "absorbed_samples": absorbed,
           "exact_samples": int(counts.sum()), "free_slots": free.tolist(),
           "pids_whole": len(whole), "pids_absorbed": len(lost),
           "hash_s": hash_s, "window_ms": window_ms,
           "miss_vec_fallbacks": agg.stats.get("miss_vec_fallbacks", 0),
           "timings_ms": {k: v * 1e3 for k, v in agg.timings.items()}}
    emit("sharded_skew", **row)
    sharded_feed_kernel(dev, "skew", agg._dev, host_table(agg).reshape(
        SHARDS, agg._cap_s, 4), agg._id_cap, agg.last_packed)
    return row


ADMISSION_PODS = 64


def admission_fs(pids, seed: int = 8):
    """A seeded fake filesystem putting `pids` in ADMISSION_PODS pod
    cgroups, the pods drawn with Zipf-skewed weights (so are their
    masses)."""
    import numpy as np

    from parca_agent_tpu_torch.utils.vfs import FakeFS

    upids = np.unique(np.asarray(pids, np.int64))
    weight = 1.0 / np.arange(1, ADMISSION_PODS + 1) ** 1.1
    pod = np.random.default_rng(seed).choice(
        ADMISSION_PODS, size=len(upids), p=weight / weight.sum())
    return FakeFS({
        f"/proc/{p}/cgroup":
        b"0::/kubepods/burstable/pod%08x-0000-1111-2222-%012d/c\n"
        % (0xC0DE0000 + k, k)
        for p, k in zip(upids.tolist(), pod.tolist())})


def sharded_admission(dev, snap, want) -> tuple:
    """Admission on the sharded path (module docs): the skew drain's pids
    (2^17 rows, 6,250 pids) in 64 pod cgroups of Zipf-skewed mass, an
    AdmissionController's shard_of installed with set_shard_router on a
    fresh ShardedDictAggregator (capacity 2^21, 8 shards), fed in DRAINS
    drains and closed, its launches counted from 0. Every row must sit in
    its tenant's home shard, the close's mass and every pid's be the
    oracle's; at a quota of the median tenant's mass, the tenants over
    it (and only they) go on the ladder, and an overloaded window sheds
    the heaviest tenants first. Prints route_h2's ms a drain and the rows
    a shard. Returns the launches."""
    import numpy as np

    from parca_agent_tpu_torch.aggregator import close, sharded
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.runtime.admission import (
        AdmissionController,
        OverloadPolicy,
        TenantResolver,
    )
    from parca_agent_tpu_torch.runtime.quarantine import LEVEL_FULL

    resolver = TenantResolver(fs=admission_fs(snap.pids))
    # The tenants' masses, and a quota at the median tenant's.
    upids, inv = np.unique(snap.pids.astype(np.int64), return_inverse=True)
    pid_mass = np.bincount(inv, weights=snap.counts.astype(np.float64))
    tenant_mass: dict = {}
    for p, m in zip(upids.tolist(), pid_mass.tolist()):
        t = resolver.resolve(p)
        tenant_mass[t] = tenant_mass.get(t, 0) + int(m)
    quota = int(np.median(list(tenant_mass.values())))
    adm = AdmissionController(
        resolver, quota_samples=quota, burst_windows=1, degrade_after=1,
        escalate_after=2, overload=OverloadPolicy(
            close_latency_s=1.0, shed_after=1, recover_after=2),
        window_s=10.0)
    agg = recorded_sharded(capacity=CAP, n_shards=SHARDS, overflow="sketch",
                           device=dev)
    agg.set_shard_router(lambda pid: adm.shard_of(pid, agg._n_shards))
    raw = DictAggregator.hash_rows(agg, snap)   # the unrouted triple
    t0 = time.perf_counter()
    hashes = agg.hash_rows(snap)
    hash_route_ms = (time.perf_counter() - t0) * 1e3
    bounds = np.linspace(0, len(snap), DRAINS + 1).astype(int)
    route_ms = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        t0 = time.perf_counter()
        routed = sharded.route_h2(raw[1][lo:hi], snap.pids[lo:hi],
                                  agg._shard_of_pid, SHARDS)
        route_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(routed, hashes[1][lo:hi]):
            raise AssertionError("admission: route_h2 a drain != the "
                                 "window's routing")
    home = {p: adm.shard_of(p, SHARDS) for p in upids.tolist()}
    row_home = np.array([home[p] for p in upids.tolist()])[inv]
    if not np.array_equal(hashes[1] % SHARDS, row_home):
        raise AssertionError("admission: a row is not in its tenant's home "
                             "shard")
    # Every count to 0 just before the path; read just after its close.
    sharded.reset_launches()
    close.reset_launches()
    t0 = time.perf_counter()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        agg.feed(snap, hashes, lo=int(lo), hi=int(hi))
    counts = agg.close_window(copy=True)
    window_ms = (time.perf_counter() - t0) * 1e3
    launches = {"sharded_feed": sharded.LAUNCHES["sharded_feed"],
                "close_pack_sharded": close.LAUNCHES["close_pack_sharded"]}
    if launches["sharded_feed"] != DRAINS \
            or launches["close_pack_sharded"] < 1:
        raise AssertionError(f"admission window launches {launches}")
    want_by_pid = {p.pid: p for p in want}
    check_counts("admission window", agg, snap, counts,
                 {p.pid: p.total() for p in want},
                 lambda pid: want_by_pid[pid].values.tolist())
    ids = np.flatnonzero(counts)
    id_home = np.array([home[int(p)] for p in agg._id_pid[ids]])
    if not np.array_equal(agg.id_hashes()[1][ids] % SHARDS, id_home):
        raise AssertionError("admission: a key is not in its tenant's home "
                             "shard")
    # The quota arithmetic: one window accounted and ticked.
    adm.account_window(snap.pids, snap.counts)
    adm.tick_window(close_latency_s=0.0)
    over = {t for t, m in tenant_mass.items() if m > quota}
    laddered = {t for t, st in adm._tenants.items() if st.level > LEVEL_FULL}
    if laddered != over or not over:
        raise AssertionError(f"admission: {len(laddered)} tenants on the "
                             f"ladder, {len(over)} over the quota")
    # An overloaded window: the governor sheds the heaviest first.
    adm.account_window(snap.pids, snap.counts)
    adm.tick_window(close_latency_s=5.0)
    shed = {t for t, st in adm._tenants.items() if st.shed_level > 0}
    lighter = [m for t, m in tenant_mass.items() if t not in shed]
    if not shed or min(tenant_mass[t] for t in shed) < max(lighter,
                                                           default=0):
        raise AssertionError(f"admission: the shed {sorted(shed)} are not "
                             "the heaviest tenants")
    row = {"rows": len(snap), "pids": len(upids),
           "tenants": len(tenant_mass), "quota_samples": quota,
           "over_quota": len(over), "shed": len(shed),
           "heaviest_tenant_share": max(tenant_mass.values())
           / snap.total_samples(),
           "hash_and_route_ms": hash_route_ms, "route_h2_ms": route_ms,
           "rows_per_shard": np.bincount(hashes[1] % SHARDS,
                                         minlength=SHARDS).tolist(),
           "window_ms": window_ms, "launches": launches,
           "admission_stats": dict(adm.stats),
           "resolver": dict(resolver.stats)}
    emit("sharded_admission", **row)
    return launches


def admission_route_cost(snap, h2) -> None:
    """route_h2 with admission's shard_of on the bench window's 10
    drains (50,000 pids; `h2` its rows' second hash): each drain's ms
    with the resolver's cache cold and warm."""
    import numpy as np

    from parca_agent_tpu_torch.aggregator import sharded
    from parca_agent_tpu_torch.runtime.admission import (
        AdmissionController,
        TenantResolver,
    )

    adm = AdmissionController(TenantResolver(fs=admission_fs(snap.pids)),
                              quota_samples=1)
    bounds = np.linspace(0, len(snap), DRAINS + 1).astype(int)
    out = {}
    for label in ("cold", "warm"):
        ms, n = [], []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            t0 = time.perf_counter()
            sharded.route_h2(h2[lo:hi], snap.pids[lo:hi],
                             lambda pid: adm.shard_of(pid, SHARDS), SHARDS)
            ms.append((time.perf_counter() - t0) * 1e3)
            n.append(int(len(np.unique(snap.pids[lo:hi]))))
        out[label] = {"ms": ms, "ms_sum": sum(ms), "pids_a_drain": n}
    emit("sharded_admission_route_cost", rows=len(snap),
         pids=int(len(np.unique(snap.pids))), **out)


def sharded_cli() -> None:
    """The CLI entry on the card, --aggregator sharded --fast-encode (one
    shard on one card), 3 synthetic windows in this process: every window
    whole (mass equal to its samples), every stored profile parses, and
    the store holds the windows' mass."""
    import contextlib
    import io
    import tempfile

    from parca_agent_tpu_torch import cli
    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.run([*NO_PROBE, *HTTP_ANY, "--aggregator", "sharded",
                          "--fast-encode", "--windows", str(CLI_WINDOWS),
                          "--profiling-duration", "0.5",
                          "--local-store-directory", tmp])
        cli_s = time.perf_counter() - t0
        files = sorted(Path(tmp).glob("*.pb.gz"))
        mass = sum(v[0] for f in files
                   for _, v, _ in parse_pprof(f.read_bytes()).samples)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    cli_runtime_clean("CLI --aggregator sharded",
                      [ln["runtime"] for ln in lines if "runtime" in ln])
    lines = [ln for ln in lines if "window" in ln]
    if rc != 0 or len(lines) != CLI_WINDOWS \
            or any(ln["mass"] != ln["samples"] for ln in lines) \
            or len(files) != sum(ln["profiles"] for ln in lines) \
            or mass != sum(ln["samples"] for ln in lines):
        raise AssertionError(f"CLI --aggregator sharded: rc {rc}, {lines}, "
                             f"{len(files)} profiles of mass {mass}")
    emit("sharded_cli", rc=rc, s=cli_s, windows=lines,
         profiles_written=len(files), mass=mass)


def phase_sharded(dev, snap, want, hashes, b7_ref=None) -> tuple:
    """The sharded dictionary's path on `dev` over `snap` (its identity
    triple `hashes`: no router, so the dictionary's own): a cold window
    and a steady window of DRAINS feeds, each checked against the numpy
    oracle, each feed exactly one B7-feed launch; its kernels against
    their plain versions at its shapes; the skewed router; the CLI.
    Returns the kernel rows and the launches counted over the two
    windows."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close, sharded

    def sync():
        torch.cuda.synchronize(dev)

    agg = recorded_sharded(capacity=CAP, n_shards=SHARDS, overflow="sketch",
                           device=dev)
    want_mass = {p.pid: p.total() for p in want}
    want_by_pid = {p.pid: p for p in want}

    def want_values(pid):
        return want_by_pid[pid].values.tolist()

    # Every count to 0 just before the path; read just after its windows.
    sharded.reset_launches()
    close.reset_launches()
    per_feed = []
    t0 = time.perf_counter()
    counts = agg.window_counts(snap, hashes)
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    per_feed.append(sharded.LAUNCHES["sharded_feed"])
    check_counts("sharded cold window", agg, snap, counts, want_mass,
                 want_values)
    n_pad, per_shard = agg.feeds[-1]
    emit("sharded_cold_window", ms=cold_ms, inserts=agg.stats["inserts"],
         n_pad=n_pad, rows_per_shard=per_shard,
         shard_load=(1 - agg._shard_free() / agg._cap_s).tolist(),
         timings_ms={k: v * 1e3 for k, v in agg.timings.items()})

    bounds = np.linspace(0, len(snap), DRAINS + 1).astype(int)
    drains = []
    t_win = time.perf_counter()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        before = sharded.LAUNCHES["sharded_feed"]
        agg.timings.pop("feed_settle", None)
        agg.feed(snap, hashes, lo=int(lo), hi=int(hi))
        per_feed.append(sharded.LAUNCHES["sharded_feed"] - before)
        t = agg.timings
        n_pad, per_shard = agg.feeds[-1]
        drains.append({"h2d_ms": t["feed_h2d"] * 1e3,
                       "dispatch_ms": t["feed_dispatch"] * 1e3,
                       "prev_settle_ms": t.get("feed_settle", 0.0) * 1e3,
                       "n_pad": n_pad, "rows_per_shard": per_shard})
    t_close = time.perf_counter()
    counts = agg.close_window(copy=True)
    close_ms = (time.perf_counter() - t_close) * 1e3
    window_ms = (time.perf_counter() - t_win) * 1e3
    check_counts("sharded steady window", agg, snap, counts, want_mass,
                 want_values)
    launches = {"sharded_feed": sharded.LAUNCHES["sharded_feed"],
                "close_pack_sharded": close.LAUNCHES["close_pack_sharded"]}
    emit("sharded_steady_window", window_ms=window_ms, close_ms=close_ms,
         last_settle_ms=agg.timings.get("feed_settle", 0.0) * 1e3,
         close_timings_ms={k: agg.timings[k] * 1e3 for k in (
             "close_dispatch", "close_fetch", "close_unpack")
             if k in agg.timings},
         drains=drains, inserts=agg.stats["inserts"],
         samples_per_s=snap.total_samples() / (window_ms / 1e3),
         launches=launches, launches_per_feed=per_feed)
    if per_feed != [1] * (DRAINS + 1) or launches["close_pack_sharded"] < 2:
        raise AssertionError(f"sharded path launches {launches}, per feed "
                             f"{per_feed}")
    host = host_table(agg).reshape(SHARDS, agg._cap_s, 4)
    feed = sharded_feed_kernel(dev, "steady", agg._dev, host, agg._id_cap,
                               agg.last_packed, b7_ref, profile=True)
    # The cold window's feed met an empty table: nearly every row misses.
    sharded_feed_kernel(dev, "cold", torch.zeros_like(agg._dev),
                        np.zeros_like(host), agg._id_cap, agg.first_packed)
    # The closed window's accumulator (the flip put it in the spare).
    closed = sharded_close_kernel(dev, agg._acc_spare, 4096)
    sharded_skew(dev)
    skew_snap, skew_want = window_setup(SKEW_ROWS, SKEW_PIDS,
                                        label="sharded_admission_setup")
    launches_admission = sharded_admission(dev, skew_snap, skew_want)
    del skew_snap, skew_want
    admission_route_cost(snap, hashes[1])
    sharded_cli()
    w8 = closed["widths"][8]
    source = "parca_agent_tpu_torch/csrc/"
    return {
        "sharded_feed": {
            "name": "sharded_feed", "route": "cuda",
            "source": source + "sharded_feed.cu",
            "replaces": "parca_agent_tpu/aggregator/sharded.py:74",
            "max_abs_err": 0, "ms": feed["ms"], "plain_ms": feed["plain_ms"],
            "bound_ms": feed["bound_ms"], "bound_by": feed["bound_by"],
            "library_ms": None},
        "close_pack_sharded": {
            "name": "close_pack_sharded", "route": "cuda",
            "source": source + "close_pack.cu",
            "replaces": "parca_agent_tpu/aggregator/sharded.py:137",
            "max_abs_err": 0, "ms": w8["ms"], "plain_ms": w8["plain_ms"],
            "bound_ms": w8["bound_ms"], "bound_by": w8["bound_by"],
            "library_ms": None}}, launches, launches_admission


# -- phase 9 -----------------------------------------------------------------


FLEET_NODES = 8
FLEET_FRESH = 65_536          # node-private new stacks a node
FLEET_DIST_ROWS = 1 << 18     # node 0's rows through NCCL: a smaller node,
                              # below CLUSTER_MIN_ROWS (B6's global kernel)
FLEET_LOW_SHARED = 8          # a low-overlap fleet: 1/8 of a node's stacks
                              # are held by every node
B8_SWEEP_BITS = (10, 11, 12, 13)
FLEET_PROFILE_ROWS = 1 << 17  # rows a node in the profiles' merge
FLEET_SHARED = 16_384         # of them, rows every node holds


def fleet_stream(snap, hashes):
    """The 8-node stream at a node's full width, the bench window: node
    k's row is the window's 2^20 rows (phase 4's h1, h2) with counts
    drawn from 1-9 (seed 9 + k), then FLEET_FRESH node-private new stacks
    (rows k * FLEET_FRESH.. of the window, the leaf moved by 4 (k + 1)
    bytes, as phase 6's fresh rows), hashed here. Returns (h1, h2,
    counts) uint32/int32 [8, 1,114,112]."""
    import numpy as np

    from parca_agent_tpu_torch.ops.hashing import row_hash_np

    n = len(snap)
    r = n + FLEET_FRESH
    h1 = np.empty((FLEET_NODES, r), np.uint32)
    h2 = np.empty((FLEET_NODES, r), np.uint32)
    c = np.empty((FLEET_NODES, r), np.int32)
    for k in range(FLEET_NODES):
        fresh = window_rows(snap, np.arange(k * FLEET_FRESH,
                                            (k + 1) * FLEET_FRESH),
                            4 * (k + 1))
        f1, f2 = row_hash_np(fresh.stacks, fresh.pids, fresh.user_len,
                             fresh.kernel_len, n_hashes=2)
        h1[k, :n], h1[k, n:] = hashes[0], f1
        h2[k, :n], h2[k, n:] = hashes[1], f2
        c[k] = np.random.default_rng(9 + k).integers(1, 10, r)
    return h1, h2, c


def exact_oracle(h1, h2, c):
    """numpy's exact merge: np.unique of the 64-bit keys (or of h1 alone
    when h2 is None), then np.add.at of the counts; (h1, h2, sums)."""
    import numpy as np

    key = h1.ravel().astype(np.uint64)
    if h2 is not None:
        key = (key << np.uint64(32)) | h2.ravel().astype(np.uint64)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv.ravel(), c.ravel().astype(np.int64))
    if h2 is None:
        return uniq.astype(np.uint32), None, sums
    return ((uniq >> np.uint64(32)).astype(np.uint32),
            uniq.astype(np.uint32), sums)


def load_fleet_reference(path: str):
    """PR 11's exact merge of a reference build of csrc/fleet_merge.cu
    (its C interface: pa_fleet_segment over rows sorted by key): returns
    route(keys, counts) -> (reps_hi, reps_lo, sums, n_groups), torch.sort
    of the rows and the counts' gather, then its segment kernel, as
    parallel/fleet.py ran them. Launches are not counted."""
    import ctypes

    import torch

    from parca_agent_tpu_torch.ops import kernels

    lib = load_reference("fleet_merge", path)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pa_fleet_segment_scratch_words.argtypes = [i64]
    lib.pa_fleet_segment_scratch_words.restype = i64
    lib.pa_fleet_segment.argtypes = [ptr, ptr, i64] + [ptr] * 6
    lib.pa_fleet_segment.restype = ctypes.c_int
    scratch = {}

    def route(keys, counts):
        dev = keys.device
        n = keys.numel()
        ks, order = torch.sort(keys)
        cs = counts[order]
        words = lib.pa_fleet_segment_scratch_words(n)
        if scratch.get("buf") is None or scratch["buf"].numel() < words:
            scratch["buf"] = torch.zeros(words, dtype=torch.int64, device=dev)
        hi, lo, sums, ng = (torch.empty(m, dtype=torch.int32, device=dev)
                            for m in (n, n, n, 1))
        kernels.check_launch(lib, lib.pa_fleet_segment(
            ks.data_ptr(), cs.data_ptr(), n, scratch["buf"].data_ptr(),
            hi.data_ptr(), lo.data_ptr(), sums.data_ptr(), ng.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream),
            "reference fleet_segment")
        return hi, lo, sums, ng

    return route


def group_by_bits(keys, ct, reps: int) -> dict:
    """fleet_group_launch's first level and reduce at each of
    B8_SWEEP_BITS bucket bits: {bits: {"ms", "overflowed"}} (a time with
    leaves that overflowed leaves the split's work out)."""
    from parca_agent_tpu_torch.parallel import fleet

    out = {}
    for b in B8_SWEEP_BITS:
        g = fleet.fleet_group_launch(keys, ct, True, bits=b)
        out[b] = {"overflowed": int(g.info[1].item()),
                  "ms": time_ms(lambda: fleet.fleet_group_launch(
                      keys, ct, True, bits=b), reps)}
    return out


def b8_traffic_streams(shape, seed: int = 12) -> dict:
    """Two fleets of `shape` [n_nodes, R] whose nodes share few stacks,
    as nodes running different services do: "unique", every row its own
    64-bit key (no stack on two nodes), and "low_overlap", each node's
    rows distinct, the first R / FLEET_LOW_SHARED of them stacks every
    node holds and the rest its own. Counts 1-9. name -> (h1, h2, c)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, shape, dtype=np.uint64)
    c = rng.integers(1, 10, shape).astype(np.int32)
    low = keys.copy()
    low[:, :shape[1] // FLEET_LOW_SHARED] = keys[0, :shape[1]
                                                 // FLEET_LOW_SHARED]
    return {name: ((k >> np.uint64(32)).astype(np.uint32),
                   k.astype(np.uint32), c)
            for name, k in (("unique", keys), ("low_overlap", low))}


def b8_traffic(dev, streams: dict, reps: int = 20, ref=None) -> dict:
    """B8 on fleets that share few stacks (b8_traffic_streams): per
    stream, fleet_group held against its plain version and numpy's exact
    merge, `overflowed` (the first level's leaves that did not fit),
    `ms` (the first level and its reduce, queued back to back), `call_ms`
    (fleet_group with its sync, the split included), `split_launches`,
    the sweep of the first level's bits (group_by_bits), and with `ref`
    (--fleet-reference) PR 11's route held against it and timed in turns
    with it (the first level's launches against the route, queued, when
    nothing overflowed). Its launches are restored."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.parallel import fleet

    saved = dict(fleet.LAUNCHES)
    out = {}
    for name, (h1, h2, c) in streams.items():
        h1t, h2t = (torch.from_numpy(x.view(np.int32)).to(dev)
                    for x in (h1, h2))
        ct = torch.from_numpy(c).to(dev).reshape(-1)
        keys = fleet.keys64(h1t, h2t)
        before = fleet.LAUNCHES["fleet_group_split"]
        got = fleet.fleet_group(keys, ct, True)
        split = fleet.LAUNCHES["fleet_group_split"] - before
        k = int(got[3].item())
        plain = fleet.fleet_group_plain(keys, ct, True)
        o1, o2, osum = exact_oracle(h1, h2, c)
        if not (k == int(plain[3].item()) == len(o1)
                and all(torch.equal(g[:k], p_[:k])
                        for g, p_ in zip(got[:3], plain[:3]))
                and np.array_equal(got[1][:k].cpu().numpy().view(np.uint32),
                                   o2)
                and np.array_equal(got[2][:k].cpu().numpy(), osum)):
            raise AssertionError(f"B8 ({name}): fleet_group differs from "
                                 "its plain version or numpy's exact merge")
        n = keys.numel()
        row = {"rows": n, "n_groups": k, "bits": fleet.group_bits(n),
               "overflowed": int(fleet.fleet_group_launch(
                   keys, ct, True).info[1].item()),
               "split_launches": split,
               "ms": time_ms(lambda: fleet.fleet_group_launch(keys, ct, True),
                             reps),
               "call_ms": time_ms(lambda: fleet.fleet_group(keys, ct, True),
                                  reps, flush=lambda: None),
               "by_bits": group_by_bits(keys, ct, reps)}
        if ref is not None:
            r = ref(keys, ct)
            if not (int(r[3].item()) == k
                    and all(torch.equal(a[:k], b[:k])
                            for a, b in zip(r[:3], got[:3]))):
                raise AssertionError(f"B8 ({name}): the reference route "
                                     "differs")
            # Queued back to back when the first level is the whole
            # route; else each call (with its sync) between its own events.
            fits = row["overflowed"] == 0
            row["turns_ms"] = time_turns(
                {"fleet_group": (lambda: fleet.fleet_group_launch(
                    keys, ct, True)) if fits
                    else lambda: fleet.fleet_group(keys, ct, True),
                 "reference": lambda: ref(keys, ct)}, reps,
                None if fits else lambda: None)
        row["bytes"] = 12 * n + 12 * k
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], 2 * n)
        out[name] = row
    fleet.LAUNCHES.update(saved)
    return out


def b8_case(dev, h1, h2, c, reps: int = 20, ref=None, oracle=None) -> dict:
    """B8, the exact merge's grouping (csrc/fleet_merge.cu, replacing
    parca_agent_tpu/parallel/fleet.py _exact_program64) at the stream,
    from its unsorted rows (keys64, the counts): fleet_group's [:n_groups]
    (reps, sums, n_groups) equal to its plain version's (torch.sort, then
    the segment ops) and to numpy's exact merge; `ms` is the partition
    and the reduce (fleet_group_launch, three launches, queued back to
    back), `kernel_us` each of them (torch.profiler), `call_ms`
    fleet_group with its one host sync (each call between its own events);
    `overflowed` the first level's leaves that did not
    fit (0 on these hash keys), `by_bits` the sweep of the first level's
    bucket bits (group_by_bits); the library yardstick,
    torch.unique(keys, return_inverse=True) then index_add_ (two calls,
    the sort included); the bound: 12 B a row read, 12 B a group written.
    With `ref` (--fleet-reference), PR 11's route (torch.sort, the
    counts' gather and its segment kernel) held against it and timed in
    turns with it. `oracle`: exact_oracle(h1, h2, c) when the caller has
    it. Its launches are restored."""
    import numpy as np
    import torch

    from parca_agent_tpu_torch.parallel import fleet

    saved = dict(fleet.LAUNCHES)
    h1t, h2t = (torch.from_numpy(x.view(np.int32)).to(dev) for x in (h1, h2))
    ct = torch.from_numpy(c).to(dev).reshape(-1)
    keys = fleet.keys64(h1t, h2t)
    hi, lo, sums, ng = fleet.fleet_group(keys, ct, True)
    k = int(ng.item())
    plain = fleet.fleet_group_plain(keys, ct, True)
    if int(plain[3].item()) != k:
        raise AssertionError(f"B8: n_groups {k} != the plain version's "
                             f"{int(plain[3].item())}")
    for name, g, p_ in (("reps_hi", hi, plain[0]), ("reps_lo", lo, plain[1]),
                        ("sums", sums, plain[2])):
        if not torch.equal(g[:k], p_[:k]):
            raise AssertionError(f"B8: the kernels' {name} differ from the "
                                 "plain version's")
    o1, o2, osum = oracle or exact_oracle(h1, h2, c)
    if not (k == len(o1)
            and np.array_equal(hi[:k].cpu().numpy().view(np.uint32), o1)
            and np.array_equal(lo[:k].cpu().numpy().view(np.uint32), o2)
            and np.array_equal(sums[:k].cpu().numpy(), osum)):
        raise AssertionError("B8: fleet_group differs from numpy's exact "
                             "merge")

    def library():
        u, inv = torch.unique(keys, return_inverse=True)
        return torch.zeros(len(u), dtype=torch.int32,
                           device=dev).index_add_(0, inv, ct)

    if not np.array_equal(library().cpu().numpy(), osum):
        raise AssertionError("B8: the library yardstick differs")
    launch = fleet.fleet_group_launch(keys, ct, True)
    n = keys.numel()
    out = {"rows": n, "n_groups": k, "bits": fleet.group_bits(n),
           "overflowed": int(launch.info[1].item()),
           "ms": time_ms(lambda: fleet.fleet_group_launch(keys, ct, True),
                         reps),
           "kernel_us": kernel_us(
               lambda: fleet.fleet_group_launch(keys, ct, True)),
           "call_ms": time_ms(lambda: fleet.fleet_group(keys, ct, True),
                              reps, flush=lambda: None),
           "plain_ms": time_ms(lambda: fleet.fleet_group_plain(
               keys, ct, True), 3),
           "library_ms": time_ms(library, 5),
           "library_calls": "torch.unique(keys, return_inverse=True) + "
                            "index_add_ (two calls, the sort included)",
           "by_bits": group_by_bits(keys, ct, reps)}
    if ref is not None:
        r_hi, r_lo, r_sums, r_ng = ref(keys, ct)
        if not (int(r_ng.item()) == k and torch.equal(r_hi[:k], hi[:k])
                and torch.equal(r_lo[:k], lo[:k])
                and torch.equal(r_sums[:k], sums[:k])):
            raise AssertionError("B8: the reference route differs")
        out["turns_ms"] = time_turns(
            {"fleet_group": lambda: fleet.fleet_group_launch(keys, ct, True),
             "reference": lambda: ref(keys, ct)}, reps)
    out["bytes"] = 12 * n + 12 * k
    out["bound_ms"], out["bound_by"] = bound(out["bytes"], 2 * n)
    fleet.LAUNCHES.update(saved)
    return out


def pid_window(snap, rows):
    """The snapshot's rows `rows` with the mapping table's rows of their
    pids (a pid's profile needs only its own rows and mappings)."""
    import dataclasses

    import numpy as np

    from parca_agent_tpu_torch.capture.formats import MappingTable

    w = window_rows(snap, rows)
    mt = snap.mappings
    sel = np.isin(mt.pids, np.unique(w.pids))
    return dataclasses.replace(w, mappings=MappingTable(
        pids=mt.pids[sel], starts=mt.starts[sel], ends=mt.ends[sel],
        offsets=mt.offsets[sel], objs=mt.objs[sel], obj_paths=mt.obj_paths,
        obj_buildids=mt.obj_buildids, bases=mt.bases[sel]))


def fleet_node_windows(snap):
    """8 node windows of FLEET_PROFILE_ROWS rows of the bench window:
    FLEET_SHARED rows every node holds (seed 11), and node k's own rows,
    those of the pids p with p % 8 == k; each node's mapping table is the
    window's rows of its pids."""
    import numpy as np

    n = len(snap)
    shared = np.sort(np.random.default_rng(11).choice(n, FLEET_SHARED,
                                                      replace=False))
    is_shared = np.zeros(n, bool)
    is_shared[shared] = True
    windows = []
    for k in range(FLEET_NODES):
        own = np.flatnonzero((snap.pids % FLEET_NODES == k) & ~is_shared)
        windows.append(pid_window(snap, np.concatenate(
            [own[:FLEET_PROFILE_ROWS - FLEET_SHARED], shared])))
    return windows


def fleet_dist(dev, h1, h2, c) -> dict:
    """The process boundary through NCCL at world size 1: the group formed
    by fleet_initialize on a free localhost port, node 0's stream merged
    by fleet_merge_sketches_dist and fleet_merge_exact64_dist, then two
    FleetWindowMerger rounds (node 0's window, then none); the group
    destroyed at the end. Two ranks on one card are not tried: NCCL
    refuses two ranks on one device. Returns the results for the
    checks."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from parca_agent_tpu_torch.parallel import distributed, fleet
    from parca_agent_tpu_torch.runtime.hotspots import HotspotStore

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    distributed.fleet_initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=60,
                                 device=dev)
    out = {"join_s": time.perf_counter() - t0,
           "backend": dist.get_backend(),
           "world_size": dist.get_world_size(),
           "two_ranks_on_one_card": "not tried: NCCL refuses two ranks on "
                                    "one device"}
    try:
        mesh = distributed.local_fleet_mesh()
        out["mesh"] = [str(mesh.device), mesh.n_nodes]
        t0 = time.perf_counter()
        out["sketches"] = distributed.fleet_merge_sketches_dist(h1[0], c[0])
        out["exact64"] = distributed.fleet_merge_exact64_dist(h1[0], h2[0],
                                                              c[0])
        out["merges_ms"] = (time.perf_counter() - t0) * 1e3
        merger = distributed.FleetWindowMerger(interval_s=0.0,
                                               collective_timeout_s=60)
        # The fleet scope's hotspot store rides the rounds, as the CLI's
        # attach_hotspots wires it; each round's groups are recorded.
        store = HotspotStore()
        merger.attach_hotspots(store)
        folds, fold_ms = [], []
        real_fold = store.fleet_fold

        def fleet_fold(u1, u2, uc, time_ns=None):
            folds.append((np.array(u1), np.array(u2), np.array(uc)))
            t0 = time.perf_counter()
            real_fold(u1, u2, uc, time_ns)
            fold_ms.append((time.perf_counter() - t0) * 1e3)

        store.fleet_fold = fleet_fold
        # The rounds' B8 launches, counted from 0: the fleet_hotspots
        # path's, not the fleet path's (its counts are restored after).
        saved = dict(fleet.LAUNCHES)
        fleet.reset_launches()
        merger.submit_window(lambda: (h1[0], h2[0]), c[0])
        merger.merge_round()
        out["rounds"] = [dict(merger.fleet_stats)]
        merger.merge_round()
        out["rounds"].append(dict(merger.fleet_stats))
        out["hotspots_launches"] = {k: n for k, n in fleet.LAUNCHES.items()
                                    if n}
        fleet.LAUNCHES.update(saved)
        out["merger_stats"] = dict(merger.stats)
        out["degraded"] = merger.degraded
        out["hotspot_folds"] = folds
        out["hotspot_fold_ms"] = fold_ms
        out["hotspot_answer"] = store.query(k=HOTSPOT_K, scope="fleet")
    finally:
        dist.destroy_process_group()
    out["node0_total"] = int(np.asarray(c[0], np.int64).sum())
    return out


def phase_fleet(dev, snap, hashes, sketch_ref=None, fleet_ref=None) -> tuple:
    """The fleet merge's path on `dev`: the 8-node stream (fleet_stream)
    through fleet_merge_sketches (the default spec: B6's cluster kernel),
    fleet_merge_exact64 and fleet_merge_exact (B8), the profiles' merge
    of 8 smaller node windows (fleet_merge_profiles), and the process
    boundary through NCCL (fleet_dist) with node 0's first
    FLEET_DIST_ROWS rows, a node below CLUSTER_MIN_ROWS (its sketch
    merge takes B6's global kernel), with the launches counted from 0
    over them; then the checks: the sketches against
    numpy's (the int64 total), the exact merges against numpy's exact
    merge, the profiles against the concat oracle (every pid's mass and
    order from concat_snapshots, every 64th pid's sorted stack counts from
    CPUAggregator on its rows), NCCL's merges against the one-process
    merges of node 0 alone and the merger's rounds against numpy; then
    the kernels against their plain versions at the stream, timed, with
    their bounds (b6_case at the stream and at NCCL's node, b8_case),
    B8 on fleets that share few stacks (b8_traffic), and the reference
    builds in turns with them. Returns the kernel rows and the path's
    launches (fleet_group_split is 0 on these hash keys: nothing
    splits)."""
    import numpy as np

    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.capture.formats import (
        concat_snapshots,
        filter_snapshot_rows,
    )
    from parca_agent_tpu_torch.ops import sketch
    from parca_agent_tpu_torch.parallel import fleet

    t0 = time.perf_counter()
    h1, h2, c = fleet_stream(snap, hashes)
    windows = fleet_node_windows(snap)
    setup_s = time.perf_counter() - t0
    total = int(c.astype(np.int64).sum())
    if total >= 2**31:
        raise AssertionError(f"fleet: the stream's total {total} >= 2^31")

    sketch.reset_launches()
    fleet.reset_launches()
    ms = {}
    t0 = time.perf_counter()
    cm, regs, got_total = fleet.fleet_merge_sketches(h1, c, device=dev)
    ms["sketches"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    u1, u2, uc = fleet.fleet_merge_exact64(h1, h2, c, device=dev)
    ms["exact64"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    uh, uhc = fleet.fleet_merge_exact(h1, c, device=dev)
    ms["exact32"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    profiles, merged = fleet.fleet_merge_profiles(
        windows, aggregator=CPUAggregator(), device=dev)
    ms["profiles"] = (time.perf_counter() - t0) * 1e3
    d1, d2, dc = (x[:1, :FLEET_DIST_ROWS] for x in (h1, h2, c))
    dist_out = fleet_dist(dev, d1, d2, dc)
    launches = {**sketch.LAUNCHES, **fleet.LAUNCHES}

    # The checks.
    spec = fleet.FleetMergeSpec()
    want_regs = sketch.hll_build(h1.ravel(), spec.hll, live=c.ravel() > 0)
    want_cm = sketch.cm_build(h1.ravel(), c.ravel(), spec.cm)
    if got_total != total or not (np.array_equal(cm, want_cm)
                                  and np.array_equal(regs, want_regs)):
        raise AssertionError("fleet: the merged sketches differ from "
                             "numpy's")
    o1, o2, osum = exact_oracle(h1, h2, c)
    if not (np.array_equal(u1, o1) and np.array_equal(u2, o2)
            and np.array_equal(uc, osum)):
        raise AssertionError("fleet: fleet_merge_exact64 differs from "
                             "numpy's exact merge")
    p1, _, psum = exact_oracle(h1, None, c)
    if not (np.array_equal(uh, p1) and np.array_equal(uhc, psum)):
        raise AssertionError("fleet: fleet_merge_exact differs from numpy's "
                             "exact merge")
    # The concat oracle (tests/test_fleet.py's): every pid's mass from
    # the concatenated windows, and CPUAggregator's profiles of every
    # 64th pid, from those pids' rows alone.
    t0 = time.perf_counter()
    concat = concat_snapshots(windows)
    mass = np.bincount(concat.pids, weights=concat.counts.astype(np.float64))
    pids = np.flatnonzero(mass)
    sample = pids[::64]
    want = {p.pid: sorted(p.values.tolist())
            for p in CPUAggregator().aggregate(filter_snapshot_rows(
                concat, np.isin(concat.pids, sample)))}
    oracle_s = time.perf_counter() - t0
    if [p.pid for p in profiles] != pids.tolist() \
            or merged.total_samples() != concat.total_samples() \
            or any(p.total() != int(mass[p.pid]) for p in profiles):
        raise AssertionError("fleet: the merged profiles' pids, total or "
                             "per-pid mass differ from the concat oracle's")
    for p in profiles:
        if p.pid in want and sorted(p.values.tolist()) != want[p.pid]:
            raise AssertionError(f"fleet: pid {p.pid} stack counts")
    if len(want) != len(sample):
        raise AssertionError("fleet: the oracle's sample lost pids")
    one = fleet.fleet_merge_sketches(d1, dc, device=dev)
    d_cm, d_regs, d_total = dist_out["sketches"]
    if not (np.array_equal(d_cm, one[0]) and np.array_equal(d_regs, one[1])
            and d_total == one[2] == dist_out["node0_total"]):
        raise AssertionError("fleet: NCCL's sketch merge differs from the "
                             "one-process merge")
    one = fleet.fleet_merge_exact64(d1, d2, dc, device=dev)
    if not all(np.array_equal(a, b)
               for a, b in zip(dist_out["exact64"], one)):
        raise AssertionError("fleet: NCCL's exact merge differs from the "
                             "one-process merge")
    n1, _, _ = exact_oracle(d1, d2, dc)
    want_rounds = [{"fleet_total_samples": dist_out["node0_total"],
                    "fleet_unique_stacks": len(n1), "fleet_rounds": 1},
                   {"fleet_total_samples": 0, "fleet_unique_stacks": 0,
                    "fleet_rounds": 2}]
    if dist_out["rounds"] != want_rounds or dist_out["degraded"]:
        raise AssertionError(f"fleet: the merger's rounds "
                             f"{dist_out['rounds']} != {want_rounds}")
    # The fleet scope: each round's fleet_fold got B8's groups (node 0's
    # exact merge, then none), and the fleet answer's top K holds to it.
    o1n, o2n, osn = exact_oracle(d1, d2, dc)
    folds = dist_out.pop("hotspot_folds")
    if len(folds) != 2 or len(folds[1][0]) \
            or not all(np.array_equal(a, b) for a, b in zip(
                folds[0], (o1n, o2n, osn))):
        raise AssertionError("fleet: a round's fleet_fold did not get "
                             "B8's groups")
    if dist_out["hotspots_launches"].get("fleet_group", 0) < 1:
        raise AssertionError("fleet: the rounds launched "
                             f"{dist_out['hotspots_launches']}")
    key = (o1n.astype(np.uint64) << np.uint64(32)) | o2n.astype(np.uint64)
    dist_out["hotspot_answer"] = check_hotspots(
        "fleet hotspots", dist_out["hotspot_answer"], key, osn,
        exact_top=True)
    for name, n in launches.items():
        if n < 1 and name != "fleet_group_split":
            raise AssertionError(f"fleet: {name} never launched")

    b6 = b6_case(dev, h1, c, live_counts=True, ref=sketch_ref,
                 want=(want_cm, want_regs))
    b6n = b6_case(dev, d1, dc, live_counts=True, ref=sketch_ref)
    if (b6["kernel"], b6n["kernel"]) != ("cluster", "global"):
        raise AssertionError(f"fleet: the shape rule took {b6['kernel']} at "
                             f"the stream and {b6n['kernel']} at NCCL's node")
    b8 = b8_case(dev, h1, h2, c, ref=fleet_ref, oracle=(o1, o2, osum))
    traffic = b8_traffic(dev, b8_traffic_streams(h1.shape), ref=fleet_ref)
    emit("fleet_path", nodes=FLEET_NODES, stream=list(h1.shape),
         total=total, n_groups=len(o1), n_groups_32=len(p1),
         merged_rows=len(merged), profiles=len(profiles),
         profile_rows_a_node=[len(w) for w in windows], ms=ms,
         setup_s=setup_s, oracle_s=oracle_s, launches=launches,
         nccl={k: v for k, v in dist_out.items()
               if k not in ("sketches", "exact64")},
         sketch_build_cluster=b6, sketch_build=b6n, fleet_group=b8,
         fleet_group_traffic=traffic)
    source = "parca_agent_tpu_torch/csrc/"
    rows = {}
    for name, case, src, replaces in (
            ("sketch_build_cluster", b6, "sketch_build.cu",
             "parca_agent_tpu/ops/sketch.py:79"),
            ("sketch_build", b6n, "sketch_build.cu",
             "parca_agent_tpu/ops/sketch.py:79"),
            ("fleet_group", b8, "fleet_merge.cu",
             "parca_agent_tpu/parallel/fleet.py:164")):
        rows[name] = {
            "name": name, "route": "cuda", "source": source + src,
            "replaces": replaces, "max_abs_err": 0, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}
    return rows, launches, dist_out["hotspots_launches"]


# -- phase 10 ----------------------------------------------------------------

# The live path (--capture procfs|perf): windows of each CLI run, their
# seconds, and the burner's source.
LIVE_WINDOWS = 3
LIVE_PROCFS_S = 2
LIVE_PERF_S = 3
BURNER = "while True:\n sum(i * i for i in range(4000))"


class VecRecorder:
    """Context manager recording the window encoder's calls of the varint
    and ragged-copy passes (pprof/vec.py, as window_encoder.py imported
    them): each call's inputs, copied, and its output buffer's size and
    dtype; the time the copies took is `record_ms`. replay() runs every
    call again through the C++ passes and the numpy ones, on fresh
    buffers, and compares their bytes."""

    NAMES = ("varint_len", "put_varints", "put_varints_padded",
             "ragged_gather")

    def __init__(self):
        self.calls = []
        self.record_ms = 0.0
        self._saved = {}

    def __enter__(self):
        from parca_agent_tpu_torch.pprof import window_encoder

        for name in self.NAMES:
            fn = getattr(window_encoder, name)
            self._saved[name] = fn
            setattr(window_encoder, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from parca_agent_tpu_torch.pprof import window_encoder

        for name, fn in self._saved.items():
            setattr(window_encoder, name, fn)
        return False

    def _wrap(self, name, fn):
        import numpy as np

        def copy(a):
            return None if a is None else np.array(a, copy=True)

        def recorded(*a, **kw):
            t0 = time.perf_counter()
            if name == "varint_len":
                self.calls.append((name, copy(a[0]), None))
            elif name == "ragged_gather":
                flat, starts, lens = a[:3]
                out, out_starts = kw.get("out"), kw.get("out_starts")
                self.calls.append((name, (copy(flat), copy(starts),
                                          copy(lens), copy(out_starts)),
                                   None if out is None
                                   else (len(out), out.dtype)))
            else:
                out, pos, vals = a[:3]
                rest = a[3:] if name == "put_varints_padded" else ()
                self.calls.append((name, (copy(pos), copy(vals), *rest),
                                   (len(out), out.dtype)))
            self.record_ms += (time.perf_counter() - t0) * 1e3
            return fn(*a, **kw)

        return recorded

    def replay(self) -> dict:
        """{pass: {"calls", "values", "native_ms", "numpy_ms"}}; raises
        unless both versions give equal bytes for every call."""
        import numpy as np

        from parca_agent_tpu_torch.pprof import vec

        out = {k: {"calls": 0, "values": 0, "native_ms": 0.0,
                   "numpy_ms": 0.0} for k in self.NAMES}

        def run(name, args, spec, impl):
            t0 = time.perf_counter()
            if name == "varint_len":
                got = vec.varint_len(args, impl=impl)
            elif name == "ragged_gather":
                flat, starts, lens, out_starts = args
                buf = None if spec is None else np.zeros(spec[0], spec[1])
                got = vec.ragged_gather(flat, starts, lens, out=buf,
                                        out_starts=out_starts, impl=impl)[0]
            else:
                got = np.zeros(spec[0], spec[1])
                getattr(vec, name)(got, *args, impl=impl)
            return got, (time.perf_counter() - t0) * 1e3

        for name, args, spec in self.calls:
            a, native_ms = run(name, args, spec, "native")
            b, numpy_ms = run(name, args, spec, "numpy")
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: the C++ pass's bytes != "
                                     "numpy's on the cold encode's call")
            row = out[name]
            row["calls"] += 1
            row["values"] += len(args if name == "varint_len"
                                 else args[2] if name == "ragged_gather"
                                 else args[1])
            row["native_ms"] += native_ms
            row["numpy_ms"] += numpy_ms
        return out


def pack_records(snap, kind: str) -> bytes:
    """The window's rows as the sampler's drain records, with numpy: v1
    (u32 pid, tid, n_kernel, n_user, then the frames, kernel first) or
    v1d (the same with u32 count and a pad word before the frames). Every
    field is a multiple of 8 bytes, so the records are built as u64
    words."""
    import numpy as np

    n = len(snap)
    hw = 2 if kind == "v1" else 3
    ulen = snap.user_len.astype(np.int64)
    klen = snap.kernel_len.astype(np.int64)
    depth = ulen + klen
    off = np.zeros(n + 1, np.int64)
    np.cumsum(hw + depth, out=off[1:])
    words = np.zeros(int(off[-1]), np.uint64)
    start = off[:-1]
    words[start] = (snap.pids.astype(np.uint32).astype(np.uint64)
                    | (snap.tids.astype(np.uint32).astype(np.uint64) << 32))
    words[start + 1] = (klen.astype(np.uint64)
                        | (ulen.astype(np.uint64) << np.uint64(32)))
    if kind == "v1d":
        words[start + 2] = snap.counts.astype(np.uint64)
    col = np.arange(snap.stacks.shape[1])[None, :]
    live = col < depth[:, None]
    # Row j < ulen is user frame j (after the kernel frames); j >= ulen
    # is kernel frame j - ulen (first).
    dest = np.where(col < ulen[:, None], klen[:, None] + col,
                    col - ulen[:, None]) + (start + hw)[:, None]
    words[dest[live]] = snap.stacks[live]
    return words.tobytes()


def decode_plain(buf: bytes, kind: str) -> int:
    """The plain decoder: a Python loop over the records (the v1 one is
    capture/live.py decode_records; v1d reads its count word too).
    Returns the records read."""
    import struct

    import numpy as np

    from parca_agent_tpu_torch.capture.live import decode_records

    if kind == "v1":
        return len(decode_records(buf))
    n = pos = 0
    while pos + 24 <= len(buf):
        _pid, _tid, nk, nu, _count, _pad = struct.unpack_from("<6I", buf,
                                                              pos)
        np.frombuffer(buf, np.uint64, nk + nu, pos + 24)
        pos += 24 + 8 * (nk + nu)
        n += 1
    return n


def live_decoders(snap) -> dict:
    """The sampler's decoders at the bench window's full width: its rows
    written as v1 and v1d records decode back to them (natively, and the
    plain Python loop reads as many records), and pa_stack_hash (the
    v1h drain's hash) equals row_hash_np on every row."""
    import numpy as np

    from parca_agent_tpu_torch.capture import live
    from parca_agent_tpu_torch.ops.hashing import hash_params, row_hash_np

    lib = live.load_native()
    out = {}
    for kind, fn in (("v1", live.decode_records_columnar),
                     ("v1d", live.decode_records_columnar_v1d)):
        t0 = time.perf_counter()
        buf = pack_records(snap, kind)
        pack_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cols = fn(lib, buf, len(buf))
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        n_plain = decode_plain(buf, kind)
        plain_ms = (time.perf_counter() - t0) * 1e3
        pids, tids, ulen, klen, stacks = cols[:5]
        if not (np.array_equal(pids, snap.pids)
                and np.array_equal(tids, snap.tids)
                and np.array_equal(ulen, snap.user_len)
                and np.array_equal(klen, snap.kernel_len)
                and np.array_equal(stacks, snap.stacks)
                and (kind == "v1" or np.array_equal(cols[5], snap.counts))
                and n_plain == len(snap)):
            raise AssertionError(f"the {kind} records did not decode back "
                                 "to the window's rows")
        out[kind] = {"records": len(snap), "bytes": len(buf),
                     "pack_ms": pack_ms, "native_ms": native_ms,
                     "plain_ms": plain_ms}
        del buf, cols
    # pa_stack_hash over each row's kernel and user frames, in place.
    coefs, biases = hash_params(3, snap.stacks.shape[1])
    want = row_hash_np(snap.stacks, snap.pids, snap.user_len,
                       snap.kernel_len, 3)
    stacks = np.ascontiguousarray(snap.stacks)
    base, row_b = stacks.ctypes.data, stacks.shape[1] * 8
    got = np.zeros((len(snap), 3), np.uint32)
    fn = lib.pa_stack_hash
    ulen = snap.user_len.tolist()
    klen = snap.kernel_len.tolist()
    pids = snap.pids.tolist()
    c_ptr, stride, b_ptr = coefs.ctypes.data, coefs.shape[1], \
        biases.ctypes.data
    slots, out_ptr = stacks.shape[1], got.ctypes.data
    t0 = time.perf_counter()
    for i in range(len(snap)):
        u = base + i * row_b
        if fn(u + 8 * ulen[i], klen[i], u, ulen[i], pids[i], c_ptr, stride,
              b_ptr, 3, slots, out_ptr + 12 * i) != 0:
            raise AssertionError(f"pa_stack_hash refused row {i}")
    stack_hash_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(got[:, k], want[k]) for k in range(3)):
        raise AssertionError("pa_stack_hash != row_hash_np")
    out["pa_stack_hash"] = {"rows": len(snap), "ms": stack_hash_ms,
                            "equal_row_hash_np": True}
    return out


def live_cli(dev, label: str, flags: list, seconds: int) -> dict:
    """The port's CLI in this process on the card, --windows LIVE_WINDOWS
    of `seconds` each with `flags`, beside a CPU-burning child process.
    The dictionary the CLI builds keeps its last drain's rows and its last
    close (chip_smoke's KeptAggregator), so K1 and the close are held
    against their plain versions at this path's shapes after the run.
    Returns the run's lines, the stored profiles' mass and pids, the
    kernel checks and the launches."""
    import contextlib
    import io
    import tempfile

    from parca_agent_tpu_torch import cli
    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.aggregator import dict as dict_mod
    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    made = []

    class KeptAggregator(dict_mod.DictAggregator):
        kept_packed = kept_handle = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def _feed_dispatch_async(self, packed, reset):
            self.kept_packed = packed.copy()
            return super()._feed_dispatch_async(packed, reset)

        def close_dispatch(self):
            self.kept_handle = super().close_dispatch()
            return self.kept_handle

    out = io.StringIO()
    burner = subprocess.Popen([sys.executable, "-c", BURNER])
    saved = dict_mod.DictAggregator
    dict_mod.DictAggregator = KeptAggregator
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # Every count to 0 just before the path; read just after.
            probe.reset_launches()
            close.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.run([*NO_PROBE, *HTTP_ANY, *flags,
                              "--windows", str(LIVE_WINDOWS),
                              "--profiling-duration", str(seconds),
                              "--local-store-directory", tmp])
            cli_s = time.perf_counter() - t0
            launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                        "close_pack": close.LAUNCHES["close_pack"]}
            if close.LAUNCHES["close_pack_delta"]:
                launches["close_pack_delta"] = \
                    close.LAUNCHES["close_pack_delta"]
            files = sorted(Path(tmp).glob("*.pb.gz"))
            mass = sum(v[0] for f in files
                       for _, v, _ in parse_pprof(f.read_bytes()).samples)
            pids = {int(f.name.split(".")[0][4:]) for f in files}
    finally:
        dict_mod.DictAggregator = saved
        burner.kill()
        burner.wait()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    windows = [ln for ln in lines if "window" in ln]
    cli_runtime_clean(f"CLI {' '.join(flags)}",
                      [ln["runtime"] for ln in lines if "runtime" in ln])
    if rc != 0 or len(windows) != LIVE_WINDOWS or mass <= 0 \
            or burner.pid not in pids \
            or mass != sum(ln["mass"] for ln in windows):
        raise AssertionError(f"CLI {' '.join(flags)}: rc {rc}, {lines}, "
                             f"mass {mass}, burner {burner.pid} in the "
                             f"store: {burner.pid in pids}")
    (agg,) = made
    h = agg.kept_handle
    if agg.kept_packed is None or h is None or h.acc is None:
        raise AssertionError(f"{label}: no drain or close to check")
    checks = {"feed_accumulate": drain_k1(
        dev, agg, host_table(agg), agg.kept_packed, f"{label}_drain_k1")}
    form = "close_pack_delta" if h.delta_blks else "close_pack"
    checks[form] = handle_close(h, {"kernel": (close.close_pack,
                                               close.close_pack_delta)})
    emit(f"{label}_close_kernel", kernel=form, **checks[form])
    return {"lines": lines, "s": cli_s, "profiles": len(files),
            "mass": mass, "pids": len(pids), "burner_pid": burner.pid,
            "launches": launches,
            "kernels": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")}
                        for k, r in checks.items()}}


def phase_live(dev, snap, hashes, vec_rec) -> dict:
    """Phase 10: the host native layer at the main path's shapes, the
    sampler's decoders at full width, and the CLI sampling this machine
    on the card (procfs; perf with the streaming window where the kernel
    permits perf_event_open). Returns the live path's launches."""
    import errno

    import numpy as np

    from parca_agent_tpu_torch.capture import live
    from parca_agent_tpu_torch.ops.hashing import row_hash_np

    # The row hash on the bench window (2^20 rows, 50,000 pids).
    cols = (snap.stacks, snap.pids, snap.user_len, snap.kernel_len)
    t0 = time.perf_counter()
    native_h = row_hash_np(*cols, n_hashes=3)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain_h = row_hash_np(*cols, n_hashes=3, impl="numpy")
    numpy_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(native_h, plain_h, hashes)):
        raise AssertionError("the native row hash != its numpy version")
    del plain_h, native_h
    emit("live_row_hash", rows=len(snap), n_hashes=3, native_ms=native_ms,
         numpy_ms=numpy_ms, equal=True)
    # The varint passes and the ragged copy on phase 4's cold encode.
    emit("live_vec", calls=len(vec_rec.calls), **vec_rec.replay())
    vec_rec.calls.clear()
    emit("live_decoders", **live_decoders(snap))

    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    procfs = live_cli(dev, "live_procfs", ["--capture", "procfs",
                                           "--aggregator", "dict",
                                           "--fast-encode"], LIVE_PROCFS_S)
    add(procfs["launches"])
    emit("live_procfs_cli", **procfs)
    if procfs["launches"]["feed_accumulate"] < 1 \
            or procfs["launches"]["close_pack"] < 1:
        raise AssertionError(f"the procfs CLI launched {procfs['launches']}")

    # Perf capture where the kernel permits it. Refused for lack of
    # permission (EACCES, EPERM), or on a kernel with no perf events at
    # all (ENODEV, ENOENT, ENOSYS, EOPNOTSUPP: a virtualized kernel), the
    # refusal is printed and the phase goes on; any other failure fails.
    refused = {errno.EACCES: "permission", errno.EPERM: "permission",
               errno.ENODEV: "no perf events", errno.ENOENT: "no perf events",
               errno.ENOSYS: "no perf events",
               errno.EOPNOTSUPP: "no perf events"}
    paranoid = Path("/proc/sys/kernel/perf_event_paranoid")
    paranoid = int(paranoid.read_text()) if paranoid.exists() else None
    try:
        live.PerfEventSampler(frequency_hz=99, window_s=0.1).close()
    except live.SamplerUnavailable as e:
        if e.errno not in refused:
            raise
        why = {"permitted": False, "errno": e.errno,
               "errno_name": errno.errorcode.get(e.errno),
               "reason": refused[e.errno], "perf_event_paranoid": paranoid}
        print("perf: " + json.dumps(why), flush=True)
        emit("live_perf_cli", **why)
        return launches
    perf = live_cli(dev, "live_perf", ["--capture", "perf", "--aggregator",
                                       "dict", "--fast-encode",
                                       "--streaming-window"], LIVE_PERF_S)
    add(perf["launches"])
    cap = perf["lines"][-1]["capture"]
    emit("live_perf_cli", permitted=True, perf_event_paranoid=paranoid,
         **perf)
    if cap["source"] != "perf" or not cap["hash_carry"] \
            or cap["streaming"]["windows_streamed"] < 1 \
            or cap["streaming"]["drains_fed"] < 1 \
            or perf["launches"]["feed_accumulate"] < 1:
        raise AssertionError(f"the perf CLI: {cap}, {perf['launches']}")
    return launches


def runtime_windows(snap):
    """Phase 11's windows: the bench window, then twice its first eighth
    of rows (few touched id blocks, so the second closes by delta)."""
    import dataclasses

    n = len(snap) // 8
    hot = dataclasses.replace(
        snap, pids=snap.pids[:n], tids=snap.tids[:n],
        counts=snap.counts[:n], user_len=snap.user_len[:n],
        kernel_len=snap.kernel_len[:n], stacks=snap.stacks[:n])
    return [("full", snap, len(snap)), ("hot", hot, n), ("hot", hot, n)]


def start_hang_cli():
    """Phase 11's CLI with an injected device.dispatch hang, started
    (start_background): (its run, its temporary directory)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-hang-"))
    argv = [sys.executable, "-m", "parca_agent_tpu_torch", *HTTP_ANY,
            "--capture", "synthetic", "--windows", "3",
            "--profiling-duration", "0.1",
            "--fast-encode", "--device-timeout", str(HANG_TIMEOUT_S),
            "--fault-inject", "device.dispatch:hang:after=0",
            "--trace-incident-dir", str(tmp / "incidents"),
            "--local-store-directory", str(tmp / "store")]
    return Collected(argv, cli_env(), HANG_TIMEOUT_S + HANG_MARGIN_S + 60), \
        tmp


def start_background() -> dict:
    """The subprocess CLIs of phases 5 and 11 (fast_encode_cli's four
    runs, the hang CLI), started beside the host work of the window's
    set-up and phase 4 (each is its own process over the CLI's synthetic
    windows; their phases collect and check them)."""
    return {"fast_encode": start_fast_encode_cli(),
            "hang": start_hang_cli()}


def phase_runtime(dev, snap, want, state, hashes, hang) -> dict:
    """Phase 11 (module docs), with the hang CLI `hang` (start_hang_cli).
    Returns the phase's launches."""
    import shutil

    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.runtime import device_telemetry as dtel

    class Counted(DictAggregator):
        """While telemetry is installed, sums the bytes its close packs
        must fetch, from each launch's plan and the buffer's layout
        (close.py): the lanes of n_fetch ids (n_blk_buf blocks of 128 for
        a delta close) at `width` bits, the block ids of a delta close,
        the sideband's ids and values, the counters."""

        d2h_want = 0

        def _close_pack_dispatch(self, acc, n_fetch, width, n_over_buf):
            if dtel.get() is not None:
                self.d2h_want += 4 * (n_fetch * width // 32
                                      + 2 * n_over_buf + 2)
            return super()._close_pack_dispatch(acc, n_fetch, width,
                                                n_over_buf)

        def _close_delta_dispatch(self, acc, touch, n_fetch, width,
                                  n_over_buf, n_blk_buf):
            if dtel.get() is not None:
                self.d2h_want += 4 * (n_blk_buf * 128 * width // 32
                                      + n_blk_buf + 2 * n_over_buf + 4)
            return super()._close_delta_dispatch(acc, touch, n_fetch, width,
                                                 n_over_buf, n_blk_buf)

    def drain_bounds(n):
        return np.linspace(0, n, DRAINS + 1).astype(int)

    def feed_bytes(n, coalesce: bool) -> int:
        """The packed bytes a window of the bench's first n rows uploads
        in DRAINS feeds, from its rows: each feed one [4, n_pad] uint32
        buffer, n_pad the next power of two (16 at least) of the rows it
        dispatches (its distinct identity triples when it coalesces)."""
        total = 0
        for lo, hi in zip(drain_bounds(n)[:-1], drain_bounds(n)[1:]):
            nd = int(hi - lo)
            if coalesce:
                key = np.stack([h[lo:hi] for h in hashes[:3]], axis=1)
                nd = len(np.unique(key, axis=0))
            total += 16 << max(4, (nd - 1).bit_length())
        return total

    def feed_close(agg, win, n):
        """One window of DRAINS feeds and its close: (counts, ms, the
        feeds' dispatch ms summed, the close's ms)."""
        bounds = drain_bounds(n)
        disp = 0.0
        t0 = time.perf_counter()
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            agg.feed(win, hashes, lo=int(lo), hi=int(hi))
            disp += agg.timings.get("feed_dispatch", 0.0)
        t1 = time.perf_counter()
        counts = agg.close_window(copy=True)
        t2 = time.perf_counter()
        return counts, (t2 - t0) * 1e3, disp * 1e3, (t2 - t1) * 1e3

    # Counts-only checks need no per-pid location registries, and
    # load_state without them takes seconds, not tens of seconds.
    lite = {**state, "registries": {}}
    windows = runtime_windows(snap)
    masses = {}
    for kind, win, _n in windows:
        m = np.bincount(win.pids.astype(np.int64),
                        weights=win.counts.astype(np.float64))
        masses[kind] = {int(p): int(m[p]) for p in np.flatnonzero(m)}
    if masses["full"] != {p.pid: p.total() for p in want}:
        raise AssertionError("phase 11's oracle differs from phase 4's")
    arms = {"id_cap": dict(id_cap=RUNTIME_ID_CAP, overflow="raise"),
            "delta_fetch_false": dict(overflow="raise", delta_fetch=False),
            "delta_fetch_true": dict(overflow="raise", delta_fetch=True),
            "coalesce_false": dict(id_cap=RUNTIME_ID_CAP, overflow="sketch",
                                   coalesce=False)}
    telemetry = dtel.DeviceTelemetry(device=dev)
    dtel.install(telemetry)
    launches = {"feed_accumulate": 0, "close_pack": 0, "close_pack_delta": 0}
    h2d = d2h = 0
    h2d_windows = {}   # (rows, coalesce) -> feed bytes, from the rows
    try:
        for arm, kw in arms.items():
            agg = Counted(capacity=CAP, device=dev, **kw)
            t0 = time.perf_counter()
            agg.load_state(lite)
            load_s = time.perf_counter() - t0
            probe.reset_launches()
            close.reset_launches()
            rows = []
            coalesce = kw.get("coalesce", True)
            for w, (kind, win, n) in enumerate(windows):
                key = (n, coalesce)
                if key not in h2d_windows:
                    h2d_windows[key] = feed_bytes(n, coalesce)
                h2d += h2d_windows[key]
                counts, ms, _disp, _close = feed_close(agg, win, n)
                if int(counts.sum()) != win.total_samples():
                    raise AssertionError(f"runtime {arm} window {w}: total "
                                         f"{int(counts.sum())}")
                id_pid = agg._id_pid[:len(counts)].astype(np.int64)
                got = np.bincount(id_pid, weights=counts.astype(np.float64))
                if {int(p): int(got[p]) for p in np.flatnonzero(got)} \
                        != masses[kind]:
                    raise AssertionError(f"runtime {arm} window {w}: per-pid "
                                         "mass differs from the oracle")
                rows.append({"window": w, "rows": n, "feeds_and_close_ms": ms,
                             "delta_closes": agg.stats.get("delta_closes", 0),
                             "fetch_rows_last":
                                 agg.stats.get("fetch_rows_last")})
            turns = []
            if arm == "delta_fetch_true":
                # Telemetry's cost on the main path's window (phase 4's
                # configuration), in turns: on, off, off, on.
                for on in (True, False, False, True):
                    dtel.install(telemetry if on else None)
                    if on:
                        h2d += feed_bytes(len(snap), True)
                    counts, ms, disp, close_ms = feed_close(agg, snap,
                                                            len(snap))
                    if int(counts.sum()) != snap.total_samples():
                        raise AssertionError("runtime telemetry turn: total")
                    turns.append({"telemetry": on, "feeds_and_close_ms": ms,
                                  "feed_dispatch_ms_sum": disp,
                                  "close_ms": close_ms})
                dtel.install(telemetry)
            got = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                   "close_pack": close.LAUNCHES["close_pack"],
                   "close_pack_delta": close.LAUNCHES["close_pack_delta"]}
            want_delta = arm != "delta_fetch_false"
            if got["feed_accumulate"] < len(windows) * DRAINS \
                    or got["close_pack"] < 1 \
                    or (got["close_pack_delta"] > 0) != want_delta:
                raise AssertionError(f"runtime {arm}: launches {got}")
            for k in launches:
                launches[k] += got[k]
            d2h += agg.d2h_want
            emit("runtime_dict", arm=arm, options=kw, id_cap=agg._id_cap,
                 delta_block=agg._blk, load_state_s=load_s, windows=rows,
                 telemetry_turns=turns, launches=got,
                 coalesce_rows_in=agg.stats.get("coalesce_rows_in", 0))
            del agg
    finally:
        dtel.install(None)
    tel = telemetry.snapshot()
    ident = tel["identity"]
    if ident.get("device_kind") != torch.cuda.get_device_name(0) \
            or set(ident.get("routes", {}).values()) != {"cuda"}:
        raise AssertionError(f"telemetry identity: {ident}")
    for k in ("feed_probe", "close_pack", "close_delta"):
        ev = tel["kernels"].get(k, {})
        if ev.get("compiles", 0) < 1 or ev.get("executes", 0) < 1:
            raise AssertionError(f"telemetry {k}: {ev}")
    tr = tel["transfers"]
    if tr["feed_probe"]["h2d"]["bytes"] != h2d \
            or tr["close_fetch"]["d2h"]["bytes"] != d2h:
        raise AssertionError(f"telemetry bytes {tr} against h2d {h2d}, "
                             f"d2h {d2h} from the windows and the plans")
    emit("runtime_telemetry", identity=ident, kernels=tel["kernels"],
         transfers=tr, h2d_rows_bytes=h2d, d2h_plan_bytes=d2h,
         stats=tel["stats"],
         note="execute is the host's launch time, not the kernel's")

    # The CLI with an injected device.dispatch hang (start_hang_cli): a
    # bounded exit.
    run, tmp = hang
    try:
        rc, stdout, stderr, wall = run.result()
        lines = stdout.strip().splitlines()
        last = json.loads(lines[-1]) if lines else {}
        incidents = [json.loads(f.read_text()) for f in
                     sorted((tmp / "incidents").glob("*.json"))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kinds = [body["kind"] for body in incidents]
    # Each incident bundles a self-profile of the agent.
    self_profiled = [("self_profile_pprof_gz_b64" in body)
                     for body in incidents]
    health = last.get("device_health", {})
    # The bring-up probe ran in that CLI before it touched the card: a
    # child that launched the row hash kernel, timed in its snapshot.
    if rc == 0 or wall > HANG_TIMEOUT_S + HANG_MARGIN_S \
            or health.get("state") != "wedged" \
            or health["stats"]["hangs_total"] != 1 \
            or health["stats"]["probes_ok"] != 1 \
            or not health.get("last_probe_s") \
            or kinds != ["device_hang"] or self_profiled != [True]:
        raise AssertionError(f"hang CLI: rc {rc}, {wall:.1f} s, "
                             f"{last}, incidents {kinds}, self-profiled "
                             f"{self_profiled}: {stderr[-1500:]}")
    emit("runtime_probe", s=health["last_probe_s"],
         probes=health["stats"], source="runtime_hang_cli")
    emit("runtime_hang_cli", rc=rc, wall_s=wall,
         device_timeout_s=HANG_TIMEOUT_S, margin_s=HANG_MARGIN_S,
         device_health=health, incidents=kinds,
         incidents_self_profiled=self_profiled)
    return launches


# -- phase 12: symbolization, process identity, DWARF unwinding ---------------

SYM_KSYMS = 20_000          # text symbols of the synthetic kallsyms
JIT_EVERY = 8               # one pid in 8 runs JIT code
JIT_BASE = 0x2000_0000_0000  # below every synthetic mapping: unmapped
JIT_SPAN = 0x10000          # each JIT pid's code region
SYM_EVERY = 64
DWARF_LEVELS = 6            # (outer, middle, leaf) triples below main
DWARF_DUMP = 16_384         # --dwarf-stack-dump-bytes' default
DWARF_SAMPLES = 16_000      # 100 Hz x 16 CPUs x 10 s
DWARF_CPUS = 16
SYM_CLI_WINDOWS = 3
DWARF_FIXTURE = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

static unsigned char buf[DUMP];
static const char *out_path;

/* The captured thread's registers and DUMP bytes of its stack from rsp
   (less where the stack ends), written as u64 rip, rsp, rbp, n, then
   the bytes: one sample as perf's user-regs and user-stack dump give
   it. */
__attribute__((noinline, noclone)) void dump(void) {
  uint64_t ip, sp, bp;
  __asm__ volatile("lea 0(%%rip), %0\n\tmov %%rsp, %1\n\tmov %%rbp, %2"
                   : "=r"(ip), "=r"(sp), "=r"(bp));
  uint64_t end = 0, lo, hi;
  char line[512];
  FILE *m = fopen("/proc/self/maps", "r");
  while (m && fgets(line, sizeof line, m))
    if (strstr(line, "[stack]") && sscanf(line, "%lx-%lx", &lo, &hi) == 2)
      end = hi;
  if (m) fclose(m);
  uint64_t n = end > sp && end - sp < DUMP ? end - sp : DUMP;
  memcpy(buf, (const void *)sp, n);
  FILE *f = fopen(out_path, "wb");
  uint64_t hdr[4] = {ip, sp, bp, n};
  fwrite(hdr, 8, 4, f);
  fwrite(buf, 1, n, f);
  fclose(f);
}

__attribute__((noinline, noclone)) int outer(int n);

__attribute__((noinline, noclone)) int leaf(int n) {
  int r;
  if (n == 0) {
    dump();
    r = 1;
  } else {
    r = outer(n - 1);
  }
  __asm__ volatile("" ::: "memory");
  return r + 1;
}

__attribute__((noinline, noclone)) int middle(int n) {
  int r = leaf(n);
  __asm__ volatile("" ::: "memory");
  return r + 2;
}

__attribute__((noinline, noclone)) int outer(int n) {
  int r = middle(n);
  __asm__ volatile("" ::: "memory");
  return r + 3;
}

int main(int argc, char **argv) {
  out_path = argv[1];
  int r = outer(atoi(argv[2]) - 1);
  printf("%d\n", r);
  fflush(stdout);
  sleep(120);
  return 0;
}
"""
PERF_CHILD = """
import sys, time
def hot(n):
    return sum(i * i for i in range(n))
for _ in range(200):
    hot(500)
active = getattr(sys, "is_stack_trampoline_active", lambda: False)()
print("ready", int(active), flush=True)
time.sleep(120)
"""


class SymbolWorld:
    """Phase 12's names, made from a seed: a kallsyms over the synthetic
    kernel addresses, and for one pid in JIT_EVERY two new stacks whose
    user frames run in an anonymous (unmapped) JIT region, with a perf
    map of that region in the pid's mount namespace. ``files`` is the
    FakeFS content; ``ksym`` and ``perf`` are the oracles (a sorted
    address table for np.searchsorted, and each pid's (start, end,
    name) entries)."""

    def __init__(self, snap, seed: int = 12):
        import dataclasses

        import numpy as np

        from parca_agent_tpu_torch.capture.formats import KERNEL_ADDR_START

        rng = np.random.default_rng(seed)
        # The synthetic kernel frames lie in [K, K + 2^22) (synthetic.py).
        offs = np.sort(rng.choice(1 << 18, SYM_KSYMS, replace=False))
        addrs = np.uint64(KERNEL_ADDR_START) + offs.astype(np.uint64) * 16
        types = rng.choice(list("TTTTttWDr"), SYM_KSYMS)
        lines = []
        for i, (a, t) in enumerate(zip(addrs.tolist(), types)):
            lines.append(f"{a:016x} {t} k_{i}_{t}")
        text = types != "D"
        text &= types != "r"
        self.ksym_addrs = addrs[text]
        self.ksym_names = [f"k_{i}_{t}" for i, t in enumerate(types)
                           if t not in "Dr"]
        self.files = {"/proc/kallsyms": ("\n".join(lines) + "\n").encode()}
        pids, first = np.unique(snap.pids, return_index=True)
        self.jit_pids = pids[::JIT_EVERY]
        self.perf: dict[int, list] = {}
        n = len(self.jit_pids)
        stacks = np.zeros((2 * n, snap.stacks.shape[1]), np.uint64)
        ulen = np.zeros(2 * n, np.int32)
        klen = np.zeros(2 * n, np.int32)
        for j, pid in enumerate(self.jit_pids.tolist()):
            base = JIT_BASE + j * JIT_SPAN
            # Two hot JIT functions and one the map does not name.
            stacks[2 * j, :2] = (base + 0x100, base + 0x900)
            ulen[2 * j] = 2
            row = first[j * JIT_EVERY]
            stacks[2 * j + 1, :2] = (base + 0x1500, snap.stacks[row, 0])
            stacks[2 * j + 1, 2:4] = KERNEL_ADDR_START + np.uint64(0x40) \
                * rng.integers(1, 1 << 16, 2).astype(np.uint64)
            ulen[2 * j + 1] = 2
            klen[2 * j + 1] = 2
            nspid = 7 + j % 5
            self.perf[pid] = [(base, base + 0x400, f"jit::{pid}::hot"),
                              (base + 0x800, base + 0xC00,
                               f"jit::{pid}::loop (tier 2)"),
                              (base + 0x1400, base + 0x1480,
                               f"jit::{pid}::cold")]
            self.files[f"/proc/{pid}/status"] = \
                f"Name:\tjit\nNSpid:\t{pid}\t{nspid}\n".encode()
            self.files[f"/proc/{pid}/root/tmp/perf-{nspid}.map"] = "".join(
                f"{lo:x} {hi - lo:x} {name}\n"
                for lo, hi, name in self.perf[pid]).encode()
        jp = np.repeat(self.jit_pids.astype(np.int32), 2)
        self.window = dataclasses.replace(
            snap, pids=np.concatenate([snap.pids, jp]),
            tids=np.concatenate([snap.tids, jp]),
            counts=np.concatenate([snap.counts,
                                   np.full(2 * n, 3, np.int64)]),
            user_len=np.concatenate([snap.user_len, ulen]),
            kernel_len=np.concatenate([snap.kernel_len, klen]),
            stacks=np.concatenate([snap.stacks, stacks]))

    def want(self, prof) -> list:
        """The name the symbolizer must give each location of ``prof``
        (None: no name): kernel locations from the kallsyms' sorted
        address table, unmapped user locations from the pid's perf map,
        mapped user locations none."""
        import numpy as np

        out = [None] * prof.n_locations
        kern = np.asarray(prof.loc_is_kernel, bool)
        ki = np.flatnonzero(kern)
        pos = np.searchsorted(self.ksym_addrs, prof.loc_address[ki],
                              side="right") - 1
        for i, k in zip(ki.tolist(), pos.tolist()):
            out[i] = self.ksym_names[k] if k >= 0 else None
        mapped = np.isin(prof.loc_mapping_id,
                         [m.id for m in prof.mappings if m.path])
        entries = self.perf.get(prof.pid, ())
        for i in np.flatnonzero(~kern & ~mapped).tolist():
            addr = int(prof.loc_address[i])
            for lo, hi, name in entries:
                if lo <= addr < hi:
                    out[i] = name
        return out


def check_names(world, prof) -> int:
    """Raise unless every location of ``prof`` carries the oracle's name
    (one line, or none), in the profile and in its build_pprof parsed
    back; returns the named locations."""
    from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof

    want = [[w] if w else [] for w in world.want(prof)]
    fns = [f[0] for f in prof.functions]
    got = ([[fns[fid - 1] for fid, _ in ls] for ls in prof.loc_lines]
           if prof.loc_lines is not None else [[]] * prof.n_locations)
    parsed = parse_pprof(build_pprof(prof, compress=False))
    pf = {fid: f["name"] for fid, f in parsed.functions.items()}
    back = [[pf[fid] for fid, _ in parsed.locations[i + 1]["lines"]]
            for i in range(prof.n_locations)]
    if got != want or back != got:
        bad = next(i for i in range(prof.n_locations)
                   if got[i] != want[i] or back[i] != got[i])
        raise AssertionError(
            f"symbolize pid {prof.pid} location {bad} "
            f"{int(prof.loc_address[bad]):#x}: {got[bad]} (pprof "
            f"{back[bad]}), oracle {want[bad]}")
    return sum(1 for w in want if w)


def symbolize_window(dev, snap, agg) -> dict:
    """Phase 12 (a): aggregate() of the bench window plus the JIT pids'
    stacks on ``agg``, phase 7's warm dictionary, then the Symbolizer
    over a FakeFS of SymbolWorld's names; every 64th pid checked against
    the oracle, with the collector as the CLI's loop runs it. Returns
    the launches."""
    import gc

    t0 = time.perf_counter()
    world = SymbolWorld(snap)
    world_s = time.perf_counter() - t0
    # The collector as the CLI's loop runs it after its first window
    # (WindowLoop manage_gc): the warm state frozen, no automatic pass.
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _symbolize_window(dev, world, agg, world_s)
    finally:
        gc.enable()
        gc.unfreeze()


def _symbolize_window(dev, world, agg, world_s: float) -> dict:
    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.symbolize import KsymCache, Symbolizer
    from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache
    from parca_agent_tpu_torch.utils.vfs import FakeFS

    win = world.window
    probe.reset_launches()
    close.reset_launches()
    t0 = time.perf_counter()
    profiles = agg.aggregate(win)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    aggregate_ms = (time.perf_counter() - t0) * 1e3
    launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                "close_pack": close.LAUNCHES["close_pack"],
                "close_pack_delta": close.LAUNCHES["close_pack_delta"]}
    if launches["feed_accumulate"] < 1 \
            or launches["close_pack"] + launches["close_pack_delta"] < 1:
        raise AssertionError(f"symbolize window launches {launches}")
    total = sum(p.total() for p in profiles)
    if total != win.total_samples() or len(profiles) != len(
            np.unique(win.pids)):
        raise AssertionError(f"symbolize window: {total} samples in "
                             f"{len(profiles)} profiles")
    timings = {k: v * 1e3 for k, v in agg.timings.items()}
    fs = FakeFS(dict(world.files))
    sym = Symbolizer(ksym=KsymCache(fs=fs), perf=PerfMapCache(fs=fs))
    n_fn = sum(len(p.functions) for p in profiles)
    t0 = time.perf_counter()
    sym.symbolize(profiles)
    symbolize_ms = (time.perf_counter() - t0) * 1e3
    if sym.last_errors:
        raise AssertionError(f"symbolize errors: {sym.last_errors}")
    t0 = time.perf_counter()
    jit = set(world.jit_pids.tolist())
    # Every 64th pid (one in JIT_EVERY runs JIT code, so each of these).
    checked = profiles[::SYM_EVERY]
    named = sum(check_names(world, p) for p in checked)
    if not all(p.pid in jit for p in checked) or named == 0:
        raise AssertionError("symbolize: a checked pid without JIT code, "
                             "or no name checked")
    check_ms = (time.perf_counter() - t0) * 1e3
    n_loc = sum(p.n_locations for p in profiles)
    named_loc = sum(sum(1 for ls in p.loc_lines if ls)
                    for p in profiles if p.loc_lines is not None)
    emit("symbolize_window", rows=len(win), pids=len(profiles),
         jit_pids=len(jit), samples=total, world_s=world_s,
         aggregate_ms=aggregate_ms,
         close_ms=timings.get("close_dispatch", 0.0)
         + timings.get("close_fetch", 0.0) + timings.get("close_unpack", 0.0),
         timings_ms=timings, symbolize_ms=symbolize_ms,
         pids_named=sum(1 for p in profiles if p.functions),
         locations=n_loc, locations_named=named_loc,
         functions_added=sum(len(p.functions) for p in profiles) - n_fn,
         checked_pids=len(checked), checked_named=named, check_ms=check_ms,
         gc="frozen and disabled, as WindowLoop(manage_gc=True)",
         launches=launches)
    return launches


def symbolize_real_fs() -> dict:
    """Phase 12 (b): a /proc/kallsyms symbol through KsymCache, and three
    entries of a `python3 -X perf` child's perf map through PerfMapCache
    and namespaced_pid, on the running host's filesystem."""
    from parca_agent_tpu_torch.symbolize import KsymCache
    from parca_agent_tpu_torch.symbolize.ksym import parse_kallsyms
    from parca_agent_tpu_torch.symbolize.perfmap import (
        PerfMapCache,
        namespaced_pid,
        parse_perf_map,
    )
    from parca_agent_tpu_torch.utils.vfs import RealFS

    out = {}
    try:
        text = Path("/proc/kallsyms").read_bytes()
    except OSError as e:
        out["kallsyms"] = {"note": f"no /proc/kallsyms here: {e}"}
    else:
        addrs, names = parse_kallsyms(text)
        nz = [i for i in range(1, len(addrs) - 1) if addrs[i]
              and addrs[i - 1] != addrs[i] != addrs[i + 1]]
        if not nz:
            out["kallsyms"] = {"symbols": len(addrs), "nonzero": 0,
                               "note": "kptr_restrict zeroes every address"}
        else:
            i = nz[len(nz) // 2]
            got = KsymCache().resolve([int(addrs[i]) + 1])[0]
            if got != names[i]:
                raise AssertionError(f"kallsyms {int(addrs[i]):#x}: {got} "
                                     f"!= {names[i]}")
            out["kallsyms"] = {"symbols": len(addrs), "nonzero": len(nz),
                               "address": hex(int(addrs[i])), "name": got}
    child = subprocess.Popen([sys.executable, "-X", "perf", "-c", PERF_CHILD],
                             stdout=subprocess.PIPE, text=True)
    path = Path(f"/tmp/perf-{child.pid}.map")
    try:
        ready = child.stdout.readline().split()
        if not path.exists():
            out["perf_map"] = {"note": "this interpreter wrote no perf map "
                                       "(built without the perf trampoline)",
                               "ready": ready, "python": sys.version.split()[0]}
            return out
        nspid = namespaced_pid(RealFS(), child.pid)
        text = path.read_bytes()
        pm = parse_perf_map(text)
        spans = sorted(zip(pm.starts.tolist(), pm.ends.tolist(), pm.names))
        alone = [(lo, hi, n) for k, (lo, hi, n) in enumerate(spans)
                 if (k == 0 or spans[k - 1][1] <= lo)
                 and (k + 1 == len(spans) or hi <= spans[k + 1][0])
                 and hi > lo]
        if len(alone) < 3:
            raise AssertionError(f"perf map of {len(spans)} entries")
        picks = [alone[0], alone[len(alone) // 2], alone[-1]]
        cache = PerfMapCache()
        got = cache.map_for_pid(child.pid).lookup_many(
            [(lo + hi) // 2 for lo, hi, _ in picks])
        if got != [n for _, _, n in picks] or nspid != child.pid:
            raise AssertionError(f"perf map: {got} against {picks}, nspid "
                                 f"{nspid}")
        out["perf_map"] = {"entries": len(pm), "bytes": len(text),
                           "nspid": nspid, "resolved": got,
                           "trampoline": ready}
    finally:
        child.kill()
        child.wait()
        path.unlink(missing_ok=True)
    return out


def dwarf_walk(dev, tmp: Path) -> dict:
    """Phase 12 (c): the frameless fixture built with gcc at run time, its
    dumped sample walked DWARF_SAMPLES times through unwind_records over
    tables that UnwindTableCache.build_now built from its real maps, then
    the walked records through records_to_snapshot and the scalar loop
    on the card. Returns the launches."""
    import dataclasses
    import struct

    import numpy as np
    import torch

    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.live import (
        UnwindTableCache,
        mapping_table_for_pids,
        records_to_snapshot,
        unwind_records,
    )
    from parca_agent_tpu_torch.elf.reader import ElfFile
    from parca_agent_tpu_torch.process.maps import ProcessMapCache
    from parca_agent_tpu_torch.process.objectfile import ObjectFileCache
    from parca_agent_tpu_torch.profiler.cpu import AggregateLoop
    from parca_agent_tpu_torch.unwind.walker import WalkStats

    src = tmp / "frameless.c"
    exe = tmp / "frameless"
    dumpf = tmp / "sample.bin"
    src.write_text(DWARF_FIXTURE)
    cc = subprocess.run(["gcc", "-O2", "-fomit-frame-pointer",
                         f"-DDUMP={DWARF_DUMP}", str(src), "-o", str(exe)],
                        capture_output=True, text=True, timeout=120)
    if cc.returncode != 0:
        raise AssertionError(f"fixture build failed: {cc.stderr[-2000:]}")
    proc = subprocess.Popen([str(exe), str(dumpf), str(DWARF_LEVELS)],
                            stdout=subprocess.PIPE, text=True)
    try:
        if not proc.stdout.readline().strip():
            raise AssertionError("the fixture did not run")
        raw = dumpf.read_bytes()
        rip, rsp, rbp, n = struct.unpack_from("<4Q", raw)
        stack = np.frombuffer(raw, np.uint8, n, 32).copy()
        maps = ProcessMapCache()
        tables = UnwindTableCache(maps)
        try:
            t0 = time.perf_counter()
            table = tables.build_now(proc.pid)
            build_ms = (time.perf_counter() - t0) * 1e3
            if table is None or len(table) == 0:
                raise AssertionError("no unwind table for the fixture")
            mine = maps.executable_mappings(proc.pid)
            objs = sorted({m.path for m in mine})
            recs = [(proc.pid, proc.pid + k % DWARF_CPUS,
                     np.zeros(0, np.uint64), np.array([rip], np.uint64),
                     rip, rsp, rbp, stack) for k in range(DWARF_SAMPLES)]
            stats = WalkStats()
            t0 = time.perf_counter()
            walked = unwind_records(recs, tables, stats=stats)
            walk_ms = (time.perf_counter() - t0) * 1e3
        finally:
            tables.close()
        ef = ElfFile(exe.read_bytes())
        syms = [(s.value, s.value + s.size, s.name) for s in ef.symbols()
                if s.name in ("dump", "leaf", "middle", "outer", "main")]
        base = min(m.start - m.offset for m in mine
                   if m.path == str(exe))
        want = ["dump"] + ["leaf", "middle", "outer"] * DWARF_LEVELS \
            + ["main"]

        def names(frames):
            out = []
            for a in frames[:len(want)].tolist():
                hit = [nm for lo, hi, nm in syms if lo <= a - base < hi]
                out.append(hit[0] if hit else hex(a))
            return out

        first = names(walked[0][3])
        if first != want or any(not np.array_equal(w[3], walked[0][3])
                                for w in walked):
            raise AssertionError(f"walk: {first} against {want}")
        if stats.total != DWARF_SAMPLES or stats.pc_not_covered \
                or stats.unsupported:
            raise AssertionError(f"walk stats {stats}")
        t0 = time.perf_counter()
        snap = records_to_snapshot(
            walked, mapping_table_for_pids(maps, ObjectFileCache(),
                                           [proc.pid]),
            int(1e7), int(10e9))
        snapshot_ms = (time.perf_counter() - t0) * 1e3
    finally:
        proc.kill()
        proc.wait()

    class Source:
        def __init__(self):
            self.left = [snap]

        def poll(self):
            return self.left.pop() if self.left else None

    class Kept(DictAggregator):
        profiles = None

        def aggregate(self, s, hashes=None):
            self.profiles = super().aggregate(s, hashes)
            return self.profiles

    agg = Kept(capacity=1 << 12, device=dev, overflow="raise")
    records = []
    probe.reset_launches()
    close.reset_launches()
    loop = AggregateLoop(Source(), agg, on_window=records.append,
                         duration_s=0.01)
    while loop.run_iteration():
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {"feed_accumulate": probe.LAUNCHES["feed_accumulate"],
                "close_pack": close.LAUNCHES["close_pack"],
                "close_pack_delta": close.LAUNCHES["close_pack_delta"]}
    mass = {p.pid: p.total() for p in agg.profiles}
    if mass != {proc.pid: DWARF_SAMPLES} or len(records) != 1 \
            or launches["feed_accumulate"] < 1 \
            or launches["close_pack"] + launches["close_pack_delta"] < 1:
        raise AssertionError(f"walked window: mass {mass}, {records}, "
                             f"launches {launches}")
    depth = int(snap.user_len.max())
    emit("symbolize_dwarf", levels=DWARF_LEVELS, objects=objs,
         table_rows=len(table), table_shards=len(table.shards),
         table_build_ms=build_ms, samples=DWARF_SAMPLES,
         dump_bytes=int(n), walk_ms=walk_ms,
         walk_stats=dataclasses.asdict(stats),
         success_ratio=stats.success / stats.total,
         main_at_depth=len(want) - 1, walked_depth=depth,
         frames=names(walked[0][3]), snapshot_ms=snapshot_ms,
         rows=len(snap), window=records[0], launches=launches)
    return launches


def start_sym_cli(store: Path, capture: str, *flags):
    """The CLI without --fast-encode on the card: SYM_CLI_WINDOWS windows
    of 1 s from ``capture`` with ``flags``, started (finish_sym_cli waits
    for it)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    argv = ["--capture", capture, "--aggregator", "dict", "--windows",
            str(SYM_CLI_WINDOWS), "--profiling-duration", "1",
            "--local-store-directory", str(store), *NO_PROBE, *HTTP_ANY,
            *flags]
    proc = subprocess.Popen([sys.executable, "-m", "parca_agent_tpu_torch",
                             *argv], cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, argv, time.perf_counter()


def finish_sym_cli(started) -> dict:
    """The started CLI's windows and runtime line; raises unless it exits
    0 with SYM_CLI_WINDOWS windows that name the symbolize span and ship
    their whole mass."""
    proc, argv, t0 = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    wins = [ln for ln in lines if "window" in ln]
    runtime = [ln["runtime"] for ln in lines if "runtime" in ln]
    label = " ".join(argv)
    if proc.returncode != 0 or len(wins) != SYM_CLI_WINDOWS \
            or any("symbolize_ms" not in w or w["mass"] != w["samples"]
                   for w in wins):
        raise AssertionError(f"CLI {label}: rc {proc.returncode}, {wins}: "
                             f"{err[-2000:]}")
    cli_runtime_clean(f"CLI {label}", runtime)
    rt = runtime[0]
    if "symbolize" not in rt["trace"]["stage_percentiles"] \
            or "process_identity" not in rt:
        raise AssertionError(f"CLI {label}: runtime {rt}")
    return {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "windows": [{k: w[k] for k in ("window", "capture", "rows",
                                           "mass", "aggregate_ms",
                                           "symbolize_ms")} for w in wins],
            "symbolize_p50_ms":
                rt["trace"]["stage_percentiles"]["symbolize"]["p50_ms"],
            "process_identity": rt["process_identity"],
            "faults_fired": rt.get("faults_fired", {}),
            "dwarf_walk": rt.get("dwarf_walk")}


def phase_symbolize(dev, snap, agg) -> dict:
    """Phase 12 (module docs). Returns the phase's launches, summed over
    its scalar window and its walked window."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # The CLI runs go first and overlap the library checks.
        clis = {
            "identity": start_sym_cli(tmp / "s0", "procfs"),
            "process.identity": start_sym_cli(
                tmp / "s1", "procfs", "--fault-inject",
                "process.identity:error"),
            # procfs stacks are depth 1 at each process's entry point, with
            # no kernel frames: the kernel resolve runs on the synthetic
            # windows' kernel tails.
            "symbolize.kernel": start_sym_cli(
                tmp / "s2", "synthetic", "--fault-inject",
                "symbolize.kernel:error"),
        }
        try:
            la = symbolize_window(dev, snap, agg)
            emit("symbolize_real_fs", **symbolize_real_fs())
            lc = dwarf_walk(dev, tmp)
        finally:
            runs = {}
            for name, started in clis.items():
                try:
                    runs[name] = finish_sym_cli(started)
                except Exception:
                    for other in clis.values():
                        if other[0].poll() is None:
                            other[0].kill()
                    raise
    ident = runs["identity"]["process_identity"]
    faulted = runs["process.identity"]
    if ident["checks_total"] < 1 \
            or faulted["faults_fired"].get("process.identity", 0) \
            < SYM_CLI_WINDOWS \
            or faulted["process_identity"]["errors_total"] \
            < SYM_CLI_WINDOWS \
            or runs["symbolize.kernel"]["faults_fired"].get(
                "symbolize.kernel", 0) < SYM_CLI_WINDOWS:
        raise AssertionError(f"symbolize CLI runs: {runs}")
    emit("symbolize_cli", runs=runs)
    return {k: la[k] + lc[k] for k in la}


TRANSPORT_NODE = "chip-smoke"
TRANSPORT_LABELS = "cell=transport,path=main"
TRANSPORT_CLI_WINDOWS = 3
TRANSPORT_TICK_S = 0.5      # each recorded window's CPU-tick interval
TRANSPORT_RELABEL = ("relabel_configs:\n- action: labeldrop\n"
                     "  regex: kernel_release\n")


def transport_packages() -> dict:
    """grpc, yaml and cryptography as this host has them: each one's
    version, or "absent"."""
    import importlib

    out = {}
    for name in ("grpc", "yaml", "cryptography"):
        try:
            out[name] = getattr(importlib.import_module(name),
                                "__version__", "present")
        except ImportError:
            out[name] = "absent"
    return out


class ParcaStore:
    """An in-process Parca store: WriteRaw and the debuginfo upload
    conversation. With grpc, one gRPC server on 127.0.0.1 that takes
    requests up to the client's message cap (``client()`` a
    GRPCStoreClient to it); without, ``client()`` is this object, a
    StoreClient that runs each batch through the WriteRaw codec. Records
    each request's bytes and series, and the debuginfo uploads by build
    id."""

    def __init__(self, grpc=None):
        import threading

        from parca_agent_tpu_torch.agent.grpc_client import MAX_MSG_BYTES

        self._mu = threading.Lock()
        self.sizes: list[int] = []
        self.series: list = []
        self.uploads: dict = {}     # upload id -> build id, size, bytes
        self.finished: set = set()  # build ids marked finished
        self._grpc = grpc
        self.server = None
        if grpc is None:
            return
        from concurrent import futures

        from parca_agent_tpu_torch.agent import debuginfo_client as dbg
        from parca_agent_tpu_torch.agent.grpc_client import WRITE_RAW_METHOD

        def unary(fn):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=lambda b: b,
                response_serializer=lambda b: b)

        svc, method = WRITE_RAW_METHOD.lstrip("/").rsplit("/", 1)
        handlers = [grpc.method_handlers_generic_handler(svc, {
            method: unary(lambda req, ctx: self._take(req))})]
        name = dbg.SVC.lstrip("/")
        handlers.append(grpc.method_handlers_generic_handler(name, {
            dbg.SHOULD_INITIATE.rsplit("/", 1)[1]: unary(self._should),
            dbg.INITIATE.rsplit("/", 1)[1]: unary(self._initiate),
            dbg.UPLOAD.rsplit("/", 1)[1]: grpc.stream_unary_rpc_method_handler(
                self._upload, request_deserializer=lambda b: b,
                response_serializer=lambda b: b),
            dbg.MARK_FINISHED.rsplit("/", 1)[1]: unary(self._mark)}))
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[("grpc.max_receive_message_length", MAX_MSG_BYTES)])
        self.server.add_generic_rpc_handlers(handlers)
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def client(self):
        if self._grpc is None:
            return self
        from parca_agent_tpu_torch.agent.grpc_client import GRPCStoreClient

        return GRPCStoreClient(f"127.0.0.1:{self.port}", insecure=True)

    def write_raw(self, series, normalized) -> None:
        from parca_agent_tpu_torch.agent.profilestore import (
            encode_write_raw_request,
        )

        self._take(encode_write_raw_request(series, normalized))

    def _take(self, request: bytes) -> bytes:
        from parca_agent_tpu_torch.agent.profilestore import (
            decode_write_raw_request,
        )

        series, normalized = decode_write_raw_request(request)
        if not normalized:
            raise AssertionError("a WriteRaw request not normalized")
        with self._mu:
            self.sizes.append(len(request))
            self.series.extend(series)
        return b""

    @staticmethod
    def _fields(data: bytes) -> dict:
        from parca_agent_tpu_torch.pprof.proto import iter_fields

        return {f: v for f, _w, v in iter_fields(data)}

    def _should(self, request, context) -> bytes:
        from parca_agent_tpu_torch.pprof.proto import put_tag_varint

        build_id = self._fields(request)[1].decode()
        out = bytearray()
        with self._mu:
            put_tag_varint(out, 1, 0 if build_id in self.finished else 1)
        return bytes(out)

    def _initiate(self, request, context) -> bytes:
        from parca_agent_tpu_torch.pprof.proto import put_tag_bytes

        f = self._fields(request)
        build_id = f[1].decode()
        with self._mu:
            upload_id = f"up-{len(self.uploads)}"
            self.uploads[upload_id] = {"build_id": build_id,
                                       "size": f.get(2, 0), "bytes": 0}
        instr = bytearray()
        put_tag_bytes(instr, 1, build_id.encode())
        put_tag_bytes(instr, 2, upload_id.encode())
        out = bytearray()
        put_tag_bytes(out, 1, bytes(instr))
        return bytes(out)

    def _upload(self, request_iterator, context) -> bytes:
        upload_id = None
        for req in request_iterator:
            f = self._fields(req)
            if 1 in f:
                upload_id = self._fields(f[1])[2].decode()
            elif 2 in f:
                with self._mu:
                    self.uploads[upload_id]["bytes"] += len(f[2])
        return b""

    def _mark(self, request, context) -> bytes:
        f = self._fields(request)
        with self._mu:
            if self.uploads[f[2].decode()]["build_id"] != f[1].decode():
                raise AssertionError("an upload finished under another "
                                     "build id")
            self.finished.add(f[1].decode())
        return b""

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop(0)


class BatchSizes:
    """A StoreClient in front of another: records the bytes of each
    batch as one WriteRaw request (the original's client sends it so)."""

    def __init__(self, inner):
        self.inner = inner
        self.sizes: list[int] = []

    def write_raw(self, series, normalized) -> None:
        from parca_agent_tpu_torch.agent.profilestore import (
            encode_write_raw_request,
        )

        self.sizes.append(len(encode_write_raw_request(series, normalized)))
        self.inner.write_raw(series, normalized)


class Tap:
    """A write_raw sink in front of another: keeps each (labels, gzipped
    sample) and the time spent below it."""

    def __init__(self, inner):
        self.inner = inner
        self.samples: list = []
        self.s = 0.0

    def write_raw(self, labels, sample) -> None:
        self.samples.append((labels, sample))
        t0 = time.perf_counter()
        self.inner.write_raw(labels, sample)
        self.s += time.perf_counter() - t0


def transport_labels():
    """The CLI's label pipeline with --node, --metadata-external-labels
    and a relabel rule that drops kernel_release."""
    from parca_agent_tpu_torch import cli
    from parca_agent_tpu_torch.labels.manager import LabelsManager
    from parca_agent_tpu_torch.labels.relabel import RelabelConfig
    from parca_agent_tpu_torch.metadata import providers as mp

    return LabelsManager(
        [mp.ServiceDiscoveryProvider(), mp.ProcessProvider(),
         mp.CgroupProvider(), mp.SystemProvider(),
         mp.TargetProvider(node=TRANSPORT_NODE,
                           external=cli._parse_external_labels(
                               TRANSPORT_LABELS))],
        [RelabelConfig(action="labeldrop", regex="kernel_release")])


def check_arrivals(label: str, series, want: dict, labels: dict) -> int:
    """Raise unless every sample of the store's `series` is a pid's
    gzipped pprof equal to `want[pid]` under `labels[pid]`, and no pid's
    arrives twice. Returns the pids that arrived."""
    import gzip

    seen = set()
    for s in series:
        pid = int(s.labels["pid"])
        if s.labels != labels[pid]:
            raise AssertionError(f"{label}: pid {pid} under {s.labels}, "
                                 f"not {labels[pid]}")
        for blob in s.samples:
            if pid in seen:
                raise AssertionError(f"{label}: pid {pid} arrived twice")
            seen.add(pid)
            if gzip.decompress(blob) != want[pid]:
                raise AssertionError(f"{label}: pid {pid}'s profile "
                                     "differs from the encoder's bytes")
    return len(seen)


def ship_until_drained(label: str, batch) -> int:
    """Flush intervals until the buffer and the spool are empty; the
    flushes it took."""
    flushes = 0
    while batch.buffered()[1] or batch.replay_backlog()[0]:
        if flushes == 64:
            raise AssertionError(f"{label}: not drained in 64 flushes: "
                                 f"{batch.stats}")
        if not batch.flush():
            raise AssertionError(f"{label}: a flush failed: {batch.stats}")
        flushes += 1
    return flushes


def transport_window(blobs, grpc) -> dict:
    """Phase 13 (a): phase 4's steady window through the port's
    transport at the CLI's defaults, with a spool, then without one."""
    import tempfile

    from parca_agent_tpu_torch.agent.batch import BatchWriteClient
    from parca_agent_tpu_torch.agent.grpc_client import MAX_MSG_BYTES
    from parca_agent_tpu_torch.agent.listener import MatchingProfileListener
    from parca_agent_tpu_torch.agent.spool import SpoolDir
    from parca_agent_tpu_torch.agent.writer import RemoteProfileWriter
    from parca_agent_tpu_torch.runtime import trace as trace_mod

    want = dict(blobs)
    manager = transport_labels()
    t0 = time.perf_counter()
    labels = {pid: manager.label_set("parca_agent_cpu", pid)
              for pid in want}
    labels_ms = (time.perf_counter() - t0) * 1e3
    if any(v is None or "kernel_release" in v
           or v.get("node") != TRANSPORT_NODE for v in labels.values()):
        raise AssertionError("transport: labels not as asked")
    out = {"store": "grpc" if grpc is not None else
           "in-process StoreClient (no grpc)", "pids": len(want),
           "raw_bytes": sum(map(len, want.values())),
           "max_msg_bytes": MAX_MSG_BYTES, "labels_ms": labels_ms}
    recorder = trace_mod.FlightRecorder()
    trace_mod.install(recorder)
    store = ParcaStore(grpc)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            spool = SpoolDir(tmp)
            sized = BatchSizes(store.client())
            batch = BatchWriteClient(sized, spool=spool)  # the CLI's defaults
            tap = Tap(batch)
            writer = RemoteProfileWriter(MatchingProfileListener(tap))
            t0 = time.perf_counter()
            for pid, blob in blobs:
                writer.write(labels[pid], blob)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            flushes = ship_until_drained("transport", batch)
            ship_ms = (time.perf_counter() - t0) * 1e3
            spool_stats = dict(spool.stats)
        hist = recorder.export_histograms()
        arrived = check_arrivals("transport", store.series, want, labels)
    finally:
        trace_mod.install(None)
        store.stop()

    def stage(name):
        h = hist.get(name, {"sum_s": 0.0, "count": 0})
        return {"ms": h["sum_s"] * 1e3, "count": h["count"]}

    dropped = batch.stats["samples_dropped"] + spool_stats["samples_dropped"]
    out.update(
        gz_bytes=sum(len(s) for _, s in tap.samples),
        write_ms=write_s * 1e3, gzip_ms=(write_s - tap.s) * 1e3,
        sink_ms=tap.s * 1e3, flushes=flushes, ship_ms=ship_ms,
        requests=len(store.sizes), largest_request_bytes=max(store.sizes),
        batches=len(sized.sizes), largest_batch_bytes=max(sized.sizes),
        batches_over_cap=sum(n > MAX_MSG_BYTES for n in sized.sizes),
        arrived=arrived, overflow_spills=batch.stats["overflow_spills"],
        samples_dropped=dropped, stats=dict(batch.stats), spool=spool_stats,
        replay=stage("spool_replay"), spill=stage("spool_spill"),
        store_ack=stage("store_ack"), store_rpc=stage("store_rpc"))
    # Over gRPC every request must fit the channel's cap (without grpc
    # the in-process store takes a batch as one request, whatever its
    # size).
    if arrived != len(want) or dropped or (
            grpc is not None and max(store.sizes) > MAX_MSG_BYTES):
        raise AssertionError(f"transport: {out}")

    # The same window without a spool: what the defaults do at this width.
    store = ParcaStore(grpc)
    try:
        batch = BatchWriteClient(store.client())
        for lab, sample in tap.samples:
            batch.write_raw(lab, sample)
        flushes = ship_until_drained("transport without a spool", batch)
        arrived = check_arrivals("transport without a spool", store.series,
                                 want, labels)
    finally:
        store.stop()
    out["no_spool"] = {"flushes": flushes, "arrived": arrived,
                       "samples_dropped": batch.stats["samples_dropped"],
                       "bytes_dropped": batch.stats["bytes_dropped"],
                       "overflow_spills": batch.stats["overflow_spills"]}
    if arrived + batch.stats["samples_dropped"] != len(want):
        raise AssertionError(f"transport without a spool: {out['no_spool']}")
    return out


def burner_windows(pid: int, tmp: Path) -> list[str]:
    """TRANSPORT_CLI_WINDOWS procfs windows of process `pid` on this host
    (its CPU ticks over TRANSPORT_TICK_S each, a depth-1 stack at its
    entry point, its real maps), each with its mapping table rebuilt
    with the mapped objects' build ids (procfs tables carry none, in
    both packages, so their objects are never uploaded), saved as
    snapshot files. Returns their paths."""
    import dataclasses

    from parca_agent_tpu_torch.capture.formats import save_snapshot
    from parca_agent_tpu_torch.capture.live import mapping_table_for_pids
    from parca_agent_tpu_torch.capture.procfs import ProcfsSampler
    from parca_agent_tpu_torch.process.objectfile import ObjectFileCache

    sampler = ProcfsSampler(window_s=TRANSPORT_TICK_S)
    table = mapping_table_for_pids(sampler._maps, ObjectFileCache(), [pid])
    if not any(table.obj_buildids):
        raise AssertionError(f"transport CLI: no build id in {table}")
    paths = []
    for w in range(TRANSPORT_CLI_WINDOWS):
        t0 = sampler.sample_ticks().get(pid, 0)
        time.sleep(TRANSPORT_TICK_S)
        ticks = sampler.sample_ticks().get(pid, 0) - t0
        snap = sampler.collect({pid: max(1, ticks)})
        if not len(snap):
            raise AssertionError(f"transport CLI: no row for pid {pid}")
        path = tmp / f"window-{w}.snap"
        save_snapshot(dataclasses.replace(snap, mappings=table), str(path))
        paths.append(str(path))
    return paths


def transport_cli(dev, grpc, with_yaml: bool) -> dict:
    """Phase 13 (b): the port's CLI in this process on the card,
    --aggregator dict --fast-encode, replaying windows recorded here of
    a CPU-burning child (burner_windows), shipping to an in-process store
    whose debuginfo service takes the child's objects. Returns the run's
    record and its launches."""
    import contextlib
    import gzip
    import io
    import tempfile

    from parca_agent_tpu_torch import cli
    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    store = ParcaStore(grpc)
    burner = subprocess.Popen([sys.executable, "-c", BURNER])
    out = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            replay = burner_windows(burner.pid, Path(tmp))
            record_s = time.perf_counter() - t0
            flags = [*NO_PROBE, *HTTP_ANY, "--capture", "replay",
                     "--replay", *replay,
                     "--aggregator", "dict",
                     "--fast-encode", "--windows", str(TRANSPORT_CLI_WINDOWS),
                     "--profiling-duration", str(TRANSPORT_TICK_S),
                     "--remote-store-address", f"127.0.0.1:{store.port}",
                     "--remote-store-insecure",
                     "--remote-store-batch-write-interval", "1",
                     "--node", TRANSPORT_NODE,
                     "--metadata-external-labels", TRANSPORT_LABELS]
            if with_yaml:
                cfg = Path(tmp) / "relabel.yaml"
                cfg.write_text(TRANSPORT_RELABEL)
                flags += ["--config-path", str(cfg)]
            # Every count to 0 just before the path; read just after.
            probe.reset_launches()
            close.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.run(flags)
            cli_s = time.perf_counter() - t0
            launches = {k: n for k, n in (
                ("feed_accumulate", probe.LAUNCHES["feed_accumulate"]),
                ("close_pack", close.LAUNCHES["close_pack"]),
                ("close_pack_delta", close.LAUNCHES["close_pack_delta"]))
                if n}
    finally:
        burner.kill()
        burner.wait()
        store.stop()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    windows = [ln for ln in lines if "window" in ln]
    runtime = [ln["runtime"] for ln in lines if "runtime" in ln]
    cli_runtime_clean("transport CLI", runtime)
    mass, pids = 0, set()
    for s in store.series:
        if s.labels.get("node") != TRANSPORT_NODE \
                or s.labels.get("cell") != "transport" \
                or (with_yaml and "kernel_release" in s.labels):
            raise AssertionError(f"transport CLI: labels {s.labels}")
        pids.add(int(s.labels["pid"]))
        for blob in s.samples:
            mass += sum(v[0] for _, v, _ in
                        parse_pprof(gzip.decompress(blob)).samples)
    t = runtime[0]["transport"]
    uploads = {u["build_id"]: u for u in store.uploads.values()}
    rec = {"rc": rc, "record_s": record_s, "s": cli_s,
           "windows": len(windows),
           "window_mass": [ln["mass"] for ln in windows], "mass": mass,
           "samples": sum(len(s.samples) for s in store.series),
           "profiles": sum(ln["profiles"] for ln in windows),
           "pids": len(pids), "burner_in_store": burner.pid in pids,
           "requests": len(store.sizes), "relabel": with_yaml,
           "launches": launches, "transport": t,
           "debuginfo": {"initiated": len(uploads),
                         "finished": len(store.finished),
                         "bytes": sum(u["bytes"] for u in uploads.values())}}
    if rc != 0 or len(windows) != TRANSPORT_CLI_WINDOWS or mass <= 0 \
            or mass != sum(ln["mass"] for ln in windows) \
            or rec["samples"] != rec["profiles"] \
            or not rec["burner_in_store"] \
            or t["parca_agent_remote_write_errors_total"] \
            or t["parca_agent_remote_write_samples_dropped"] \
            or not uploads or set(uploads) != store.finished \
            or any(u["bytes"] != u["size"] for u in uploads.values()):
        raise AssertionError(f"transport CLI: {rec}, {lines}, "
                             f"{store.uploads}")
    return rec


def phase_transport(dev, blobs) -> dict:
    """Phase 13 (module docs). Returns the launches of its CLI run ({}
    when grpc does not import here)."""
    packages = transport_packages()
    print("transport packages: " + json.dumps(packages), flush=True)
    try:
        import grpc
    except ImportError:
        grpc = None
    emit("transport_window", packages=packages,
         **transport_window(blobs, grpc))
    if grpc is None:
        emit("transport_cli", run=False,
             reason="grpc does not import on this host")
        return {}
    rec = transport_cli(dev, grpc, packages["yaml"] != "absent")
    emit("transport_cli", run=True, **rec)
    if rec["launches"].get("feed_accumulate", 0) < 1 \
            or rec["launches"].get("close_pack", 0) \
            + rec["launches"].get("close_pack_delta", 0) < 1:
        raise AssertionError(f"the transport CLI launched "
                             f"{rec['launches']}")
    return rec["launches"]


# -- phase 14: the agent shell ------------------------------------------------

SHELL_WINDOWS = 3
SHELL_ROWS = 1 << 17        # a window's rows (the bench window's 2^20, cut)
SHELL_PERIOD_S = 1.0
SHELL_WAIT_S = 240.0        # bound of the hook's wait for the window lines
# The shift a later window carries: 16 stacks whose leaf is in the
# synthetic layout's first shared object (one binary), SHELL_HOT_BOOST
# samples more each a window.
SHELL_HOT_ROWS = 16
SHELL_HOT_BOOST = 5_000
SHIFT_LO = 0x0000_7F00_0000_0000
SHIFT_HI = SHIFT_LO + (1 << 24)
SHELL_QUOTA_SAMPLES = 100_000
SHELL_QUOTA_PIDS = 10_000
SHELL_FAMILIES = ("parca_agent_hotspot_windows_folded_total",
                  "parca_agent_regression_windows_folded_total",
                  "parca_agent_regression_verdicts_total",
                  "parca_agent_admission_over_quota_windows_total",
                  "parca_agent_tenant_window_samples",
                  "parca_agent_sink_windows_total")

_PROM_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_PROM_VALUE = re.compile(
    r"^(?:[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?|NaN|\+Inf|-Inf)$")
_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")


def _prom_labels(s: str) -> dict:
    """The inside of a {...} label set, with its \\\\, \\" and \\n
    escapes; raises on any syntax violation."""
    labels: dict[str, str] = {}
    i = 0
    while i < len(s):
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', s[i:])
        if not m or m.group(1) in labels:
            raise AssertionError(f"bad label at {s[i:]!r}")
        i += m.end()
        val = []
        while True:
            if i >= len(s) or s[i] == "\n":
                raise AssertionError(f"unterminated label value in {s!r}")
            if s[i] == "\\":
                if s[i + 1:i + 2] not in ('\\', '"', "n"):
                    raise AssertionError(f"bad escape in {s!r}")
                val.append({"\\": "\\", '"': '"', "n": "\n"}[s[i + 1]])
                i += 2
            elif s[i] == '"':
                i += 1
                break
            else:
                val.append(s[i])
                i += 1
        labels[m.group(1)] = "".join(val)
        if i < len(s):
            if s[i] != ",":
                raise AssertionError(f"expected ',' at {s[i:]!r}")
            i += 1
    return labels


def parse_prometheus_text(text: str) -> dict:
    """The strict Prometheus text-format parser of
    tests/test_metrics_format.py (which imports the JAX package, so it
    is copied here): names, label syntax and escapes, a `# TYPE` line
    before each family's samples, families contiguous, no duplicate
    series, and each histogram's buckets sorted and cumulative with
    le="+Inf" equal to _count and a _sum. Returns {family: {"type": t,
    "samples": [(name, labels, value)]}}."""
    if not text.endswith("\n"):
        raise AssertionError("exposition must end with a newline")
    fams: dict[str, dict] = {}
    current = None
    seen = set()
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4 or not _PROM_NAME.match(parts[2]) \
                        or parts[3] not in ("counter", "gauge", "histogram",
                                            "summary", "untyped") \
                        or parts[2] in fams:
                    raise AssertionError(f"line {n}: bad TYPE {line!r}")
                fams[parts[2]] = {"type": parts[3], "samples": []}
                current = parts[2]
            continue
        m = _PROM_SAMPLE.match(line)
        if not m or not _PROM_VALUE.match(m.group(3)):
            raise AssertionError(f"line {n}: bad sample {line!r}")
        name = fam = m.group(1)
        labels = _prom_labels(m.group(2)) if m.group(2) else {}
        if fam not in fams:
            for suffix in ("_bucket", "_sum", "_count"):
                base = name.removesuffix(suffix)
                if name.endswith(suffix) and base in fams \
                        and fams[base]["type"] == "histogram":
                    fam = base
                    break
        key = (name, tuple(sorted(labels.items())))
        if fam != current or key in seen:
            raise AssertionError(f"line {n}: {name} outside its family's "
                                 "block, before its TYPE, or repeated")
        seen.add(key)
        fams[fam]["samples"].append((name, labels, float(m.group(3))))
    for fam, data in fams.items():
        if data["type"] != "histogram":
            continue
        series: dict = {}
        for name, labels, value in data["samples"]:
            s = series.setdefault(tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le")),
                {"buckets": [], "sum": None, "count": None})
            if name == fam + "_bucket":
                s["buckets"].append((float(labels["le"].replace(
                    "+Inf", "inf")), value))
            elif name == fam + "_sum":
                s["sum"] = value
            elif name == fam + "_count":
                s["count"] = value
        for rest, s in series.items():
            les = [le for le, _ in s["buckets"]]
            counts = [c for _, c in s["buckets"]]
            if not les or les != sorted(les) or les[-1] != float("inf") \
                    or counts != sorted(counts) or s["sum"] is None \
                    or counts[-1] != s["count"]:
                raise AssertionError(f"{fam}{dict(rest)}: bad histogram")
    return fams


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shell_windows(tmp: Path, pids: int, rows: int, base=None) -> tuple:
    """SHELL_WINDOWS replay files of `rows` rows: every (len(base) //
    rows)-th row of `base` (phase 4's bench window), or without it a
    window of the bench spec at `pids` pids and `rows` rows (its samples
    scaled with the rows). The first window's stacks and counts in every
    window, but for the shift: window w's SHELL_HOT_ROWS hot stacks (user
    stacks whose leaf is in one binary, the heaviest pid's first) carry
    w * SHELL_HOT_BOOST samples more (later windows are steady ones, and
    the regression sentinel judges window 1 against window 0's
    baseline). Returns their paths, the heaviest pid holding a hot stack
    (its mass tells its windows apart), its mass in each, the hot
    stacks' 64-bit content hashes ("0x%016x") and the windows' summed
    exact counts by content hash (sorted keys, counts)."""
    import dataclasses

    import numpy as np

    from parca_agent_tpu_torch.capture.formats import save_snapshot
    from parca_agent_tpu_torch.capture.synthetic import (
        SyntheticSpec,
        generate,
    )

    if base is not None:
        snap = window_rows(base, np.arange(rows) * (len(base) // rows))
    else:
        snap = generate(SyntheticSpec(
            n_pids=pids, n_unique_stacks=rows, n_rows=rows,
            total_samples=max(SAMPLES * rows // ROWS, rows + 1),
            mean_depth=24, kernel_fraction=0.2, seed=42))
    from parca_agent_tpu_torch.ops.hashing import row_hash_np

    # The hot stacks' candidates: user stacks whose leaf is in the one
    # binary. The queried pid: the heaviest pid holding one of them (its
    # mass tells the windows apart).
    leaf = snap.stacks[:, 0]
    cand = np.flatnonzero((snap.kernel_len == 0) & (leaf >= SHIFT_LO)
                          & (leaf < SHIFT_HI))
    uniq, inv = np.unique(snap.pids, return_inverse=True)
    mass = np.bincount(inv, weights=snap.counts)
    holders = np.isin(uniq, snap.pids[cand])
    pid = int(uniq[np.flatnonzero(holders)[mass[holders].argmax()]])
    hot = np.concatenate([cand[snap.pids[cand] == pid],
                          cand[snap.pids[cand] != pid]])[:SHELL_HOT_ROWS]
    if len(hot) < SHELL_HOT_ROWS:
        raise AssertionError(f"shell windows: {len(hot)} hot rows")
    h1, h2 = row_hash_np(snap.stacks, snap.pids, snap.user_len,
                         snap.kernel_len, n_hashes=2)
    key = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
    hot_stacks = sorted(f"0x{int(k):016x}" for k in key[hot])
    # The windows' exact (h1 << 32 | h2) -> count, summed over them.
    total = snap.counts.astype(np.int64) * SHELL_WINDOWS
    total[hot] += SHELL_HOT_BOOST * sum(range(SHELL_WINDOWS))
    uniq, kinv = np.unique(key, return_inverse=True)
    oracle = uniq, np.bincount(kinv, weights=total.astype(np.float64)
                               ).astype(np.int64)
    paths, masses = [], []
    for w in range(SHELL_WINDOWS):
        counts = snap.counts.copy()
        counts[hot] += w * SHELL_HOT_BOOST
        win = snap if w == 0 else dataclasses.replace(
            snap, counts=counts,
            time_ns=snap.time_ns + w * int(SHELL_PERIOD_S * 1e9))
        paths.append(str(tmp / f"shell-{w}.snap"))
        save_snapshot(win, paths[-1])
        masses.append(int(win.counts[win.pids == pid].sum()))
    return paths, pid, masses, hot_stacks, oracle


def http_get(url: str, timeout: float = 120.0):
    """(status, body, headers, ms) of one GET."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body, status, headers = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        body, status, headers = e.read(), e.code, e.headers
    return status, body, headers, (time.perf_counter() - t0) * 1e3


def shell_cli(replay_windows, device_flags, workdir: Path) -> dict:
    """Phase 14's run (module docs): the port's CLI in this process,
    replaying `replay_windows` (shell_windows' paths, pid, masses and
    hot stacks) with discovery, the analytics (their files under
    `workdir`) and the HTTP server on a port picked here, scraped from a
    hook in the capture source's poll before the last window and from
    another once the source is exhausted (the loop waits there; the
    server answers from its own threads). Returns the run's record, its
    launches included."""
    import contextlib
    import gzip
    import io
    import threading

    from parca_agent_tpu_torch import __version__, cli
    from parca_agent_tpu_torch.aggregator import close, probe
    from parca_agent_tpu_torch.capture import replay as replay_mod
    from parca_agent_tpu_torch.pprof.builder import parse_pprof

    replay, query_pid, masses, hot_stacks, oracle = replay_windows
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    out = io.StringIO()
    scrapes: dict = {}
    managers = []

    def window_lines():
        return [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith('{"window"')]

    def query():
        scrapes["/query"] = http_get(f"{url}/query?pid={query_pid}"
                                     "&timeout=60")

    def hook():
        try:
            scrape()
        except Exception as e:  # noqa: BLE001 - reported after the run
            scrapes["hook_error"] = repr(e)

    def scrape():
        # Every window taken so far has printed its line (the encode
        # worker prints a pipelined one after its profiles are written),
        # so the loop's counters must be the lines'.
        deadline = time.monotonic() + SHELL_WAIT_S
        while len(window_lines()) < SHELL_WINDOWS - 1:
            if time.monotonic() > deadline:
                raise AssertionError("shell CLI: the window lines did not "
                                     f"come in {SHELL_WAIT_S} s")
            time.sleep(0.05)
        scrapes["lines"] = window_lines()
        # /query waits for pid query_pid's next profile: the last
        # window's, which runs once this hook returns.
        scrapes["query_thread"] = threading.Thread(target=query)
        scrapes["query_thread"].start()
        for path in ("/metrics", "/", "/healthy", "/healthz",
                     "/debug/windows", "/debug/device",
                     "/debug/trace/1000000", "/debug/pprof/cmdline",
                     "/debug/pprof/profile?seconds=1",
                     "/debug/pprof/heap?seconds=1", "/hotspots", "/diff"):
            scrapes[path] = http_get(url + path)
        traces = json.loads(scrapes["/debug/windows"][1])["traces"]
        scrapes["seq"] = traces[-1]["seq"] if traces else None
        scrapes["/debug/trace/<seq>"] = http_get(
            f"{url}/debug/trace/{scrapes['seq']}")

    def folded(n: int) -> dict:
        # The encode worker has folded n windows (each window's rollup
        # runs after its ship): the next one is then handed to an idle
        # worker, so every window is folded and judged (a window the
        # worker refuses is encoded inline, and not rolled up).
        deadline = time.monotonic() + SHELL_WAIT_S
        while True:
            fams = parse_prometheus_text(
                http_get(url + "/metrics")[1].decode())
            got = fams["parca_agent_regression_windows_folded_total"][
                "samples"][0][2]
            if got >= n:
                return fams
            if time.monotonic() > deadline:
                raise AssertionError(f"shell CLI: {got} windows folded "
                                     f"in {SHELL_WAIT_S} s, want {n}")
            time.sleep(0.05)

    def judged():
        # Once the source is exhausted: the last window's fold (the
        # sentinel judges window 1 there) has run on the worker.
        scrapes["final_metrics"] = folded(SHELL_WINDOWS)
        for path in ("/diff", "/hotspots?k=50"):
            scrapes["final " + path] = http_get(url + path)

    class Scraped(replay_mod.ReplaySource):
        def poll(self):
            try:
                if 1 <= self._pos < SHELL_WINDOWS:
                    folded(self._pos)
                if self._pos == SHELL_WINDOWS - 1:
                    hook()
                if self._pos == SHELL_WINDOWS and "judged" not in scrapes:
                    scrapes["judged"] = True
                    judged()
            except Exception as e:  # noqa: BLE001 - reported after the run
                scrapes.setdefault("hook_error", repr(e))
            return super().poll()

    real_replay, real_discovery = replay_mod.ReplaySource, \
        cli.discovery_manager

    def discovery_manager(args):
        got = real_discovery(args)
        managers.append(got[0])
        return got

    t_phase = time.perf_counter()
    try:
        replay_mod.ReplaySource = Scraped
        cli.discovery_manager = discovery_manager
        flags = [*NO_PROBE, *device_flags, "--capture", "replay",
                 "--replay", *replay, "--aggregator", "dict",
                 # One poll past the last window: the final scrape.
                 "--fast-encode", "--windows", str(SHELL_WINDOWS + 1),
                 "--profiling-duration", str(SHELL_PERIOD_S),
                 "--http-address", f"127.0.0.1:{port}",
                 "--enable-cgroup-discovery",
                 "--enable-systemd-discovery", "--log-level", "debug",
                 "--hotspots", "--regression", "--regression-interval",
                 str(SHELL_PERIOD_S), "--regression-baseline-windows", "1",
                 "--sink", "pprof,autofdo,series,alerts", "--autofdo-dir",
                 str(workdir / "afdo"), "--alerts-path",
                 str(workdir / "alerts.jsonl"), "--tenant-quota-samples",
                 str(SHELL_QUOTA_SAMPLES), "--tenant-quota-pids",
                 str(SHELL_QUOTA_PIDS)]
        err = io.StringIO()
        # Every count to 0 just before the path; read just after.
        probe.reset_launches()
        close.reset_launches()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.run(flags)
        launches = {k: n for k, n in (
            ("feed_accumulate", probe.LAUNCHES["feed_accumulate"]),
            ("close_pack", close.LAUNCHES["close_pack"]),
            ("close_pack_delta", close.LAUNCHES["close_pack_delta"]))
            if n}
        if "query_thread" in scrapes:
            scrapes.pop("query_thread").join(timeout=120)
    finally:
        replay_mod.ReplaySource = real_replay
        cli.discovery_manager = real_discovery
    phase_s = time.perf_counter() - t_phase
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    windows = [ln for ln in lines if "window" in ln]
    runtime = [ln["runtime"] for ln in lines if "runtime" in ln]
    status = {k: v[0] for k, v in scrapes.items()
              if isinstance(v, tuple)}
    # Where the windows' time went: each window's line and the flight
    # recorder's stage maxima (ms).
    stages = {k: v["max_ms"] for k, v in runtime[-1]["trace"][
        "stage_percentiles"].items()} if runtime else None
    diag = {"windows": [{k: ln.get(k) for k in (
        "window", "profiles", "aggregate_ms", "encode_path", "encode_ms",
        "handoff_ms", "window_ms")} for ln in windows],
        "stage_max_ms": stages,
        "supervisor": runtime[-1]["supervisor"] if runtime else None}
    want = {"/metrics": 200, "/": 200, "/healthy": 200, "/healthz": 200,
            "/debug/windows": 200, "/debug/device": 200,
            "/debug/trace/1000000": 404, "/debug/trace/<seq>": 200,
            "/debug/pprof/cmdline": 200,
            "/debug/pprof/profile?seconds=1": 200,
            "/debug/pprof/heap?seconds=1": 200, "/hotspots": 200,
            "/diff": 200, "/query": 200, "final /diff": 200,
            "final /hotspots?k=50": 200}
    problems = [f"{k}: {status.get(k)} (want {v})" for k, v in want.items()
                if status.get(k) != v]
    if "hook_error" in scrapes:
        problems.append(scrapes["hook_error"])
    rec = {"rc": rc, "cli_s": phase_s, "windows": len(windows),
           "launches": launches, "status": status, **diag}
    if problems or rc != 0 or len(runtime) != 1:
        raise AssertionError(f"shell CLI: rc {rc}, {problems}, {diag}, "
                             f"{err.getvalue()[-3000:]}")
    cli_runtime_clean("shell CLI", runtime)
    # /metrics: strict, the loop's counters those of the lines printed by
    # then, the stage histogram present.
    fams = parse_prometheus_text(scrapes["/metrics"][1].decode())
    seen_lines = scrapes["lines"]

    def value(name):
        return fams[name]["samples"][0][2]

    rec["metrics"] = {
        "families": len(fams), "bytes": len(scrapes["/metrics"][1]),
        "attempts": value("parca_agent_profiler_attempts_total"),
        "profiles_written":
            value("parca_agent_profiler_profiles_written_total"),
        "lines": len(seen_lines),
        "line_profiles": sum(ln["profiles"] for ln in seen_lines)}
    if rec["metrics"]["attempts"] != len(seen_lines) \
            or rec["metrics"]["profiles_written"] \
            != rec["metrics"]["line_profiles"] \
            or fams.get("parca_agent_window_stage_duration_seconds",
                        {}).get("type") != "histogram":
        raise AssertionError(f"shell CLI: /metrics {rec['metrics']}")
    page = scrapes["/"][1].decode()
    healthz = json.loads(scrapes["/healthz"][1])
    if f"parca-agent-tpu ({__version__}" not in page \
            or "discovery" not in healthz["actors"] \
            or not scrapes["seq"]:
        raise AssertionError(f"shell CLI: status page {page[:200]!r}, "
                             f"actors {sorted(healthz['actors'])}, seq "
                             f"{scrapes['seq']}")
    # /query: the next profile written for that pid after the hook (the
    # second window's, if its ship was still going, else the third's):
    # its labels, and that window's mass of the pid.
    labels = json.loads(scrapes["/query"][2]["X-Profile-Labels"])["labels"]
    got = sum(v[0] for _, v, _ in parse_pprof(
        gzip.decompress(scrapes["/query"][1])).samples)
    rec["query"] = {"pid": query_pid, "mass": got, "window_masses": masses}
    if labels.get("pid") != str(query_pid) or got not in masses[1:]:
        raise AssertionError(f"shell CLI: /query labels {labels}, "
                             f"{rec['query']}")
    prof = parse_pprof(scrapes["/debug/pprof/profile?seconds=1"][1])
    threads = sorted({lbl["thread"] for _, _, lbl in prof.samples})
    heap = parse_pprof(scrapes["/debug/pprof/heap?seconds=1"][1])
    if "actor-profiler" not in threads or not heap.samples:
        raise AssertionError(f"shell CLI: self-profile threads {threads}, "
                             f"heap samples {len(heap.samples)}")
    rec["ms"] = {k: round(scrapes[k][3], 3) for k in (
        "/metrics", "/", "/healthz", "/query", "/debug/windows",
        "/debug/device", "/debug/pprof/profile?seconds=1",
        "/debug/pprof/heap?seconds=1")}
    rec["self_profile"] = {"threads": threads, "samples": len(prof.samples),
                           "bytes": len(scrapes[
                               "/debug/pprof/profile?seconds=1"][1])}
    groups = managers[0].groups() if managers else []
    rec["discovery"] = {
        "groups": {p: sum(g.source.startswith(p + "/") for g in groups)
                   for p in ("cgroup", "systemd")},
        "failed_updates": managers[0].failed_updates if managers else None,
        "healthz": healthz["actors"]["discovery"]["state"],
        "query_labels": sorted(labels)}
    if len(windows) != SHELL_WINDOWS:
        raise AssertionError(f"shell CLI: {len(windows)} window lines")
    rec["analytics"] = shell_analytics(scrapes, fams, workdir, hot_stacks,
                                       oracle)
    return rec


def shell_analytics(scrapes: dict, fams: dict, workdir: Path,
                    hot_stacks: list, oracle) -> dict:
    """Phase 14's analytics checks: /metrics carries the analytics'
    families; once every window is judged, /diff and the alerts file
    hold a regressed or new_hotspot verdict on the shifted stacks, every
    verdict of the one shifted build; /hotspots' heaviest stacks hold to
    the windows' exact counts (check_hotspots), in count order; the
    AutoFDO directory holds profdata. Returns what it measured."""
    missing = [f for f in SHELL_FAMILIES if f not in fams]
    if missing:
        raise AssertionError(f"shell CLI: /metrics lacks {missing}")
    diff = json.loads(scrapes["final /diff"][1])
    alerts_path = workdir / "alerts.jsonl"
    alerts = ([json.loads(ln) for ln in alerts_path.read_text().splitlines()]
              if alerts_path.exists() else [])

    def judged(verdicts, where):
        shifts = [v for v in verdicts
                  if v["kind"] in ("regressed", "new_hotspot")]
        builds = {v["build"] for v in verdicts}
        if not shifts or len(builds) != 1 \
                or builds & {"kernel", "unmapped"} \
                or any(v["stack"] not in hot_stacks for v in shifts):
            raise AssertionError(f"shell CLI: {where} verdicts {verdicts}")
        return {"verdicts": len(verdicts), "shifts": len(shifts),
                "kinds": sorted({v["kind"] for v in verdicts}),
                "build": builds.pop()}

    seen = judged(diff["verdicts"], "/diff")
    written = judged(alerts, "alerts file")
    key = [(v["kind"], v["build"], v["stack"]) for v in diff["verdicts"]]
    if sorted(key) != sorted((v["kind"], v["build"], v["stack"])
                             for v in alerts):
        raise AssertionError("shell CLI: the alerts file != /diff's verdicts")
    hot = json.loads(scrapes["final /hotspots?k=50"][1])
    counts = [e["count"] for e in hot["entries"]]
    if counts != sorted(counts, reverse=True) or hot["windows"] \
            != SHELL_WINDOWS:
        raise AssertionError(f"shell CLI: /hotspots {counts}, "
                             f"{hot['windows']} windows")
    top = check_hotspots("shell /hotspots", hot, *oracle)
    afdo = sorted((workdir / "afdo").glob("*.afdo.txt"))
    if not afdo:
        raise AssertionError("shell CLI: no AutoFDO profdata")
    final = scrapes["final_metrics"]

    def value(name):
        return final[name]["samples"][0][2]

    return {"diff": seen, "alerts": written,
            "hotspots": {"windows": hot["windows"], "level": hot["level"],
                         "top": top, "shifted_in_top": sum(
                             e["stack"] in hot_stacks
                             for e in hot["entries"])},
            "ms": {k: round(scrapes[k][3], 3) for k in (
                "/hotspots", "/diff", "final /diff",
                "final /hotspots?k=50")},
            "hotspot_fold_s": value("parca_agent_hotspot_last_fold_seconds"),
            "regression_fold_s": value(
                "parca_agent_regression_last_fold_seconds"),
            "over_quota_windows": value(
                "parca_agent_admission_over_quota_windows_total"),
            # The capture source waits for each fold (folded), so a busy
            # worker never refuses a window here: a refused window is
            # encoded inline, and neither rolled up nor judged.
            "encode_backpressure": value(
                "parca_agent_profiler_encode_backpressure_total"),
            "sink_windows_skipped": value(
                "parca_agent_sink_windows_skipped_total"),
            "regression_windows_skipped": value(
                "parca_agent_regression_windows_skipped_total"),
            "hotspot_windows_folded": value(
                "parca_agent_hotspot_windows_folded_total"),
            "autofdo": {"files": len(afdo),
                        "bytes": sum(f.stat().st_size for f in afdo)}}


def shell_child(tmp: str, device_flags: list) -> dict:
    """Phase 14's child process: shell_windows from the rows start_shell
    saved in `tmp`, then shell_cli. Returns its record."""
    from parca_agent_tpu_torch.capture.formats import load_snapshot

    t0 = time.perf_counter()
    base = load_snapshot(str(Path(tmp) / "rows.snap"))
    windows = shell_windows(Path(tmp), PIDS, len(base), base=base)
    setup_s = time.perf_counter() - t0
    return {**shell_cli(windows, device_flags, Path(tmp)),
            "windows_setup_s": setup_s}


def start_shell(snap, device_flags=()):
    """Start phase 14 in a child process beside the phases that follow
    (its CLI is host-bound: the overlap keeps the run inside its time
    limit), on every 8th row of phase 4's window `snap` (saved here for
    the child), the CLI's device flags `device_flags` (none: the card).
    Returns what phase_shell waits for."""
    import tempfile

    import numpy as np

    from parca_agent_tpu_torch.capture.formats import save_snapshot

    tmp = tempfile.mkdtemp(prefix="chip-smoke-shell-")
    stride = len(snap) // SHELL_ROWS
    save_snapshot(window_rows(snap, np.arange(SHELL_ROWS) * stride),
                  str(Path(tmp) / "rows.snap"))
    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            f"sys.path.insert(0, {str(HERE)!r})\n"
            "import chip_smoke\n"
            "rec = chip_smoke.shell_child(*map(json.loads, sys.argv[1:]))\n"
            "rec['child_s'] = time.perf_counter() - t0\n"
            "print(json.dumps(rec), flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(tmp),
         json.dumps(list(device_flags))], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # A failed phase before phase_shell must not leave the child running.
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, tmp


def phase_shell(started) -> dict:
    """Phase 14 (module docs): waits for start_shell's child (killed past
    900 s), emits its record. Returns the launches of its CLI run."""
    import shutil

    proc, tmp = started
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"shell child: rc {proc.returncode}: "
                             f"{err[-4000:]}")
    rec = json.loads(lines[-1])
    rec.update(pids=PIDS, rows=SHELL_ROWS)
    emit("shell", **rec)
    if rec["launches"].get("feed_accumulate", 0) < 1 \
            or rec["launches"].get("close_pack", 0) \
            + rec["launches"].get("close_pack_delta", 0) < 1:
        raise AssertionError(f"the shell CLI launched {rec['launches']}")
    return rec["launches"]


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
    ap.add_argument("--close-reference", metavar="CLOSE_PACK_CU",
                    action="append", default=[],
                    help="another source with csrc/close_pack.cu's C "
                         "interface, built, held against the plain versions "
                         "and timed in turns with the close kernels (may be "
                         "given more than once)")
    ap.add_argument("--b7-reference", metavar="SHARDED_FEED_CU",
                    help="a source with the two-stage B7-feed's C interface "
                         "(a kernel over a host partition), built, held "
                         "against the one-launch feed and timed in turns "
                         "with it at phase 8's steady drain")
    ap.add_argument("--fleet-reference", metavar="FLEET_MERGE_CU",
                    help="a source with the segment pass's C interface "
                         "(pa_fleet_segment over rows sorted by torch.sort), "
                         "built, held against fleet_group and timed in "
                         "turns with it at phase 9's stream")
    ap.add_argument("--sketch-reference", metavar="SKETCH_BUILD_CU",
                    help="a source with csrc/sketch_build.cu's pa_sketch_build, "
                         "built, held against the cluster kernel and timed "
                         "in turns with it at phase 9's stream")
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
    close_refs = {Path(path).stem: load_close_reference(path)
                  for path in opts.close_reference}
    if close_refs:
        emit("close_reference", sources=opts.close_reference)
    b7_ref = None
    if opts.b7_reference:
        b7_ref = load_b7_reference(opts.b7_reference)
        emit("b7_reference", source=opts.b7_reference)
    fleet_ref = sketch_ref = None
    if opts.fleet_reference:
        fleet_ref = load_fleet_reference(opts.fleet_reference)
        emit("fleet_reference", source=opts.fleet_reference)
    if opts.sketch_reference:
        sketch_ref = load_reference("sketch_build", opts.sketch_reference)
        emit("sketch_reference", source=opts.sketch_reference)
    phases_s = {"identity_and_build": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases_s[name] = time.perf_counter() - t0
        return out

    rows = timed("kernels", phase_kernels, dev, ref)
    timed("close_kernels", phase_close_kernels, dev, close_refs)
    # Phases 5's and 11's subprocess CLIs run beside the host work that
    # follows (start_background).
    background = timed("background_start", start_background)
    snap, want = timed("main_path_setup", window_setup)
    # Phase 14 runs in a child beside phases 4-13 (start_shell).
    shell = timed("shell_start", start_shell, snap)
    vec_rec = VecRecorder()
    launches, state, hashes, steady_blobs = timed(
        "main_path", phase_main_path, dev, snap, want, STEADY_WINDOWS, ref,
        vec_rec)
    rows.update(timed("one_shot", phase_one_shot, dev, snap, want,
                      background["fast_encode"], rh_refs))
    bounded, launches_cm = timed("bounded", phase_bounded, dev, snap, hashes,
                                 state, close_refs)
    rows.update(bounded)
    launches_stream, dict_agg = timed("streaming", phase_streaming, dev,
                                      snap, want)
    sharded_rows, launches_sharded, launches_admission = timed(
        "sharded", phase_sharded, dev, snap, want, hashes, b7_ref)
    rows.update(sharded_rows)
    fleet_rows, launches_fleet, launches_fleet_hotspots = timed(
        "fleet", phase_fleet, dev, snap, hashes, sketch_ref, fleet_ref)
    rows.update(fleet_rows)
    launches_live = timed("live", phase_live, dev, snap, hashes, vec_rec)
    launches_runtime = timed("runtime", phase_runtime, dev, snap, want,
                             state, hashes, background["hang"])
    del state
    launches_sym = timed("symbolize", phase_symbolize, dev, snap, dict_agg)
    del dict_agg
    launches_transport = timed("transport", phase_transport, dev,
                               steady_blobs)
    del steady_blobs
    launches_shell = timed("shell", phase_shell, shell)
    # Each path's own launches, counted from 0 just before it: the
    # dictionary (phase 4), the one-shot aggregator (phase 5), the
    # bounded-memory dictionary (phase 6), the streaming window (phase 7),
    # the sharded dictionary (phase 8), the fleet merge (phase 9), the
    # CLI on the live machine (phase 10), the dictionary at bench.py's
    # option settings (phase 11), the scalar path's windows that phase
    # 12 symbolizes (the bench window on phase 7's dictionary, and the
    # walked DWARF window), the CLI that ships to a store (phase 13) and
    # the CLI that serves its HTTP surface (phase 14), and the
    # analytics' paths: phase 8's admission window, phase 9's merger
    # rounds feeding the fleet hotspot store.
    # `launches` is their sum.
    by_path = {"dict": launches,
               "one_shot": {k: rows[k]["launches"]
                            for k in ("row_hash", "loc_table")},
               "dict_cm": launches_cm,
               "streaming": launches_stream,
               "sharded": launches_sharded,
               "admission": launches_admission,
               "fleet": launches_fleet,
               "fleet_hotspots": launches_fleet_hotspots,
               "live": launches_live,
               "runtime": launches_runtime,
               "symbolize": {k: n for k, n in launches_sym.items() if n},
               "transport": launches_transport,
               "shell": launches_shell}
    for name, row in rows.items():
        row["launches_by_path"] = {path: n[name]
                                   for path, n in by_path.items()
                                   if name in n}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches_by_path"] \
                or min(row["launches_by_path"].values()) < 1:
            raise AssertionError(f"{name} never launched on a path of its: "
                                 f"{row['launches_by_path']}")
    emit("done", total_s=time.perf_counter() - t_start, phases_s=phases_s)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "launches_by_path", "max_abs_err",
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}
        for row in rows.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
