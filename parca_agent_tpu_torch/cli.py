"""Command line: ``python -m parca_agent_tpu_torch``.

Runs the profile-build loop of parca_agent_tpu's CLI for the subset this
package carries: a capture source (synthetic or replay) -> window
aggregation (the device-resident stack dictionary, fail-fast or in
bounded memory, whole or split into home sub-tables; the one-shot window
program; or the numpy CPUAggregator) -> per-pid pprof -> the local
store. With --fast-encode (dictionary aggregators only) the per-pid pprof
comes from the vectorized window encoder, on an encode worker thread
unless --no-encode-pipeline is given (profiler/cpu.py); with
--statics-snapshot-path the worker also keeps a warm statics snapshot,
which the next run adopts before its first window. Flag names are
those of parca_agent_tpu's CLI. The aggregation runs on the CUDA card
unless ``--device cpu`` is given; without a CUDA device the run stops
with an error that names the missing device.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parca-agent-tpu-torch",
        description="sampling CPU profiler agent: window aggregation on a "
                    "CUDA device with PyTorch")
    p.add_argument("--capture", default="synthetic",
                   choices=["synthetic", "replay"],
                   help="capture source: synthetic load, or replay of saved "
                        "snapshots (--replay)")
    p.add_argument("--replay", nargs="*", default=[],
                   help="snapshot files for --capture=replay")
    p.add_argument("--windows", type=int, default=0,
                   help="exit after N windows (0 = run until the source "
                        "ends; synthetic never ends)")
    p.add_argument("--profiling-duration", type=float, default=10.0,
                   help="aggregation window seconds")
    p.add_argument("--aggregator", default="dict",
                   choices=["dict", "dict+cm", "sharded", "tpu", "cpu"],
                   help="dict = stack dictionary resident on the device "
                        "(fails fast at capacity); dict+cm = the same "
                        "dictionary in bounded memory (overflow degrades "
                        "to a count-min sketch, cold stacks rotate out); "
                        "sharded = dict+cm with the table and probe work "
                        "split into one home sub-table per CUDA device "
                        "(a power-of-two count; 1 on the CPU); "
                        "tpu = one-shot window program on the device (the "
                        "name of parca_agent_tpu's batch aggregator); cpu "
                        "= numpy aggregation on the host")
    p.add_argument("--aggregator-capacity", type=int, default=1 << 21,
                   help="dict table slots (power of two); dict+cm keeps "
                        "memory bounded at this size under stack churn")
    p.add_argument("--fast-encode", action="store_true",
                   help="dict aggregators only: serialize windows with the "
                        "vectorized template encoder and ship profiles "
                        "unsymbolized (the server symbolizes, as with the "
                        "reference agent); disables local symbolization")
    p.add_argument("--no-encode-pipeline", action="store_true",
                   help="disable the background encode pipeline (with "
                        "--fast-encode the default hands each closed "
                        "window to a dedicated encoder thread, so capture "
                        "of window N+1 overlaps encoding/shipping of "
                        "window N; if the encoder is still busy at the "
                        "next close, that window waits for it and is "
                        "encoded inline, and a backpressure counter "
                        "increments)")
    p.add_argument("--statics-cache-bytes", type=int, default=256 << 20,
                   help="byte cap of the encoder's content-addressed "
                        "statics cache (digest of build inputs -> built "
                        "bytes; rotation/restart rebuilds become lookups "
                        "and identical-layout pids share one blob)")
    p.add_argument("--statics-snapshot-path", default="",
                   help="file for the warm pprof-statics + registry "
                        "snapshot (requires --fast-encode): the encode "
                        "worker rewrites it every "
                        "--statics-snapshot-interval windows "
                        "(CRC-framed, tmp+rename crash-safe) and a "
                        "restart adopts it — statics warm-build instead "
                        "of the cold rebuild; stale/corrupt records are "
                        "individually discarded. Empty disables")
    p.add_argument("--statics-snapshot-interval", type=int, default=6,
                   help="windows between statics snapshots (each write is "
                        "one atomic file replace on the encode worker)")
    p.add_argument("--statics-snapshot-max-age", type=float, default=900.0,
                   help="snapshots older than this many seconds are STALE "
                        "at adoption (the processes they describe are "
                        "likely gone); 0 = no age bar")
    p.add_argument("--local-store-directory", default="",
                   help="write each window's per-pid profiles here as "
                        ".pb.gz")
    p.add_argument("--device", default="cuda",
                   help="torch device of the aggregation: cuda (default) "
                        "or cpu")
    return p


class SyntheticSource:
    """One generated window per poll, seeded by the window number (the
    synthetic source of parca_agent_tpu's CLI)."""

    def __init__(self, windows: int):
        self._windows = windows
        self._n = 0

    def poll(self):
        from parca_agent_tpu_torch.capture.synthetic import (
            SyntheticSpec,
            generate,
        )

        if self._windows and self._n >= self._windows:
            return None
        self._n += 1
        return generate(SyntheticSpec(seed=self._n))


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.profiling_duration <= 0:
        raise SystemExit("--profiling-duration must be > 0")
    if args.fast_encode and args.aggregator not in ("dict", "dict+cm",
                                                    "sharded"):
        raise SystemExit(
            "--fast-encode requires --aggregator dict/dict+cm/sharded")

    from parca_agent_tpu_torch.agent.writer import FileProfileWriter
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.aggregator.tpu import TPUAggregator
    from parca_agent_tpu_torch.capture.formats import (
        WindowSnapshot,
        load_snapshot,
    )
    from parca_agent_tpu_torch.pprof.builder import build_pprof
    from parca_agent_tpu_torch.profiler.cpu import labels_for
    from parca_agent_tpu_torch.utils.device import resolve_device
    from parca_agent_tpu_torch.utils.window_clock import windows_for

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"parca-agent-tpu-torch: {e}", file=sys.stderr)
        return 2

    if args.capture == "replay":
        from parca_agent_tpu_torch.capture.replay import ReplaySource

        if not args.replay:
            raise SystemExit("--capture replay needs --replay FILE...")
        # The first window is read here: its period is the run's.
        first = load_snapshot(args.replay[0])
        period_ns = first.period_ns
        source = ReplaySource([first, *args.replay[1:]])
    else:
        source = SyntheticSource(args.windows)
        period_ns = WindowSnapshot.period_ns  # generate() keeps the default

    if args.aggregator in ("dict", "dict+cm"):
        # "dict" fails fast at capacity; "dict+cm" degrades to the
        # count-min sideband and rotates cold stacks. The rotation age is
        # 6 reference (10 s) windows of wall time at any cadence.
        aggregator = DictAggregator(
            capacity=args.aggregator_capacity,
            overflow="sketch" if args.aggregator == "dict+cm" else "raise",
            rotate_min_age=windows_for(6, args.profiling_duration),
            device=device)
    elif args.aggregator == "sharded":
        import torch

        from parca_agent_tpu_torch.aggregator.sharded import (
            ShardedDictAggregator,
        )
        from parca_agent_tpu_torch.utils.log import get_logger

        # The largest power-of-two device count: sub-tables are powers of
        # two, and a 6-card host shards 4 ways rather than stop.
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        n_shards = 1 << (n_dev.bit_length() - 1)
        if n_shards < n_dev:
            get_logger("cli").warn(
                "sharded aggregator uses a power-of-two shard count",
                devices=n_dev, shards=n_shards)
        aggregator = ShardedDictAggregator(
            capacity=args.aggregator_capacity, n_shards=n_shards,
            overflow="sketch", device=device)
    elif args.aggregator == "tpu":
        aggregator = TPUAggregator(device=device)
    else:
        aggregator = CPUAggregator()
    writer = (FileProfileWriter(args.local_store_directory)
              if args.local_store_directory else None)
    print_mu = threading.Lock()

    def emit(rec: dict) -> None:
        """One JSON line a window, once its profiles are written (by the
        encode worker for a pipelined window)."""
        line = {"window": rec["window"], "device": str(device),
                "aggregator": args.aggregator, "rows": rec["rows"],
                "samples": rec["samples"], "profiles": rec["profiles"],
                "mass": rec["mass"],
                "aggregate_ms": round(rec["aggregate_ms"], 3)}
        if args.fast_encode:
            line["encode_path"] = rec["path"]
            line["encode_ms"] = round(rec["encode_ms"], 3)
        line["window_ms"] = round(rec["window_ms"], 3)
        if "handoff_ms" in rec:
            line["handoff_ms"] = round(rec["handoff_ms"], 3)
        with print_mu:
            print(json.dumps(line), flush=True)

    statics_store = None
    if args.statics_snapshot_path:
        if not args.fast_encode:
            print("parca-agent-tpu-torch: --statics-snapshot-path needs "
                  "--fast-encode; statics snapshotting disabled",
                  file=sys.stderr)
        else:
            from parca_agent_tpu_torch.pprof.statics_store import StaticsStore

            statics_store = StaticsStore(
                args.statics_snapshot_path,
                max_age_s=args.statics_snapshot_max_age or None)

    profiler = None
    if args.fast_encode:
        from parca_agent_tpu_torch.profiler.cpu import CPUProfiler

        profiler = CPUProfiler(source, aggregator, profile_writer=writer,
                               encode_pipeline=not args.no_encode_pipeline,
                               statics_cache_bytes=args.statics_cache_bytes,
                               on_window=emit, statics_store=statics_store,
                               statics_snapshot_every=max(
                                   1, args.statics_snapshot_interval))
        if statics_store is not None:
            # Adopt the previous run's snapshot before anything touches
            # the aggregator or the encoder (registries install only into
            # a cold pid). A missing, stale or corrupt snapshot degrades
            # to the cold build, record by record; statics built at
            # another period than the source's windows count as stale.
            adopt = statics_store.adopt(aggregator, profiler.encoder,
                                        period_ns)
            print(json.dumps({"statics_adopt": adopt,
                              "adopt_ms": statics_store.stats[
                                  "snapshot_adopt_ms"]}), flush=True)
        step = profiler.run_iteration
    else:
        def step() -> bool:
            snapshot = source.poll()
            if snapshot is None:
                return False
            t0 = time.perf_counter()
            profiles = aggregator.aggregate(snapshot)
            t_agg = time.perf_counter() - t0
            if writer is not None:
                for prof in profiles:
                    writer.write(labels_for(prof.pid),
                                 build_pprof(prof, compress=False))
            emit({"window": n + 1, "rows": len(snapshot),
                  "samples": snapshot.total_samples(),
                  "profiles": len(profiles),
                  "mass": sum(p.total() for p in profiles),
                  "aggregate_ms": t_agg * 1e3,
                  "window_ms": (time.perf_counter() - t0) * 1e3})
            return True

    n = 0
    next_window = time.monotonic()
    try:
        while not args.windows or n < args.windows:
            # One window per --profiling-duration: sleep out the remainder
            # of the previous window's period before taking the next one.
            time.sleep(max(0.0, next_window - time.monotonic()))
            next_window = time.monotonic() + args.profiling_duration
            if not step():
                break
            n += 1
    finally:
        if profiler is not None:
            # Flush the in-flight window (and surface a pipelined
            # failure).
            profiler.close()
            if statics_store is not None:
                st = statics_store.stats
                print(json.dumps({"statics_snapshot": {
                    k: st[k] for k in ("snapshots_written",
                                       "snapshots_skipped_clean",
                                       "snapshot_bytes", "snapshot_records",
                                       "snapshot_write_errors",
                                       "records_dropped_cap")}}),
                      flush=True)
    return 0
