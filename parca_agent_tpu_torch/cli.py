"""Command line: ``python -m parca_agent_tpu_torch``.

Runs the profile-build loop of parca_agent_tpu's CLI for the subset this
package carries: a capture source (synthetic or replay) -> window
aggregation (the device-resident stack dictionary, the one-shot window
program, or the numpy CPUAggregator) -> per-pid pprof -> the local
store. Flag names are those of parca_agent_tpu's CLI. The aggregation
runs on the CUDA card unless ``--device cpu`` is given; without a CUDA
device the run stops with an error that names the missing device.
"""

from __future__ import annotations

import argparse
import json
import sys
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
                   choices=["dict", "tpu", "cpu"],
                   help="dict = stack dictionary resident on the device "
                        "(fails fast at capacity); tpu = one-shot window "
                        "program on the device (the name of "
                        "parca_agent_tpu's batch aggregator); cpu = numpy "
                        "aggregation on the host")
    p.add_argument("--aggregator-capacity", type=int, default=1 << 21,
                   help="dict table slots (power of two)")
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

    from parca_agent_tpu_torch.agent.writer import FileProfileWriter
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.aggregator.tpu import TPUAggregator
    from parca_agent_tpu_torch.pprof.builder import build_pprof
    from parca_agent_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"parca-agent-tpu-torch: {e}", file=sys.stderr)
        return 2

    if args.capture == "replay":
        from parca_agent_tpu_torch.capture.replay import ReplaySource

        if not args.replay:
            raise SystemExit("--capture replay needs --replay FILE...")
        source = ReplaySource(args.replay)
    else:
        source = SyntheticSource(args.windows)

    if args.aggregator == "dict":
        aggregator = DictAggregator(capacity=args.aggregator_capacity,
                                    overflow="raise", device=device)
    elif args.aggregator == "tpu":
        aggregator = TPUAggregator(device=device)
    else:
        aggregator = CPUAggregator()
    writer = (FileProfileWriter(args.local_store_directory)
              if args.local_store_directory else None)

    n = 0
    next_window = time.monotonic()
    while not args.windows or n < args.windows:
        # One window per --profiling-duration: sleep out the remainder of
        # the previous window's period before taking the next one.
        time.sleep(max(0.0, next_window - time.monotonic()))
        next_window = time.monotonic() + args.profiling_duration
        snapshot = source.poll()
        if snapshot is None:
            break
        t0 = time.perf_counter()
        profiles = aggregator.aggregate(snapshot)
        t_agg = time.perf_counter() - t0
        if writer is not None:
            for prof in profiles:
                writer.write({"__name__": "parca_agent_cpu",
                              "pid": str(prof.pid)},
                             build_pprof(prof, compress=False))
        n += 1
        print(json.dumps({
            "window": n, "device": str(device),
            "aggregator": args.aggregator, "rows": len(snapshot),
            "samples": snapshot.total_samples(),
            "profiles": len(profiles),
            "aggregate_ms": round(t_agg * 1e3, 3),
            "window_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }), flush=True)
    return 0
