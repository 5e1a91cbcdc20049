"""Command line: ``python -m parca_agent_tpu_torch``.

Runs the profile-build loop of parca_agent_tpu's CLI for the subset this
package carries: a capture source (synthetic, replay, or the real
machine: perf_event call chains or procfs CPU ticks) -> window
aggregation (the device-resident stack dictionary, fail-fast or in
bounded memory, whole or split into home sub-tables; the one-shot window
program; or the numpy CPUAggregator) -> per-pid pprof -> the transport
of parca_agent_tpu's CLI (agent/): each profile gzipped by
RemoteProfileWriter, through MatchingProfileListener into the
BatchWriteClient, whose supervised flush loop ships a WriteRaw request
each --remote-store-batch-write-interval to the Parca store at
--remote-store-address (gRPC; a no-op store without one), spills to
--spool-directory past its caps or after failed flushes and replays the
spool when the store takes data again; teed to the local store under
--local-store-directory. With --remote-store-address each window's
object files are also uploaded to the store's debuginfo service
(debuginfo/, unless --debuginfo-upload-disable). With a store or a label
flag (--node, --metadata-external-labels, --config-path) each profile's
labels come from the label pipeline (labels/, metadata/: service
discovery, process, cgroup, system and target labels, then
--config-path's relabel rules, hot-reloaded; a dropped target is not
written); without, they are {__name__, pid}. The --enable-*-discovery
flags run discovery/'s providers (systemd units, containers by cgroup,
this node's pods), whose groups feed the service discovery labels each
window, the first scrape before the first window; they build the label
pipeline too. grpc is imported only with --remote-store-address and
yaml only with --config-path. With --fast-encode (dictionary aggregators
only) the per-pid pprof comes from the vectorized window encoder, on an
encode worker thread unless --no-encode-pipeline is given
(profiler/cpu.py); with
--statics-snapshot-path the worker also keeps a warm statics snapshot,
which the next run adopts before its first window. With
--streaming-window (perf capture, --fast-encode, a dictionary) each
capture drain is fed to the card during the window and the close is one
packed fetch (profiler/streaming.py). Without --fast-encode each
window's profiles are symbolized on the host before they are written:
kernel frames from /proc/kallsyms, JIT frames from /tmp/perf-<pid>.map
read through the process's own mount namespace (symbolize/); the
--fast-encode path ships addresses, for the server to symbolize.
--dwarf-unwinding (perf capture) also snapshots each sample's user
registers and stack and walks frameless user stacks against .eh_frame
tables built in the background (unwind/, dwarf/); that mode runs
one-shot. Each window's pids are checked against their /proc start time
before the close (process/identity.py), so a recycled pid's stale state
is dropped, unless --no-pid-generation or PARCA_NO_PID_GENERATION=1.
--capture perf degrades to procfs only when the kernel refuses
perf_event_open (EACCES or EPERM); each window's JSON line names the
source that ran. With
--fleet-coordinator the agent joins a fleet of agent processes
(torch.distributed: NCCL on the card, gloo with --device cpu) before any
device work and runs the fleet merge actor beside the window loop: every
window's rows are merged fleet-wide each interval (parallel/). Flag
names are those of parca_agent_tpu's CLI. The aggregation runs on the CUDA card
unless ``--device cpu`` is given; without a CUDA device the run stops
with an error that names the missing device.

The agent shell: the CLI logs in logfmt on stderr at --log-level
(utils/log.py), with the build info (buildinfo.py) and the kernel-config
and container checks (kconfig.py) at start, and serves web.py's HTTP
surface at --http-address (/metrics, /healthz, /query, /debug/*, the
self-profile of profiler/selfprofile.py), bound before the actors start
and stopped on every exit.

The runtime edges (runtime/): before this process creates a CUDA
context (it only asks the device count), a throwaway child probes the
card (CUDA init and one launch of the row hash kernel), killed at
--device-probe-timeout; a failed probe stops the run
with the device-health snapshot as the last JSON line. The window loop
runs as a supervised actor (runtime/supervisor.py: a crashed loop is
restarted with capped backoff, up to its crash budget), beside the
encode pipeline's worker (a probe that revives it) and the fleet merge
actor. Each window's device call runs under a watchdog that gives each
of its waits on the card --device-timeout seconds (the host work between
them is not timed): a hang ends the run with a bounded, non-zero exit,
the trace flushed (an incident file under --trace-incident-dir, with a
self-profile) and the device-health snapshot as the last JSON line. The
flight recorder (runtime/trace.py) and device telemetry
(runtime/device_telemetry.py) are on unless --no-window-trace or
--no-device-telemetry (both observe only), the quarantine registry
(runtime/quarantine.py) unless --quarantine-max-strikes is 0; every exit
prints their state (each section present when it is on) as one
{"runtime": ...} JSON line (with the process identity's counters, the
faults fired at each armed chaos site, the batch client's, the spool's
and the store channel's counters and, in DWARF mode, the walk
counters under the original's /metrics names), before the source's and
the fleet's exit lines (after a device hang: before the device-health
line, which is last). --fault-inject arms the chaos sites (utils/faults.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from parca_agent_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parca-agent-tpu-torch",
        description="sampling CPU profiler agent: window aggregation on a "
                    "CUDA device with PyTorch")
    p.add_argument("--log-level", default="info",
                   choices=["error", "warn", "info", "debug"])
    p.add_argument("--http-address", default="127.0.0.1:7071",
                   help="status/metrics/query listen address (port 0: any "
                        "free port, logged at start)")
    p.add_argument("--capture", default="synthetic",
                   choices=["synthetic", "replay", "perf", "procfs"],
                   help="capture source: synthetic load, replay of saved "
                        "snapshots (--replay), or the real machine: perf "
                        "= perf_event kernel + frame-pointer call chains "
                        "of every CPU (needs CAP_PERFMON or "
                        "kernel.perf_event_paranoid <= 0; refused, it "
                        "degrades to procfs), procfs = per-process CPU "
                        "ticks from /proc (depth-1 stacks at each "
                        "process's entry point)")
    p.add_argument("--dwarf-unwinding", action="store_true",
                   help="capture user registers + stack slices and unwind "
                        "frameless user stacks against .eh_frame tables "
                        "(reference --experimental-enable-dwarf-unwinding); "
                        "--capture perf only, runs one-shot")
    p.add_argument("--dwarf-unwinding-comm-regex", default="",
                   help="only build unwind tables for processes whose comm "
                        "matches (reference --debug-process-names); empty "
                        "= all sampled processes")

    def _non_negative(text: str) -> int:
        v = int(text)
        if v < 0:
            raise argparse.ArgumentTypeError("must be >= 0")
        return v

    p.add_argument("--dwarf-trust-fp-frames", type=_non_negative, default=0,
                   help="skip the DWARF walk for samples whose frame-"
                        "pointer chain already has this many frames "
                        "(throughput knob; 0 = walk every sample of a "
                        "targeted process, the reference's behavior)")
    p.add_argument("--dwarf-stack-dump-bytes", type=int, default=16384,
                   help="user-stack bytes snapshotted per sample in DWARF "
                        "mode (multiple of 8, < 64 KiB)")
    p.add_argument("--no-pid-generation", action="store_true",
                   help="disable generation-stamped process identity "
                        "(pid-reuse detection via /proc/<pid>/stat "
                        "starttime + stale-state invalidation); "
                        "PARCA_NO_PID_GENERATION=1 does the same")
    p.add_argument("--profiling-cpu-sampling-frequency", type=int,
                   default=100,
                   help="samples a second a CPU (perf), or the rate that "
                        "procfs ticks are scaled to")
    p.add_argument("--debug-process-names", default="",
                   help="DEBUG: comma-separated comm regexes; only "
                        "matching processes' samples are profiled. "
                        "Filtered at the window boundary, so streaming "
                        "feeds run one-shot")
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
    p.add_argument("--streaming-window", action="store_true",
                   help="feed each capture drain to the card DURING the "
                        "window (--capture perf, a dict aggregator, "
                        "--fast-encode); the window's close is then one "
                        "packed fetch, and a window whose fed mass "
                        "differs from its snapshot's is re-aggregated")
    p.add_argument("--no-feed-carry", action="store_true",
                   help="disable the cross-drain carry cache of streamed "
                        "windows (repeat stacks fold on the host and "
                        "flush their mass once at close; exact either "
                        "way). PARCA_NO_CAPTURE_HASH=1 separately pins the "
                        "sampler's drain-time hash carry off")
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
    p.add_argument("--node", default="", help="node name label")
    p.add_argument("--systemd-units", default="",
                   help="comma-separated units to discover (empty = all)")
    p.add_argument("--enable-systemd-discovery", action="store_true")
    p.add_argument("--enable-cgroup-discovery", action="store_true")
    p.add_argument("--enable-kubernetes-discovery", action="store_true",
                   help="watch this node's pods via the in-cluster API and "
                        "label samples with pod/container metadata "
                        "(reference pkg/discovery/kubernetes.go)")
    p.add_argument("--metadata-container-runtime-socket-path", default="",
                   help="container runtime socket to resolve container "
                        "pids through, overriding the well-known paths "
                        "(reference flag of the same name)")
    p.add_argument("--config-path", default="",
                   help="YAML file with relabel_configs; hot-reloaded")
    p.add_argument("--metadata-external-labels", default="",
                   help="k=v,k2=v2 labels attached to every profile")
    p.add_argument("--remote-store-address", default="")
    p.add_argument("--remote-store-bearer-token", default="")
    p.add_argument("--remote-store-bearer-token-file", default="")
    p.add_argument("--remote-store-insecure", action="store_true")
    p.add_argument("--remote-store-insecure-skip-verify",
                   action="store_true",
                   help="skip TLS certificate verification: the server's "
                        "cert is fetched unverified and pinned for the "
                        "channel (encrypted, unauthenticated — reference "
                        "--remote-store-insecure-skip-verify)")
    p.add_argument("--remote-store-batch-write-interval", type=float,
                   default=10.0)
    p.add_argument("--remote-store-batch-buffer-bytes", type=int,
                   default=64 << 20,
                   help="in-memory batch buffer byte cap; past it the "
                        "buffered batch spills to --spool-directory (or "
                        "is dropped, counted) — deviation from the "
                        "reference's unbounded retry-forever buffer "
                        "(docs/robustness.md)")
    p.add_argument("--remote-store-batch-buffer-samples", type=int,
                   default=100_000,
                   help="in-memory batch buffer sample-count cap")
    p.add_argument("--remote-store-retry-budget", type=int, default=8,
                   help="send retries per flush interval, SHARED between "
                        "the live flush and spool replay (full-jitter "
                        "exponential backoff between attempts)")
    p.add_argument("--spool-directory", default="",
                   help="directory for disk spill of batches the store "
                        "could not take (outage write-ahead spool); "
                        "empty disables spill (overflow then drops, "
                        "counted)")
    p.add_argument("--spool-max-bytes", type=int, default=256 << 20,
                   help="spool byte cap; past it the OLDEST segments are "
                        "evicted (counted drops)")
    p.add_argument("--spool-replay-per-interval", type=int, default=4,
                   help="max spilled segments replayed per flush interval "
                        "after the store recovers (bounded-rate catch-up)")
    p.add_argument("--debuginfo-directories", default="/usr/lib/debug",
                   help="comma-separated local directories searched for "
                        "separate debuginfo files (reference "
                        "--debuginfo-directories)")
    p.add_argument("--debuginfo-strip",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="upload only the sections needed for "
                        "symbolization; --no-debuginfo-strip ships the "
                        "exact binary unmodified (reference "
                        "--debuginfo-strip)")
    p.add_argument("--debuginfo-upload-cache-duration", type=float,
                   default=300.0,
                   help="seconds to cache server-side exists checks "
                        "(reference --debuginfo-upload-cache-duration, "
                        "5m)")
    p.add_argument("--debuginfo-upload-timeout", type=float, default=120.0,
                   help="per-request debuginfo upload timeout, seconds "
                        "(reference --debuginfo-upload-timeout-duration, "
                        "2m)")
    p.add_argument("--debuginfo-upload-disable", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the aggregation: cuda (default) "
                        "or cpu")
    p.add_argument("--fleet-coordinator", default="",
                   help="host:port of fleet node 0; joining forms the "
                        "fleet's process group (torch.distributed: NCCL "
                        "on the card, gloo with --device cpu) and starts "
                        "the per-window fleet merge actor: every window, "
                        "all nodes merge their stack streams into "
                        "fleet-wide exact unique-stack counts, printed at "
                        "exit as a {\"fleet\": ...} line "
                        "(parallel/distributed.py; the offline "
                        "cluster-wide pprof assembly is "
                        "parallel/fleet.py fleet_merge_profiles)")
    p.add_argument("--fleet-nodes", type=int, default=0,
                   help="total agent processes in the fleet")
    p.add_argument("--fleet-node-id", type=int, default=-1,
                   help="this agent's rank (0 = coordinator)")
    p.add_argument("--fleet-join-timeout", type=float, default=60.0,
                   help="seconds the fleet join may take before it is "
                        "abandoned and the agent continues SINGLE-NODE (a "
                        "dead coordinator would block startup forever); "
                        "0 = unbounded")
    p.add_argument("--collective-timeout", type=float, default=30.0,
                   help="seconds one fleet merge collective may take "
                        "before it is abandoned and fleet mode degrades "
                        "to node-local profiles (counted, rejoin after a "
                        "bounded re-probe — a hung peer must not wedge "
                        "this node's merge actor); 0 = unbounded")
    p.add_argument("--fault-inject", default="",
                   help="CHAOS: semicolon-separated fault rules "
                        "(site:kind[:k=v,...], utils/faults.py) injected "
                        "at named sites; also read from the PARCA_FAULTS "
                        "env var. Testing only")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the fault injector's probability draws "
                        "(PARCA_FAULT_SEED env var)")
    p.add_argument("--no-window-trace", action="store_true",
                   help="disable the window flight recorder: per-window "
                        "lifecycle traces on /debug/windows and "
                        "/debug/trace/<seq>, per-stage latency histograms "
                        "on /metrics, and the slow-window detector")
    p.add_argument("--trace-ring", type=int, default=512,
                   help="completed window traces kept in the flight "
                        "recorder's ring buffer")
    p.add_argument("--trace-slow-multiple", type=float, default=5.0,
                   help="slow-window budget: a stage slower than this "
                        "multiple of its own running p99 (floored at "
                        "50 ms, after 8 samples) triggers an incident "
                        "capture")
    p.add_argument("--trace-incident-dir", default="",
                   help="directory for incident files (crash-only "
                        "tmp+rename JSON: the offending trace and the "
                        "supervisor/device/quarantine state), written on "
                        "a slow window and on a device hang. Empty "
                        "disables incident files; slow windows are still "
                        "counted")
    p.add_argument("--trace-incident-interval", type=float, default=300.0,
                   help="minimum seconds between slow-window incident "
                        "captures (rate limit; suppressed captures are "
                        "counted)")
    p.add_argument("--no-device-telemetry", action="store_true",
                   help="disable the device flight recorder: per-kernel "
                        "launch histograms, transfer accounting and the "
                        "window budget on /metrics and /debug/device")
    p.add_argument("--telemetry-ring", type=int, default=256,
                   help="kernel events and window-budget entries kept in "
                        "the device flight recorder's timeline rings")
    p.add_argument("--quarantine-max-strikes", type=int, default=3,
                   help="ingest containment: per-pid input faults "
                        "tolerated per budget window before the pid is "
                        "quarantined and its samples ride the "
                        "degradation ladder; 0 disables the quarantine "
                        "registry")
    p.add_argument("--quarantine-windows", type=int, default=3,
                   help="base quarantine length in windows (doubles per "
                        "repeat trip, capped)")
    p.add_argument("--quarantine-pid-deadline", type=float, default=0.0,
                   help="per-pid ingest processing deadline in seconds; "
                        "a pid whose maps/ELF processing exceeds it is "
                        "charged an input fault (0 = no deadline)")
    p.add_argument("--device-probe-timeout", type=float, default=60.0,
                   help="hard deadline of the bring-up probe, a child "
                        "process that initializes CUDA and launches one "
                        "hand kernel before this process touches the "
                        "card (killed past it; a failed probe stops the "
                        "run). 0 skips the probe. The CPU is not probed")
    p.add_argument("--device-timeout", type=float, default=60.0,
                   help="watchdog of each wait on the card in a window's "
                        "device call (an upload, the miss count, the close "
                        "fetch; the host work between them is not timed): "
                        "past it the call is abandoned and the run ends "
                        "with a non-zero exit (no CPU fallback); 0 = "
                        "unbounded")
    p.add_argument("--encode-deadline", type=float, default=45.0,
                   help="soft deadline (seconds) of one window's inline "
                        "pprof encode: past it the encode is abandoned to "
                        "its thread (it keeps warming the template) and "
                        "the window ships each pid's scalar profile (its "
                        "exact count from the card in one sample); 0 "
                        "disables. Applies when the encode pipeline is "
                        "off, or to a window it refused")
    p.add_argument("--version", action="version",
                   version=f"parca-agent-tpu-torch {__version__}")
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


def live_source(args):
    """The real machine's capture source and its name: perf, or procfs
    when asked for or when the kernel refuses perf_event_open (EACCES or
    EPERM, logged with the errno). Any other failure raises."""
    import errno

    from parca_agent_tpu_torch.capture.procfs import ProcfsSampler
    from parca_agent_tpu_torch.utils.log import get_logger

    if args.capture == "perf":
        from parca_agent_tpu_torch.capture.live import (
            PerfEventSampler,
            SamplerUnavailable,
        )

        try:
            return PerfEventSampler(
                frequency_hz=args.profiling_cpu_sampling_frequency,
                window_s=args.profiling_duration,
                capture_stack=args.dwarf_unwinding,
                stack_dump_bytes=args.dwarf_stack_dump_bytes,
                dwarf_comm_regex=args.dwarf_unwinding_comm_regex or None,
                trust_fp_frames=args.dwarf_trust_fp_frames or None), "perf"
        except SamplerUnavailable as e:
            if e.errno not in (errno.EACCES, errno.EPERM):
                raise
            get_logger("cli").warn(
                "perf_event_open refused; falling back to procfs capture",
                errno=e.errno, error=str(e))
    return ProcfsSampler(frequency_hz=args.profiling_cpu_sampling_frequency,
                         window_s=args.profiling_duration), "procfs"


def walk_metrics(source) -> dict:
    """DWARF mode's walk counters under the original's /metrics names
    (empty before the first walk, and outside DWARF mode)."""
    ws = getattr(source, "walk_stats", None)
    if ws is None or not ws.total:
        return {}
    return {"parca_agent_dwarf_walk_total": ws.total,
            "parca_agent_dwarf_walk_success_total": ws.success,
            "parca_agent_dwarf_walk_truncated_total": ws.truncated,
            "parca_agent_dwarf_walk_pc_not_covered_total": ws.pc_not_covered,
            "parca_agent_dwarf_walk_unsupported_total": ws.unsupported,
            "parca_agent_dwarf_walk_success_ratio":
                round(ws.success / ws.total, 4)}


def http_metrics(source, store, feeder, fleet_merger, binfo) -> dict:
    """The extra /metrics families of parca_agent_tpu's CLI (also the
    status page's capture line): the perf sampler's loss and dedup
    counters, the build info, the store channel's resets, the streaming
    feeder's counters, the fleet merger's state and the DWARF walk
    counters."""
    from parca_agent_tpu_torch.web import escape_label_value

    out = {}
    if hasattr(source, "lost_samples"):
        out["parca_agent_capture_lost_samples_total"] = source.lost_samples
    if hasattr(source, "truncated_drains"):
        out["parca_agent_capture_truncated_drains_total"] = \
            source.truncated_drains
    if hasattr(source, "dedup_hits"):
        out["parca_agent_capture_dedup_hits_total"] = source.dedup_hits
        out["parca_agent_capture_dedup_overflow_total"] = \
            source.dedup_overflow
    if hasattr(source, "hash_carry"):
        out["parca_agent_capture_hash_carry"] = int(source.hash_carry)
    labels = ",".join(f'{k}="{escape_label_value(v)}"'
                      for k, v in binfo.as_metrics().items())
    out[f"parca_agent_build_info{{{labels}}}"] = 1
    if hasattr(store, "stats"):
        out["parca_agent_remote_store_channel_resets_total"] = \
            store.stats.get("channel_resets", 0)
    if feeder is not None:
        out["parca_agent_streaming_disabled"] = int(feeder.disabled)
        for k, v in feeder.stats.items():
            if isinstance(v, (int, float)):
                out[f"parca_agent_streaming_{k}"] = round(v, 4) \
                    if isinstance(v, float) else v
    if fleet_merger is not None:
        # Degrade/rejoin accounting; a failed fleet reports that, not
        # frozen last-good gauges; the staleness clocks expose a peer
        # hang (age >> interval, or a long round in flight).
        out["parca_agent_fleet_degraded"] = int(fleet_merger.degraded)
        for k, v in fleet_merger.stats.items():
            out[f"parca_agent_fleet_{k}"] = v
        if fleet_merger.failed is not None:
            out["parca_agent_fleet_failed"] = 1
        else:
            out["parca_agent_fleet_failed"] = 0
            out.update({f"parca_agent_{k}": v
                        for k, v in fleet_merger.fleet_stats.items()})
            now = time.monotonic()
            if fleet_merger.last_round_at is not None:
                out["parca_agent_fleet_last_round_age_seconds"] = \
                    round(now - fleet_merger.last_round_at, 3)
            if fleet_merger.round_started_at is not None:
                out["parca_agent_fleet_round_in_flight_seconds"] = \
                    round(now - fleet_merger.round_started_at, 3)
    out.update(walk_metrics(source))
    return out


def identity_tracker(args, source, aggregator, quarantine):
    """The generation-stamped process identity and the perf-map cache
    its invalidators share with the symbolizer: (None, None) with
    --no-pid-generation or PARCA_NO_PID_GENERATION=1. A recycled pid
    evicts its perf map, maps, unwind tables, quarantine record and the
    dictionary's per-pid registry."""
    if args.no_pid_generation \
            or os.environ.get("PARCA_NO_PID_GENERATION", "") == "1":
        return None, None
    from parca_agent_tpu_torch.process.identity import (
        ProcessIdentityTracker,
    )
    from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache

    identity = ProcessIdentityTracker()
    perf_cache = PerfMapCache()
    identity.add_invalidator("perfmap", perf_cache.evict)
    maps_cache = getattr(source, "_maps", None)
    if maps_cache is not None and hasattr(maps_cache, "evict"):
        identity.add_invalidator("maps", maps_cache.evict)
    unwind_cache = getattr(source, "_tables", None)
    if unwind_cache is not None and hasattr(unwind_cache, "evict"):
        identity.add_invalidator("unwind", unwind_cache.evict)
    if quarantine is not None:
        identity.add_invalidator("quarantine", quarantine.forget_pid)
    if hasattr(aggregator, "invalidate_pid"):
        identity.add_invalidator("aggregator", aggregator.invalidate_pid)
    return identity, perf_cache


def capture_stats(source, requested: str, capture: str, feeder) -> dict:
    """The last line of a live run: the source asked for and the one that
    ran, the perf sampler's counters and the streaming feeder's."""
    out = {"requested": requested, "source": capture}
    if capture == "perf":
        out.update(hash_carry=source.hash_carry, n_cpus=source.n_cpus,
                   lost_samples=source.lost_samples,
                   truncated_drains=source.truncated_drains,
                   dedup_hits=source.dedup_hits,
                   dedup_overflow=source.dedup_overflow,
                   dwarf=source.capture_stack)
    if feeder is not None:
        out["streaming"] = {k: feeder.stats[k] for k in (
            "drains_fed", "windows_streamed", "windows_fallback")}
    return out


def _parse_external_labels(text: str) -> dict[str, str]:
    out = {}
    for part in filter(None, text.split(",")):
        if "=" not in part:
            raise ValueError(f"bad external label {part!r} (want k=v)")
        k, v = part.split("=", 1)
        out[k] = v
    return out


def transport(args):
    """The write path of parca_agent_tpu's CLI: (store, batch client,
    listener, profile writer). The store is a GRPCStoreClient with
    --remote-store-address (grpc is imported then only), else a
    NoopStoreClient; the batch client spills to --spool-directory; the
    writer is RemoteProfileWriter -> MatchingProfileListener -> the batch
    client, teed with the FileProfileWriter under
    --local-store-directory."""
    from parca_agent_tpu_torch.agent.batch import (
        BatchWriteClient,
        NoopStoreClient,
    )
    from parca_agent_tpu_torch.agent.listener import MatchingProfileListener
    from parca_agent_tpu_torch.agent.writer import (
        FileProfileWriter,
        RemoteProfileWriter,
        TeeProfileWriter,
    )

    if args.remote_store_address:
        from parca_agent_tpu_torch.agent.grpc_client import GRPCStoreClient

        token = args.remote_store_bearer_token
        if args.remote_store_bearer_token_file:
            with open(args.remote_store_bearer_token_file) as f:
                token = f.read().strip()
        store = GRPCStoreClient(
            args.remote_store_address,
            insecure=args.remote_store_insecure,
            insecure_skip_verify=args.remote_store_insecure_skip_verify,
            bearer_token=token)
    else:
        store = NoopStoreClient()
    spool = None
    if args.spool_directory:
        from parca_agent_tpu_torch.agent.spool import SpoolDir

        spool = SpoolDir(args.spool_directory,
                         max_bytes=args.spool_max_bytes)
    batch = BatchWriteClient(
        store,
        interval_s=args.remote_store_batch_write_interval,
        max_buffer_bytes=args.remote_store_batch_buffer_bytes,
        max_buffer_samples=args.remote_store_batch_buffer_samples,
        retry_budget=args.remote_store_retry_budget,
        spool=spool,
        replay_per_interval=args.spool_replay_per_interval)
    listener = MatchingProfileListener(next_writer=batch)
    writer = RemoteProfileWriter(listener)
    if args.local_store_directory:
        writer = TeeProfileWriter(
            FileProfileWriter(args.local_store_directory), writer)
    return store, batch, listener, writer


def discovery_manager(args):
    """The discovery manager of parca_agent_tpu's CLI and its providers
    (systemd units, containers by cgroup, this node's pods with the
    container runtime's socket as their pid fallback), one a
    --enable-*-discovery flag. Returns (manager, providers)."""
    from parca_agent_tpu_torch.discovery.manager import DiscoveryManager

    discovery = DiscoveryManager()
    providers = {}
    if args.enable_systemd_discovery:
        from parca_agent_tpu_torch.discovery.systemd import SystemdDiscoverer

        units = tuple(filter(None, args.systemd_units.split(",")))
        providers["systemd"] = SystemdDiscoverer(units=units)
    if args.enable_cgroup_discovery:
        from parca_agent_tpu_torch.discovery.cgroup import (
            CgroupContainerDiscoverer,
        )

        providers["cgroup"] = CgroupContainerDiscoverer()
    if args.enable_kubernetes_discovery:
        from parca_agent_tpu_torch.discovery.cri import CRIResolver
        from parca_agent_tpu_torch.discovery.kubernetes import PodDiscoverer

        providers["kubernetes"] = PodDiscoverer(
            node=args.node or None,
            cri=CRIResolver(
                socket_path=(args.metadata_container_runtime_socket_path
                             or None)))
    discovery.apply_config(providers)
    return discovery, providers


def labels_manager(args, sd_provider):
    """The label pipeline of parca_agent_tpu's CLI (the service discovery
    provider `sd_provider`, which discovery feeds each window, then
    process, cgroup, system and target labels, and --config-path's
    relabel rules, yaml imported then only), when a store, a label flag
    or discovery asks for it: --remote-store-address, --node,
    --metadata-external-labels, --config-path or a --enable-*-discovery
    flag. Otherwise None, and each profile keeps the label set {__name__,
    pid}, so the local store's file names stay as they were. Returns
    (manager, config reloader or None)."""
    if not (args.remote_store_address or args.node
            or args.metadata_external_labels or args.config_path
            or args.enable_systemd_discovery or args.enable_cgroup_discovery
            or args.enable_kubernetes_discovery):
        return None, None
    from parca_agent_tpu_torch.config import ConfigReloader, load_config_file
    from parca_agent_tpu_torch.labels.manager import LabelsManager
    from parca_agent_tpu_torch.metadata.providers import (
        CgroupProvider,
        ProcessProvider,
        SystemProvider,
        TargetProvider,
    )

    manager = LabelsManager(
        [sd_provider, ProcessProvider(), CgroupProvider(),
         SystemProvider(),
         TargetProvider(node=args.node,
                        external=_parse_external_labels(
                            args.metadata_external_labels))],
        relabel_configs=(load_config_file(args.config_path).relabel_configs
                         if args.config_path else []),
        profiling_duration_s=args.profiling_duration)
    reloader = None
    if args.config_path:
        reloader = ConfigReloader(
            args.config_path,
            [lambda cfg: manager.apply_config(cfg.relabel_configs)])
    return manager, reloader


def debuginfo_manager(args, store):
    """The debuginfo uploader of parca_agent_tpu's CLI, over the store's
    channel: only with --remote-store-address and without
    --debuginfo-upload-disable (without a store nobody consumes it)."""
    if args.debuginfo_upload_disable or not args.remote_store_address:
        return None
    from parca_agent_tpu_torch.agent.debuginfo_client import (
        GRPCDebuginfoClient,
    )
    from parca_agent_tpu_torch.debuginfo.find import Finder
    from parca_agent_tpu_torch.debuginfo.manager import DebuginfoManager

    debug_dirs = tuple(filter(None, (
        d.strip() for d in args.debuginfo_directories.split(","))))
    return DebuginfoManager(
        client=GRPCDebuginfoClient(lambda: store.channel,
                                   timeout_s=args.debuginfo_upload_timeout),
        finder=Finder(debug_dirs=debug_dirs),
        exists_ttl_s=args.debuginfo_upload_cache_duration,
        strip=args.debuginfo_strip)


def transport_metrics(batch, store) -> dict:
    """The batch client's, the spool's and the store channel's counters
    under the original's /metrics names."""
    series, samples = batch.buffered()
    segments, spool_bytes = batch.replay_backlog()
    out = {"parca_agent_remote_write_batches_sent_total": batch.sent_batches,
           "parca_agent_remote_write_errors_total": batch.send_errors,
           "parca_agent_remote_write_buffered_series": series,
           "parca_agent_remote_write_buffered_samples": samples,
           "parca_agent_remote_write_buffer_bytes": batch.buffer_bytes(),
           "parca_agent_spool_segments": segments,
           "parca_agent_spool_bytes": spool_bytes,
           "parca_agent_replay_lag_seconds": round(batch.replay_lag_s(), 3)}
    for k, v in batch.spool_stats().items():
        out[f"parca_agent_spool_{k}"] = v
    for k, v in batch.stats.items():
        out[f"parca_agent_remote_write_{k}"] = v
    if hasattr(store, "stats"):
        out["parca_agent_remote_store_channel_resets_total"] = \
            store.stats.get("channel_resets", 0)
    return out


def startup_probe(device, timeout_s: float):
    """The device-health registry after the bring-up probe: a child
    process initializes ``device`` and launches the row hash kernel,
    killed at ``timeout_s`` (0: no probe, the registry trusts the card).
    The CPU is never probed."""
    from parca_agent_tpu_torch.runtime.device_health import (
        DeviceHealthRegistry,
        subprocess_probe,
    )

    probe = None
    if timeout_s > 0 and device.type == "cuda":
        def probe():
            return subprocess_probe(timeout_s, str(device))
    health = DeviceHealthRegistry(probe=probe, probe_timeout_s=timeout_s)
    health.run_probe()
    return health


def _install_faults(args) -> None:
    from parca_agent_tpu_torch.utils import faults

    spec = args.fault_inject or os.environ.get("PARCA_FAULTS", "")
    if spec:
        seed = args.fault_seed or int(os.environ.get("PARCA_FAULT_SEED", 0))
        faults.install(faults.FaultInjector.from_spec(spec, seed=seed))


def _uninstall_runtime() -> None:
    """Remove the process-global hooks run() installed (an in-process
    caller, such as a test, must not inherit them)."""
    from parca_agent_tpu_torch.runtime import device_telemetry as dtel
    from parca_agent_tpu_torch.runtime import trace as trace_mod
    from parca_agent_tpu_torch.utils import faults
    from parca_agent_tpu_torch.utils.log import reset_logging

    faults.install(None)
    trace_mod.install(None)
    dtel.install(None)
    reset_logging()


def run(argv=None, hard_exit: bool = False) -> int:
    """The CLI. ``hard_exit`` (the ``python -m`` entry) leaves a run
    ended by a device hang through os._exit once its output is flushed:
    interpreter teardown could block on the wedged CUDA stream that the
    abandoned call still holds."""
    from parca_agent_tpu_torch.utils.log import setup_logging

    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    _install_faults(args)
    try:
        code = _run(args)
    except _HangExit as e:
        code = e.code
        if hard_exit:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
    finally:
        _uninstall_runtime()
    return code


class _HangExit(Exception):
    """A device hang ended the run; its output is already flushed."""

    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


def _run(args) -> int:
    if args.profiling_duration <= 0:
        raise SystemExit("--profiling-duration must be > 0")
    if args.fast_encode and args.aggregator not in ("dict", "dict+cm",
                                                    "sharded"):
        raise SystemExit(
            "--fast-encode requires --aggregator dict/dict+cm/sharded")
    if args.streaming_window and not args.fast_encode:
        raise SystemExit("--streaming-window requires --fast-encode and a "
                         "dict aggregator")

    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.aggregator.tpu import TPUAggregator
    from parca_agent_tpu_torch.buildinfo import collect as collect_buildinfo
    from parca_agent_tpu_torch.capture.formats import (
        WindowSnapshot,
        load_snapshot,
    )
    from parca_agent_tpu_torch.profiler.cpu import (
        AggregateLoop,
        CPUProfiler,
        DeviceHang,
    )
    from parca_agent_tpu_torch.runtime import device_telemetry as dtel_mod
    from parca_agent_tpu_torch.runtime import trace as trace_mod
    from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
    from parca_agent_tpu_torch.runtime.supervisor import Supervisor
    from parca_agent_tpu_torch.utils import faults
    from parca_agent_tpu_torch.utils.device import resolve_device
    from parca_agent_tpu_torch.utils.log import get_logger
    from parca_agent_tpu_torch.utils.window_clock import windows_for

    log = get_logger("cli")
    binfo = collect_buildinfo()
    log.info("starting parca-agent-tpu-torch", version=binfo.display(),
             python=binfo.python)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"parca-agent-tpu-torch: {e}", file=sys.stderr)
        return 2
    # The bring-up probe runs before this process touches the card: a
    # wedged card costs a killed child, not a hung agent.
    health = startup_probe(device, args.device_probe_timeout)
    if health.state != "healthy":
        print(f"parca-agent-tpu-torch: the device probe failed: "
              f"{health.last_error}", file=sys.stderr)
        print(json.dumps({"device_health": health.snapshot()}), flush=True)
        return 1

    # The fleet join precedes any device work, on --device's backend.
    if args.fleet_coordinator:
        if args.fleet_nodes < 2 or not (0 <= args.fleet_node_id
                                        < args.fleet_nodes):
            print("parca-agent-tpu-torch: --fleet-coordinator needs "
                  "--fleet-nodes >= 2 and a valid --fleet-node-id",
                  file=sys.stderr)
            return 2
        from parca_agent_tpu_torch.parallel.distributed import (
            fleet_initialize,
        )

        try:
            fleet_initialize(args.fleet_coordinator, args.fleet_nodes,
                             args.fleet_node_id,
                             timeout_s=args.fleet_join_timeout or None,
                             device=device)
        except Exception as e:  # noqa: BLE001 - degrade, don't crash
            # A dead or refusing coordinator must not kill the agent at
            # startup: this host still deserves its profiler. Continue
            # single-node; only the fleet-wide merge is forfeited until a
            # restart rejoins.
            log.error("fleet join failed; continuing single-node",
                      coordinator=args.fleet_coordinator, error=repr(e))
            args.fleet_coordinator = ""

    # The environment checks (reference main.go:174-191).
    from parca_agent_tpu_torch.kconfig import (
        check_profiling_enabled,
        is_in_container,
    )

    ok, missing, advisory = check_profiling_enabled()
    if not ok:
        log.warn("kernel config missing required options", missing=missing)
    if advisory:
        log.warn("kernel config missing advisory (eBPF capture) options",
                 missing=advisory)
    if is_in_container():
        log.info("running inside a container; host procfs must be mounted "
                 "for whole-machine profiling")

    capture = args.capture
    if capture == "replay":
        from parca_agent_tpu_torch.capture.replay import ReplaySource

        if not args.replay:
            raise SystemExit("--capture replay needs --replay FILE...")
        # The first window is read here: its period is the run's.
        first = load_snapshot(args.replay[0])
        period_ns = first.period_ns
        source = ReplaySource([first, *args.replay[1:]])
    elif capture == "synthetic":
        source = SyntheticSource(args.windows)
        period_ns = WindowSnapshot.period_ns  # generate() keeps the default
    else:
        source, capture = live_source(args)
        period_ns = int(1e9 / args.profiling_cpu_sampling_frequency)

    if args.debug_process_names:
        from parca_agent_tpu_torch.capture.live import CommFilterSource

        source = CommFilterSource(
            source, [p.strip() for p in args.debug_process_names.split(",")])
        if args.streaming_window:
            # Drains teed mid-window bypass the boundary filter: the fed
            # mass would never match the filtered snapshot.
            log.warn(
                "--debug-process-names filters at the window boundary; "
                "running one-shot (streaming disabled)")
            args.streaming_window = False
    streaming = args.streaming_window and hasattr(source, "on_drain") \
        and not getattr(source, "capture_stack", False)
    if args.streaming_window and not streaming:
        log.warn("--streaming-window needs the perf capture source in FP "
                 "mode; running one-shot", capture=capture,
                 dwarf=getattr(source, "capture_stack", False))
    carry = streaming and not args.no_feed_carry

    # The window flight recorder and device telemetry (unless opted out)
    # and the quarantine registry, installed before any window runs.
    recorder = telemetry = None
    if not args.no_window_trace:
        recorder = trace_mod.FlightRecorder(
            ring=args.trace_ring, slow_multiple=args.trace_slow_multiple,
            incident_dir=args.trace_incident_dir,
            incident_interval_s=args.trace_incident_interval)
        trace_mod.install(recorder)
    if not args.no_device_telemetry:
        telemetry = dtel_mod.DeviceTelemetry(
            period_s=args.profiling_duration, ring=args.telemetry_ring,
            incident_interval_s=args.trace_incident_interval, device=device)
        dtel_mod.install(telemetry)
    quarantine = None
    if args.quarantine_max_strikes > 0:
        quarantine = QuarantineRegistry(
            max_strikes=args.quarantine_max_strikes,
            quarantine_windows=args.quarantine_windows,
            deadline_s=args.quarantine_pid_deadline or None,
            window_s=args.profiling_duration)
        if hasattr(source, "quarantine"):
            source.quarantine = quarantine

    if args.aggregator in ("dict", "dict+cm"):
        # "dict" fails fast at capacity; "dict+cm" degrades to the
        # count-min sideband and rotates cold stacks. The rotation age is
        # 6 reference (10 s) windows of wall time at any cadence.
        # The cross-drain carry cache pays only when a window spans
        # several feeds, i.e. under --streaming-window.
        aggregator = DictAggregator(
            capacity=args.aggregator_capacity,
            overflow="sketch" if args.aggregator == "dict+cm" else "raise",
            rotate_min_age=windows_for(6, args.profiling_duration),
            device=device, carry=carry)
    elif args.aggregator == "sharded":
        import torch

        from parca_agent_tpu_torch.aggregator.sharded import (
            ShardedDictAggregator,
        )

        # The largest power-of-two device count: sub-tables are powers of
        # two, and a 6-card host shards 4 ways rather than stop.
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        n_shards = 1 << (n_dev.bit_length() - 1)
        if n_shards < n_dev:
            log.warn(
                "sharded aggregator uses a power-of-two shard count",
                devices=n_dev, shards=n_shards)
        aggregator = ShardedDictAggregator(
            capacity=args.aggregator_capacity, n_shards=n_shards,
            overflow="sketch", device=device, carry=carry)
    elif args.aggregator == "tpu":
        aggregator = TPUAggregator(device=device)
    else:
        aggregator = CPUAggregator()
    identity, perf_cache = identity_tracker(args, source, aggregator,
                                            quarantine)
    # The transport, discovery, the label pipeline (discovery's groups
    # reach it through the service discovery provider, each window) and
    # the debuginfo uploader, as parca_agent_tpu's CLI builds them.
    from parca_agent_tpu_torch.metadata.providers import (
        ServiceDiscoveryProvider,
    )

    store, batch, listener, writer = transport(args)
    discovery, providers = discovery_manager(args)
    sd_provider = ServiceDiscoveryProvider()
    labels, reloader = labels_manager(args, sd_provider)
    debuginfo = debuginfo_manager(args, store)

    def on_iteration(_window: int) -> None:
        sd_provider.update(discovery.groups())
    print_mu = threading.Lock()

    def emit(rec: dict) -> None:
        """One JSON line a window, once its profiles are written (by the
        encode worker for a pipelined window)."""
        line = {"window": rec["window"], "device": str(device),
                "capture": capture, "aggregator": args.aggregator,
                "rows": rec["rows"],
                "samples": rec["samples"], "profiles": rec["profiles"],
                "mass": rec["mass"],
                "aggregate_ms": round(rec["aggregate_ms"], 3)}
        if args.fast_encode:
            line["encode_path"] = rec["path"]
            line["encode_ms"] = round(rec["encode_ms"], 3)
        line["window_ms"] = round(rec["window_ms"], 3)
        if "symbolize_ms" in rec:
            line["symbolize_ms"] = round(rec["symbolize_ms"], 3)
        if "handoff_ms" in rec:
            line["handoff_ms"] = round(rec["handoff_ms"], 3)
        if "streamed" in rec:
            line["streamed"] = rec["streamed"]
        with print_mu:
            print(json.dumps(line), flush=True)

    # The fleet merge actor (multi-node mode): a daemon thread runs one
    # merge round each window interval; each window's rows reach it
    # through the window sink, hashed lazily on the actor's thread.
    fleet_merger = fleet_stop = window_sink = None
    if args.fleet_coordinator:
        from parca_agent_tpu_torch.ops.hashing import row_hash_np
        from parca_agent_tpu_torch.parallel.distributed import (
            FleetWindowMerger,
        )

        fleet_merger = FleetWindowMerger(
            interval_s=args.profiling_duration,
            collective_timeout_s=args.collective_timeout or None,
            device=device)

        def window_sink(snapshot):
            fleet_merger.submit_window(
                lambda: row_hash_np(snapshot.stacks, snapshot.pids,
                                    snapshot.user_len, snapshot.kernel_len,
                                    n_hashes=2),
                snapshot.counts)

        fleet_stop = threading.Event()

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

    feeder = None
    # The loop's runtime edges, the same on both write paths.
    runtime = dict(window_sink=window_sink,
                   device_timeout_s=args.device_timeout,
                   device_health=health, quarantine=quarantine,
                   trace_recorder=recorder,
                   duration_s=args.profiling_duration, identity=identity,
                   labels_manager=labels, debuginfo=debuginfo,
                   manage_gc=True, on_iteration=on_iteration)
    if args.fast_encode:
        if streaming:
            from parca_agent_tpu_torch.profiler.streaming import (
                StreamingWindowFeeder,
            )

            # The feeder maps each drain's pids through the sampler's own
            # caches; the statics prebuild's period is seeded so the
            # first window is amortized too.
            feeder = StreamingWindowFeeder(
                aggregator, source._maps, source._objs,
                prebuild_period_ns=period_ns, quarantine=quarantine)
            source.on_drain = feeder.on_drain
        loop = CPUProfiler(source, aggregator, profile_writer=writer,
                           encode_pipeline=not args.no_encode_pipeline,
                           statics_cache_bytes=args.statics_cache_bytes,
                           on_window=emit, statics_store=statics_store,
                           statics_snapshot_every=max(
                               1, args.statics_snapshot_interval),
                           streaming_feeder=feeder,
                           encode_deadline_s=args.encode_deadline,
                           **runtime)
        if statics_store is not None:
            # Adopt the previous run's snapshot before anything touches
            # the aggregator or the encoder (registries install only into
            # a cold pid). A missing, stale or corrupt snapshot degrades
            # to the cold build, record by record; statics built at
            # another period than the source's windows count as stale.
            adopt = statics_store.adopt(aggregator, loop.encoder,
                                        period_ns)
            print(json.dumps({"statics_adopt": adopt,
                              "adopt_ms": statics_store.stats[
                                  "snapshot_adopt_ms"]}), flush=True)
    else:
        from parca_agent_tpu_torch.symbolize import KsymCache, Symbolizer
        from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache

        # Kernel names from kallsyms, JIT names from perf maps (through
        # the identity's cache, which a recycled pid evicts).
        symbolizer = Symbolizer(
            ksym=KsymCache(),
            perf=perf_cache if perf_cache is not None else PerfMapCache(),
            quarantine=quarantine)
        loop = AggregateLoop(source, aggregator, symbolizer=symbolizer,
                             profile_writer=writer, on_window=emit,
                             **runtime)

    # Supervision: a crashed window loop restarts with capped backoff,
    # up to its crash budget (a device hang is never restarted: it ends
    # the run); the encode worker is a probe its revive re-arms; the
    # config reloader, the fleet merge actor and its heartbeat are not
    # critical. The batch client's flush loop is registered first, so it
    # stops last: its final drain ships what the loop wrote on its way out.
    sup = Supervisor(probe_tick_s=0.2)
    sup.add_actor("flush", run=batch.run, stop=batch.stop)
    if reloader is not None:
        sup.add_actor("reload", run=reloader.run, stop=reloader.stop,
                      critical=False)
    sup.add_actor("profiler", run=lambda: loop.run(args.windows),
                  stop=loop.stop)
    if fleet_merger is not None:
        sup.add_actor("fleet", run=lambda: fleet_merger.run(fleet_stop),
                      stop=fleet_stop.set, critical=False)
        sup.add_probe("fleet-heartbeat", check=fleet_merger.heartbeat,
                      revive=fleet_merger.request_rejoin, critical=False)
    if loop.pipeline is not None:
        pipe = loop.pipeline
        sup.add_probe("encode", check=lambda: not pipe.disabled,
                      revive=pipe.revive, critical=False)
    if providers:
        sup.add_probe("discovery", check=discovery.alive,
                      revive=discovery.restart_dead, critical=False)

    def runtime_state() -> dict:
        """The runtime state of an incident file and of the summary."""
        out = {"supervisor": sup.health(), "overall": sup.overall(),
               "device": health.snapshot(), "watchdog": loop.watchdog.stats}
        if quarantine is not None:
            out["quarantine"] = quarantine.snapshot()
        if feeder is not None:
            out["feeder"] = {k: feeder.stats[k] for k in (
                "feed_errors", "feed_hangs", "drain_map_errors",
                "cooldowns", "reprobes", "windows_fallback")}
        if identity is not None:
            out["process_identity"] = identity.metrics()
        injector = faults.get()
        if injector is not None:
            out["faults_fired"] = injector.stats()
        walks = walk_metrics(source)
        if walks:
            out["dwarf_walk"] = walks
        out["transport"] = transport_metrics(batch, store)
        return out

    if recorder is not None:
        recorder.set_context(runtime_state)

    def print_runtime() -> None:
        print(json.dumps({"runtime": runtime_summary(
            recorder, telemetry, runtime_state)}), flush=True)

    # The HTTP surface (web.py), bound here and stopped on every exit.
    from parca_agent_tpu_torch.web import AgentHTTPServer

    def extra_metrics() -> dict:
        return http_metrics(source, store, feeder, fleet_merger, binfo)

    host, _, port = args.http_address.rpartition(":")
    try:
        http = AgentHTTPServer(
            host or "127.0.0.1", int(port), profilers=[loop],
            batch_client=batch, listener=listener, version=binfo.display(),
            extra_metrics=extra_metrics, capture_info=extra_metrics,
            supervisor=sup, quarantine=quarantine, device_health=health,
            statics_store=statics_store, recorder=recorder,
            identity=identity, device_telemetry=telemetry)
    except OSError as e:
        log.error("cannot listen on --http-address",
                  address=args.http_address, error=str(e))
        loop.close()
        return 2

    hung = None
    discovery.run()
    if providers:
        # The first scrape labels the first window: seeded before it.
        discovery.wait_for_update(0, timeout=2.0)
        sd_provider.update(discovery.groups())
    http.start()
    sup.start()
    log.info("parca-agent-tpu-torch listening", address=args.http_address,
             port=http.port, aggregator=args.aggregator, capture=capture)
    try:
        while not sup.finished("profiler"):
            time.sleep(0.05)
        hung = loop.crashed if isinstance(loop.crashed, DeviceHang) \
            else None
        if hung is not None:
            # The card is wedged: flush what the run knows and leave. The
            # abandoned call still holds the device, so nothing below
            # touches it (no close, no pipeline flush).
            log.error("device hang ended the run", error=str(hung))
            if args.trace_incident_dir and recorder is not None:
                recorder.flush_incident("device_hang", "close",
                                        {"error": str(hung)})
            print_runtime()
            print(json.dumps({"device_health": health.snapshot()}),
                  flush=True)
            raise _HangExit(1)
    finally:
        try:
            if hung is None:
                _finish(args, sup, loop, statics_store, source, capture,
                        feeder, fleet_merger, fleet_stop, print_runtime,
                        debuginfo)
        finally:
            discovery.stop()
            http.stop()
    if loop.crashed is not None:
        log.error("window loop crashed", exc=loop.crashed)
        return 1
    return 0


def runtime_summary(recorder, telemetry, runtime_state) -> dict:
    """The {"runtime": ...} exit line's body (without the recorder's or
    the telemetry's section when that one is off)."""
    out = runtime_state()
    if recorder is not None:
        out["trace"] = {"stage_percentiles": recorder.percentiles(),
                        "stats": dict(recorder.stats)}
    if telemetry is not None:
        out["device_telemetry"] = telemetry.snapshot()
    return out


def _finish(args, sup, loop, statics_store, source, capture, feeder,
            fleet_merger, fleet_stop, print_runtime, debuginfo) -> None:
    """A clean (or crashed, but not hung) run's end: stop the actors (the
    loop's clean exit has flushed its in-flight window by then, before
    the batch client's final drain), surface a pipelined failure, wait
    for the debuginfo uploads, print the exit lines (the runtime line
    first)."""
    try:
        sup.stop(timeout_s=args.profiling_duration
                 + (args.collective_timeout or 0.0) + 1.0)
        loop.close()
    finally:
        if debuginfo is not None:
            debuginfo.close()
        print_runtime()
        if statics_store is not None:
            st = statics_store.stats
            keys = ("snapshots_written", "snapshots_skipped_clean",
                    "snapshot_bytes", "snapshot_records",
                    "snapshot_write_errors", "records_dropped_cap")
            print(json.dumps({"statics_snapshot": {
                k: st[k] for k in keys}}), flush=True)
        close_source = getattr(source, "close", None)
        if close_source is not None:
            close_source()
        if capture in ("perf", "procfs"):
            print(json.dumps({"capture": capture_stats(
                source, args.capture, capture, feeder)}), flush=True)
        if fleet_merger is not None:
            failed = fleet_merger.failed
            print(json.dumps({
                "fleet": fleet_merger.fleet_stats,
                "fleet_merger": fleet_merger.stats,
                "degraded": fleet_merger.degraded,
                "failed": repr(failed) if failed else None}), flush=True)
