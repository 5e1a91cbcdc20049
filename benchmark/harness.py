"""One run of one cell: the production window loop of parca_agent_tpu_torch
driven by the benchmark's replay, timed, checked and read.

The stack is the DaemonSet's ``--aggregator=dict+cm --fast-encode
--streaming-window`` wired as the CLI wires it: ``DictAggregator(overflow=
"sketch", carry=True)`` at the configuration's capacity,
``StreamingWindowFeeder`` on in-memory mapping caches, ``CPUProfiler``
with the encode pipeline, the flight recorder, device telemetry and the
quarantine registry at the CLI's defaults. Discovery, labels, process
identity, the transport and the analytics are off. The capture thread
(this one) replays each window's drains back to back into the feeder's
``on_drain`` and closes the window after the last; the writer keeps only
what the output check needs.

Set-up runs the cold window, which fills the dictionary from the whole
window's snapshot (the feeder has seen none of its drains, so the loop
re-aggregates it with ``window_counts``, the path of a window the feeder
missed), and the mix's warm windows, streamed; the measured
interval then runs windows until ``seconds`` have passed and waits for
the last window's pprof. The output check, after the interval and after
the loop is closed, holds every measured window against the plain
reference (references/<config's reference>.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import resource
import sys
import time

import numpy as np

from benchmark import pprof_decode
from benchmark.replay import PERIOD_NS_PER_S, Replay

FORBIDDEN = ("jax", "jaxlib", "flax", "parca_agent_tpu")
FLUSH_TIMEOUT_S = 600.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: parca_agent_tpu_torch passes)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


class _Object:
    __slots__ = ("_base",)

    def __init__(self, base: int):
        self._base = base

    def base(self) -> int:
        return self._base


class MapsCache:
    """The process-maps cache the feeder reads: the replay's live maps."""

    def __init__(self, replay: Replay):
        self._maps = replay.maps

    def executable_mappings(self, pid):
        try:
            return self._maps[int(pid)]
        except KeyError:
            raise OSError(f"pid {pid} has exited") from None


class ObjsCache:
    """The object cache the feeder reads: build ids by path, and each
    mapping's normalization base (start minus file offset)."""

    def __init__(self, replay: Replay):
        self.ids = {p: f"{i + 1:040x}"
                    for i, p in enumerate(replay.object_paths())}

    def build_ids(self, per_pid):
        return dict(self.ids)

    def get(self, pid, m):
        return _Object(m.start - m.offset)


class WindowStub:
    """What the window loop reads of a streamed window's snapshot."""

    def __init__(self, total: int, rows: int, time_ns: int,
                 period_ns: int, window_ns: int):
        self._total, self._rows = total, rows
        self.time_ns, self.period_ns, self.window_ns = (time_ns, period_ns,
                                                        window_ns)

    def total_samples(self) -> int:
        return self._total

    def __len__(self) -> int:
        return self._rows


class WindowFellBack(RuntimeError):
    """The feeder did not stream a measured window (it would be
    re-aggregated from a snapshot the replay does not build)."""


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    seconds: float
    t_start: float = 0.0
    cpu_start: float = 0.0
    # Per window (replay index): close start, completion, process CPU at
    # completion, samples, and the loop's record (encode ms, feeder s).
    close_start: dict = dataclasses.field(default_factory=dict)
    done: dict = dataclasses.field(default_factory=dict)
    samples: dict = dataclasses.field(default_factory=dict)
    records: dict = dataclasses.field(default_factory=dict)
    first_measured: int = 0
    # Per measured drain: (window, on_drain seconds, distinct rows handed
    # over). Per measured window: its distinct (pid, stack) rows, as the
    # replay drew them, and the nonzero counts its close returned.
    drains: list = dataclasses.field(default_factory=list)
    window_rows: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    # Generator CPU seconds, (end time, seconds) per window generated.
    gen_cpu: list = dataclasses.field(default_factory=list)
    counters_start: dict = dataclasses.field(default_factory=dict)
    counters_end: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    setup_s: float | None = None
    # Host-clock spans of the measured interval by kind (feed, close,
    # gen, window), for the trace reader.
    spans: dict = dataclasses.field(default_factory=dict)

    def span(self, kind: str, t0: float, t1: float) -> None:
        self.spans.setdefault(kind, []).append((t0, t1))

    def measured(self) -> list[int]:
        return sorted(w for w in self.close_start if w >= self.first_measured)

    def counted(self) -> list[int]:
        """Windows whose every pprof reached the writer in the interval."""
        end = self.t_start + self.seconds
        return [w for w in self.measured()
                if w in self.done and self.done[w] <= end]

    def closed_in_interval(self) -> list[int]:
        end = self.t_start + self.seconds
        return [w for w in self.measured() if self.close_start[w] <= end]


class Sink:
    """The writer: counts each window's profiles and keeps the bytes of the
    pids the check decodes. Windows are written in order from window 0."""

    def __init__(self):
        self.window = 0
        self.keep: dict[int, set] = {}
        self.pids: dict[int, np.ndarray] = {}
        self.bytes: dict[int, int] = {}
        self.kept: dict[int, dict] = {}
        self._pids: list[int] = []
        self._bytes = 0
        self._kept: dict = {}

    def expect(self, w: int, pids) -> None:
        self.keep[w] = {int(p) for p in pids}

    def write(self, labels, blob) -> None:
        pid = int(labels["pid"])
        self._pids.append(pid)
        self._bytes += len(blob)
        if pid in self.keep.get(self.window, ()):
            self._kept[pid] = bytes(blob)

    def window_done(self) -> int:
        w = self.window
        self.pids[w] = np.asarray(self._pids, np.int64)
        self.bytes[w] = self._bytes
        self.kept[w] = self._kept
        self.keep.pop(w, None)
        self._pids, self._bytes, self._kept = [], 0, {}
        self.window += 1
        return w


def _feeder_class(base):
    class BenchFeeder(base):
        """The port's feeder with each measured close's span and nonzero
        counts kept (a copy: the close returns a view); a measured window
        it does not stream stops the run."""

        run = None     # the Run whose spans a measured close records
        window = -1    # the replay's index of the window being closed

        def take_window_if_complete(self, snapshot):
            t0 = time.perf_counter()
            counts = super().take_window_if_complete(snapshot)
            if self.run is not None:
                self.run.span("close", t0, time.perf_counter())
                if counts is None:
                    raise WindowFellBack("a measured window was not "
                                         "streamed")
                counts = np.asarray(counts)
                self.run.counts[self.window] = counts[counts != 0]
            return counts

    return BenchFeeder


class Source:
    """The closed-loop capture: each poll() replays the next window's
    drains into the feeder, back to back, then returns the window."""

    def __init__(self, replay: Replay, feeder, sink: Sink, run: Run):
        self.replay, self.feeder, self.sink, self.run = (replay, feeder,
                                                         sink, run)
        self.next = 0
        self.measuring = False
        cfg = replay.cfg
        self.period_ns = PERIOD_NS_PER_S // int(cfg["sampling_hz"])
        self.window_ns = int(cfg["window_s"]) * PERIOD_NS_PER_S

    def poll(self):
        w = self.next
        self.next += 1
        t0, c0 = time.perf_counter(), time.thread_time()
        win = self.replay.window(w)
        t1 = time.perf_counter()
        self.run.gen_cpu.append((t1, time.thread_time() - c0))
        if self.measuring:
            self.run.span("gen", t0, t1)
        self.sink.expect(w, win.check_pids)
        if w == 0:
            return self._cold_snapshot(win)
        on_drain = self.feeder.on_drain
        for cols in win.drains:
            t0 = time.perf_counter()
            on_drain(cols)
            t1 = time.perf_counter()
            if self.measuring:
                self.run.drains.append((w, t1 - t0, len(cols[0])))
                self.run.span("feed", t0, t1)
        if self.measuring:
            self.run.window_rows[w] = win.rows
        self.feeder.window = w
        self.run.samples[w] = win.total
        self.run.close_start[w] = time.perf_counter()
        return WindowStub(win.total, win.rows, win.time_ns, self.period_ns,
                          self.window_ns)

    def _cold_snapshot(self, win):
        """The cold window as the live source's window-end snapshot: every
        row of the window and the mapping table of its pids, built by the
        port's own table builder."""
        from parca_agent_tpu_torch.capture.formats import WindowSnapshot
        from parca_agent_tpu_torch.capture.live import mapping_table_for_pids

        cols = win.columns
        table = mapping_table_for_pids(
            MapsCache(self.replay), ObjsCache(self.replay),
            np.unique(cols[0]).tolist())
        return WindowSnapshot(pids=cols[0], tids=cols[1], counts=cols[5],
                              user_len=cols[2], kernel_len=cols[3],
                              stacks=cols[4], mappings=table,
                              period_ns=self.period_ns,
                              window_ns=self.window_ns, time_ns=win.time_ns)


def counters(agg, feeder) -> dict:
    s = agg.stats
    f = feeder.stats
    return {"carry_hits": int(s.get("carry_hits", 0)),
            "carry_rows_in": int(s.get("carry_rows_in", 0)),
            "absorbed_samples": int(s.get("sketch_samples", 0)),
            "windows_fallback": int(f.get("windows_fallback", 0)),
            "feed_errors": int(f.get("feed_errors", 0)),
            "feed_hangs": int(f.get("feed_hangs", 0))}


def build_stack(cfg: dict, replay: Replay, sink: Sink, run: Run,
                device: str):
    """The port's window loop as the CLI wires it (module docs)."""
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.profiler.streaming import (
        StreamingWindowFeeder,
    )
    from parca_agent_tpu_torch.runtime import device_telemetry as dtel_mod
    from parca_agent_tpu_torch.runtime import trace as trace_mod
    from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
    from parca_agent_tpu_torch.utils.window_clock import windows_for

    window_s = float(cfg["window_s"])
    agg_cfg = cfg["aggregator"]
    agg = DictAggregator(capacity=int(agg_cfg["capacity"]),
                         overflow=agg_cfg["overflow"],
                         rotate_min_age=windows_for(6, window_s),
                         device=device, carry=bool(agg_cfg["carry"]))
    recorder = trace_mod.FlightRecorder()
    trace_mod.install(recorder)
    dtel_mod.install(dtel_mod.DeviceTelemetry(period_s=window_s,
                                              device=device))
    quarantine = QuarantineRegistry(window_s=window_s)
    period_ns = PERIOD_NS_PER_S // int(cfg["sampling_hz"])
    feeder = _feeder_class(StreamingWindowFeeder)(
        agg, MapsCache(replay), ObjsCache(replay),
        prebuild_period_ns=period_ns, quarantine=quarantine)
    source = Source(replay, feeder, sink, run)

    def on_window(record: dict) -> None:
        t = time.perf_counter()
        c = cpu_s()
        w = sink.window_done()
        run.done[w] = t
        run.records[w] = {"cpu": c, "mass": int(record["mass"]),
                          "encode_ms": float(record.get("encode_ms", 0.0)),
                          **({"handoff_ms": float(record["handoff_ms"])}
                             if "handoff_ms" in record else {}),
                          "path": record.get("path"),
                          "feeder_s": dict(record.get("feeder_s", {}))}

    loop = CPUProfiler(source, agg, profile_writer=sink,
                       encode_pipeline=True, on_window=on_window,
                       streaming_feeder=feeder, device_timeout_s=60.0,
                       quarantine=quarantine, trace_recorder=recorder,
                       duration_s=window_s, manage_gc=True)
    return agg, feeder, source, loop


def _flush(loop) -> None:
    if loop.pipeline is not None and not loop.pipeline.flush(FLUSH_TIMEOUT_S):
        raise RuntimeError("the encode pipeline did not flush")


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", process_age=None) -> dict:
    """Run one cell once; returns the measurements, the check's numbers
    and the set-up's parts (the caller prints the result line)."""
    import torch

    parts = {}
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.reset_peak_memory_stats(0)
    parts["cuda_start_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    replay = Replay(cfg, mix, seed)
    parts["population_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay.prepare()
    parts["windows_drawn_s"] = time.perf_counter() - t0
    run = Run(seconds=float(seconds))
    sink = Sink()
    agg, feeder, source, loop = build_stack(cfg, replay, sink, run, device)

    t0 = time.perf_counter()
    loop.run_iteration()           # the cold window: every stack inserted
    _flush(loop)
    parts["cold_window_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(int(mix["warm_windows"])):
        loop.run_iteration()
    _flush(loop)
    parts["warm_windows_s"] = time.perf_counter() - t0

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

    run.first_measured = source.next
    run.counters_start = counters(agg, feeder)
    source.measuring = True
    feeder.run = run
    run.cpu_start = cpu_s()
    run.t_start = time.perf_counter()
    if process_age is not None:
        run.setup_s = process_age()
    deadline = run.t_start + run.seconds
    anchor = time.perf_counter()
    with (torch.profiler.record_function("bench.measured") if trace
          else contextlib.nullcontext()):
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            loop.run_iteration()
            run.span("window", t0, time.perf_counter())
        _flush(loop)
    source.measuring = False
    feeder.run = None
    run.counters_end = counters(agg, feeder)
    if prof is not None:
        if device == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        import tempfile

        from benchmark import devtrace

        # The export goes to the run's TMPDIR and is gone once read.
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            run.trace = devtrace.analyze(f"{tmp}/trace.json", run.spans,
                                         anchor)
    peak = (int(torch.cuda.max_memory_allocated(0))
            if device == "cuda" else 0)
    loop.close()
    return {"run": run, "replay": replay, "sink": sink,
            "setup_parts": parts, "memory_peak_bytes": peak}


def check_outputs(out: dict, reference) -> dict:
    """The output check's numbers (each has the limit 0): every measured
    window's mass, its closed counts (sorted, against the reference's
    per-(pid, stack) sums over its drains) and its written pids against
    the reference's, the sampled pids' decoded pprof (samples, locations,
    mappings, period) against the reference's, and the guarantee (no
    sample absorbed, no window re-aggregated). Returns {"numbers": {...},
    "windows": n, "failed": n}.
    """
    run, sink, replay = out["run"], out["sink"], out["replay"]
    period_ns = PERIOD_NS_PER_S // int(replay.cfg["sampling_hz"])
    measured = run.measured()
    numbers = {"mass_gap": 0, "window_count_gap": 0, "pid_set_gap": 0,
               "stack_count_gap": 0, "pprof_gap": 0,
               "absorbed_samples": run.counters_end["absorbed_samples"],
               "fallback_windows": (run.counters_end["windows_fallback"]
                                    - run.counters_start["windows_fallback"])}
    ids = ObjsCache(replay).ids
    failed = 0
    fresh = None if replay.pool else Replay(replay.cfg, replay.mix,
                                            replay.seed)
    want_w = set(measured)
    last = max(measured) if measured else -1
    sums = {}     # a pooled window's reference counts, by its drains
    for w in range(last + 1):
        if fresh is None:
            if w not in want_w:
                continue
            win = replay.pooled(w)
            maps = replay.maps
        else:
            win = fresh.window(w)
            maps = fresh.maps
            if w not in want_w:
                continue
        before = dict(numbers)
        total, pids = reference.window_summary(win.drains)
        rec = run.records.get(w)
        written = sink.pids.get(w)
        if id(win.drains) not in sums:
            sums[id(win.drains)] = reference.window_counts(win.drains)
        want_counts = sums[id(win.drains)]
        if fresh is not None:
            sums.clear()
        got_counts = run.counts.get(w)
        if rec is None or written is None or got_counts is None:
            numbers["mass_gap"] += total
            numbers["window_count_gap"] += len(want_counts)
            numbers["pid_set_gap"] += len(pids)
            failed += 1
            continue
        numbers["mass_gap"] += abs(rec["mass"] - total)
        got_counts = np.sort(got_counts)
        k = min(len(got_counts), len(want_counts))
        numbers["window_count_gap"] += int(
            np.count_nonzero(got_counts[:k] != want_counts[:k])
            + abs(len(got_counts) - len(want_counts)))
        numbers["pid_set_gap"] += (
            len(np.setxor1d(written, pids)) + len(written)
            - len(np.unique(written)))
        want = reference.expected_profiles(
            win.drains, win.check_pids, lambda p: maps[p], ids)
        kept = sink.kept.get(w, {})
        for pid, exp in want.items():
            blob = kept.get(pid)
            if blob is None and not exp["mass"]:
                continue        # no sample this window: no profile due
            if blob is None:
                numbers["pprof_gap"] += 1
                numbers["stack_count_gap"] += len(exp["stacks"])
                continue
            try:
                prof = pprof_decode.decode(blob)
                got, used = pprof_decode.stacks(prof)
            except (ValueError, KeyError, IndexError):
                numbers["pprof_gap"] += 1
                numbers["stack_count_gap"] += len(exp["stacks"])
                continue
            keys = set(got) | set(exp["stacks"])
            numbers["stack_count_gap"] += sum(
                got.get(k) != exp["stacks"].get(k) for k in keys)
            numbers["pprof_gap"] += sum(
                used.get(s) != m for s, m in exp["mappings"].items())
            numbers["pprof_gap"] += len(set(used) - set(exp["mappings"]))
            numbers["pprof_gap"] += int(prof["period"] != period_ns)
        if numbers != before:
            failed += 1
    return {"numbers": numbers, "windows": len(measured), "failed": failed}
