"""The window flight recorder's end-to-end drill, on the port.

The port's copy of parca_agent_tpu/tools/trace_smoke.py. Runs a short
traced session through the port's window loop (synthetic capture, the
dict aggregator on the card, fast encode, encode pipeline, HTTP
surface) and asserts the observability contract
(docs/observability.md):

  1. `/debug/windows` returns >= 3 COMPLETE traces, each carrying every
     mandatory span (drain, close, prepare, encode, ship).
  2. `/metrics` parses and serves the stage-duration histogram for >= 6
     stages.
  3. One injected slow window (a `device.dispatch` hang well past the
     primed p99 budget) produces EXACTLY ONE incident file containing
     the offending trace and a self-profile — and zero windows are
     lost.
  4. The device flight recorder (docs/observability.md "device flight
     recorder") latched >= 1 compile per exercised kernel during the
     primed session, with zero recompiles on the pinned geometry, and
     `/metrics` serves the kernel/transfer/window-budget families with
     compile and execute separable.
  5. `/debug/device` returns the telemetry snapshot + timeline.
  6. One injected shape change (a window at a different row count — a
     new feed signature on a latched kernel) produces EXACTLY ONE
     `recompile_storm` incident file — and still zero windows lost.

Exit 0 on success; raises (exit 1) with a readable assertion otherwise;
no fallback stands behind the card.
The port's dictionary runs on ``--device`` (default ``cuda``; ``cpu``
for a host-only run). Run: ``python -m
parca_agent_tpu_torch.tools.trace_smoke [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the dictionary's device (cuda, or cpu)")
    device = ap.parse_args(argv).device

    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.runtime.trace import (
        MANDATORY_SPANS,
        FlightRecorder,
    )
    from parca_agent_tpu_torch.runtime import device_telemetry as dtel_mod
    from parca_agent_tpu_torch.runtime import trace as trace_mod
    from parca_agent_tpu_torch.utils import faults
    from parca_agent_tpu_torch.web import AgentHTTPServer

    n_prime = int(os.environ.get("PARCA_TRACE_SMOKE_WINDOWS", "8"))
    tmp = tempfile.mkdtemp(prefix="parca-trace-smoke-")
    incident_dir = os.path.join(tmp, "incidents")

    snaps = [generate(SyntheticSpec(
        n_pids=6, n_unique_stacks=256, n_rows=256, total_samples=1024,
        mean_depth=8, seed=i)) for i in range(n_prime + 1)]

    class Src:
        def __init__(self):
            self.snaps = list(snaps)

        def poll(self):
            return self.snaps.pop(0) if self.snaps else None

    shipped = []

    class Sink:
        def write(self, labels, blob):
            shipped.append(len(blob))

    # Pre-warm the aggregation path OUTSIDE the traced session: the
    # first window's one-time costs (the CUDA context, each kernel
    # library's load) would otherwise dominate the close histogram's
    # p99 and hide the injected stall behind an inflated budget — a
    # production agent is past them within its first window too.
    agg = DictAggregator(capacity=1 << 12, device=device)
    agg.window_counts(generate(SyntheticSpec(
        n_pids=6, n_unique_stacks=256, n_rows=256, total_samples=1024,
        mean_depth=8, seed=99)))

    recorder = FlightRecorder(
        ring=64, min_count=4, min_duration_s=0.05, slow_multiple=5.0,
        incident_dir=incident_dir,
        # Short enough that the recompile drill's capture (6 below) is
        # not rate-suppressed by the slow-window incident (3) before it.
        incident_interval_s=0.5,
        # A fast self-profile keeps the smoke quick; the incident still
        # carries a REAL gzipped pprof of the agent's threads.
        self_profile=None, self_profile_s=0.3,
        context=lambda: {"smoke": True})
    trace_mod.install(recorder)

    # The device flight recorder rides the whole primed session: install
    # AFTER the pre-warm above (whose one-shot geometry would latch a
    # second signature) so the primed loop's pinned geometry latches
    # exactly one signature per kernel. Its own incident pre-filter is
    # effectively off (one per hour) — the shape-change drill below must
    # surface exactly its FIRST recompile.
    dtel = dtel_mod.DeviceTelemetry(
        period_s=1.0, ring=256, incident_interval_s=3600.0, device=device)
    dtel_mod.install(dtel)

    src = Src()
    prof = CPUProfiler(
        source=src, aggregator=agg,
        profile_writer=Sink(), duration_s=0.0, encode_pipeline=True,
        trace_recorder=recorder)

    http = AgentHTTPServer(port=0, profilers=[prof], recorder=recorder,
                           device_telemetry=dtel)
    http.start()
    base = f"http://127.0.0.1:{http.port}"

    def fetch(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.read().decode()

    try:
        # -- prime: n_prime clean windows ------------------------------------
        for _ in range(n_prime):
            assert prof.run_iteration()
            # Per-window flush: the smoke drives windows back-to-back,
            # and a window that finds the worker still busy is (rightly)
            # encoded inline, without the worker's prepare span — on a
            # loaded host that would fail the span check below.
            assert prof.pipeline.flush(30)

        body = json.loads(fetch("/debug/windows"))
        complete = [t for t in body["traces"]
                    if t["complete"] and "error" not in t]
        assert len(complete) >= 3, f"only {len(complete)} complete traces"
        for t in complete:
            stages = {s["stage"] for s in t["spans"]}
            missing = set(MANDATORY_SPANS) - stages
            assert not missing, f"trace {t['seq']} missing spans {missing}"
        print(f"trace-smoke: {len(complete)} complete traces, "
              f"all mandatory spans present")

        metrics = fetch("/metrics")
        stages_in_metrics = {
            line.split('stage="', 1)[1].split('"', 1)[0]
            for line in metrics.splitlines()
            if line.startswith(
                "parca_agent_window_stage_duration_seconds_bucket")}
        assert len(stages_in_metrics) >= 6, \
            f"only {len(stages_in_metrics)} stages in /metrics: " \
            f"{sorted(stages_in_metrics)}"
        assert "# TYPE parca_agent_window_stage_duration_seconds " \
            "histogram" in metrics
        print(f"trace-smoke: /metrics histograms for "
              f"{len(stages_in_metrics)} stages: "
              f"{sorted(stages_in_metrics)}")

        # -- device flight recorder: primed-session truth --------------------
        snap_t = dtel.snapshot()
        kernels = snap_t["kernels"]
        assert kernels, "device telemetry saw no kernel dispatches"
        assert "feed_probe" in kernels, f"no feed_probe in {sorted(kernels)}"
        latched = {n for n, i in kernels.items() if i["shapes_latched"]}
        assert "feed_probe" in latched
        for name in latched:
            assert kernels[name]["compiles"] >= 1, \
                f"kernel {name} latched no compile: {kernels[name]}"
        assert snap_t["stats"]["recompiles_total"] == 0, \
            f"pinned geometry recompiled: {snap_t['stats']}"
        assert snap_t["stats"]["record_errors"] == 0
        assert snap_t["window_budget"]["windows_total"] >= n_prime
        assert any(d.get("h2d") or d.get("d2h")
                   for d in snap_t["transfers"].values()), \
            f"no transfer bytes accounted: {snap_t['transfers']}"
        for family in ("parca_agent_kernel_duration_seconds",
                       "parca_agent_kernel_compiles_total",
                       "parca_agent_transfer_bytes_total",
                       "parca_agent_window_budget_windows_total",
                       "parca_agent_device_info"):
            assert f"# TYPE {family} " in metrics, \
                f"family {family} missing from /metrics"
        kernel_events = {
            (line.split('kernel="', 1)[1].split('"', 1)[0],
             line.split('event="', 1)[1].split('"', 1)[0])
            for line in metrics.splitlines()
            if line.startswith(
                "parca_agent_kernel_duration_seconds_count")}
        assert any(e == "compile" for _, e in kernel_events) \
            and any(e == "execute" for _, e in kernel_events), \
            f"compile/execute not separable in /metrics: {kernel_events}"
        device = json.loads(fetch("/debug/device"))
        assert device["identity"]["platform"]
        assert device["kernels"] and device["timeline"]["events"]
        print(f"trace-smoke: device telemetry latched "
              f"{sorted(kernels)} "
              f"({sum(i['compiles'] for i in kernels.values())}"
              f" compiles, 0 recompiles), "
              f"{len(device['timeline']['events'])} timeline events")

        # -- injected slow window --------------------------------------------
        # An 8 s device.dispatch hang: the primed close p99 is
        # inflated by first launches (the first loop windows pay the
        # delta close's first launch, and a loaded host has pushed that
        # tail past 400 ms), so the 5x budget can reach ~2 s — the
        # hang must clear it decisively while staying well under the
        # 60 s watchdog. The window still ships, the detector fires,
        # exactly one incident lands.
        faults.install(faults.FaultInjector.from_spec(
            "device.dispatch:hang:ms=8000,count=1"))
        try:
            assert prof.run_iteration()
            assert prof.pipeline.flush(30)
        finally:
            faults.install(None)

        deadline = time.monotonic() + 15
        files = []
        while time.monotonic() < deadline:
            files = (sorted(os.listdir(incident_dir))
                     if os.path.isdir(incident_dir) else [])
            if files and not recorder._dumping:
                break
            time.sleep(0.05)
        assert len(files) == 1, f"expected exactly 1 incident, got {files}"
        incident = json.loads(
            open(os.path.join(incident_dir, files[0])).read())
        assert incident["kind"] == "slow_window"
        assert incident["trace"] is not None
        assert incident["trace"]["seq"] == n_prime + 1
        assert incident["self_profile_pprof_gz_b64"], "no self-profile"
        assert incident["context"] == {"smoke": True}
        slow_stages = [s["stage"] for s in incident["trace"]["spans"]
                       if s.get("slow")]
        assert slow_stages, "no span marked slow in the incident trace"

        # -- nothing lost ----------------------------------------------------
        assert prof.crashed is None and prof.last_error is None
        assert prof.pipeline.stats["windows_lost"] == 0
        assert prof.metrics.attempts_total == n_prime + 1
        done = recorder.stats["traces_completed"]
        assert done == n_prime + 1, \
            f"{done} of {n_prime + 1} traces completed"
        one = json.loads(fetch(f"/debug/trace/{n_prime + 1}"))
        assert one["meta"].get("slow_stage") in ("close", "total")
        print(f"trace-smoke: slow window produced exactly 1 incident "
              f"({files[0]}), slow stage "
              f"{one['meta']['slow_stage']!r}, windows_lost=0")

        # -- injected shape change -> one recompile incident -----------------
        # A window at twice the row count is a NEW feed signature on the
        # latched feed_probe kernel: the detector must count it and land
        # exactly one recompile_storm incident (the telemetry pre-filter
        # admits only its first recompile; the recorder's 0.5 s interval
        # has passed since the slow-window capture above).
        time.sleep(0.6)
        src.snaps.append(generate(SyntheticSpec(
            n_pids=6, n_unique_stacks=512, n_rows=512,
            total_samples=2048, mean_depth=8, seed=500)))
        assert prof.run_iteration()
        assert prof.pipeline.flush(30)
        assert dtel.stats["recompiles_total"] >= 1, \
            f"shape change latched no recompile: {dtel.stats}"

        deadline = time.monotonic() + 15
        storms = []
        while time.monotonic() < deadline:
            names = (sorted(os.listdir(incident_dir))
                     if os.path.isdir(incident_dir) else [])
            storms = []
            for name in names:
                with open(os.path.join(incident_dir, name)) as f:
                    body = json.load(f)
                if body["kind"] == "recompile_storm":
                    storms.append((name, body))
            if storms and not recorder._dumping:
                break
            time.sleep(0.05)
        assert len(storms) == 1, \
            f"expected exactly 1 recompile incident, got " \
            f"{[n for n, _ in storms]}"
        storm = storms[0][1]
        assert storm["detail"]["kernel"] == "feed_probe", storm["detail"]
        assert storm["detail"]["shapes_latched"] >= 2
        assert prof.pipeline.stats["windows_lost"] == 0
        assert prof.metrics.attempts_total == n_prime + 2
        print(f"trace-smoke: shape change produced exactly 1 recompile "
              f"incident ({storms[0][0]}, kernel "
              f"{storm['detail']['kernel']!r}), windows_lost=0")
        print("trace-smoke: PASS")
        return 0
    finally:
        http.stop()
        trace_mod.install(None)
        dtel_mod.install(None)


if __name__ == "__main__":
    sys.exit(main())
