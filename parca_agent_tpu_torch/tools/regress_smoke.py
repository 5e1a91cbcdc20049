"""The regression sentinel's end-to-end drill, on the port.

The port's copy of parca_agent_tpu/tools/regress_smoke.py. Runs a short
session of the port's window loop (synthetic capture, the dict
aggregator on the card, fast encode, encode pipeline, hotspot store,
regression sentinel, alerts sink, HTTP surface) over a controlled
window stream — a stationary baseline phase, a clean control phase,
then a 10x shift on exactly ONE stack of one binary — and asserts the
judgment contract (docs/regression.md):

  1. Every shipped window folds into the sentinel on the encode worker
     (zero fold errors, zero windows lost, pprof ship untouched).
  2. The clean control windows produce ZERO verdicts (the noise floor,
     min-count, min-ratio, and sketch-bound gates all hold).
  3. The injected shift produces EXACTLY ONE `regressed` verdict,
     attributed to the right build-id, served on `/diff`.
  4. The alerts sink lands that verdict as a JSONL record on disk.
  5. `/diff` range mode answers over the hotspot store's levels with
     exact/estimate bounds; bad parameters are 400s, never 500s.
  6. `/metrics` exposes the parca_agent_regression_* families and
     `/healthz` carries a `regression` section WITHOUT turning
     readiness red.

Exit 0 on success; raises (exit 1) with a readable assertion otherwise;
no fallback stands behind the card.
The port's dictionary runs on ``--device`` (default ``cuda``; ``cpu``
for a host-only run). Run: ``python -m
parca_agent_tpu_torch.tools.regress_smoke [--device cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import urllib.error
import urllib.request

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the dictionary's device (cuda, or cpu)")
    device = ap.parse_args(argv).device

    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
    from parca_agent_tpu_torch.ops.sketch import CountMinSpec
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.runtime.hotspots import (
        HotspotSpec,
        HotspotStore,
    )
    from parca_agent_tpu_torch.runtime.regression import (
        RegressionSentinel,
        RegressionSpec,
    )
    from parca_agent_tpu_torch.sinks import AlertsSink, PprofSink, SinkRegistry
    from parca_agent_tpu_torch.web import AgentHTTPServer

    baseline_n = 3
    control_n = 4
    shifted_n = 2
    window_s = 10.0
    base = generate(SyntheticSpec(
        n_pids=6, n_unique_stacks=256, n_rows=256, total_samples=4096,
        mean_depth=8, seed=4))
    t0_ns = base.time_ns

    # The victim: the hottest row whose leaf lives in shared object 1
    # (synthetic build id f"{2:040x}" — see capture/synthetic.py).
    lo, hi = 0x0000_7F00_0000_0000, 0x0000_7F00_0000_0000 + (1 << 24)
    leaf = base.stacks[:, 0]
    in_obj = np.flatnonzero((leaf >= lo) & (leaf < hi))
    victim = int(in_obj[np.argmax(base.counts[in_obj])])
    victim_build = f"{2:040x}"

    def window(w: int, shifted: bool):
        counts = base.counts.copy()
        if shifted:
            counts[victim] *= 10
        return dataclasses.replace(
            base, counts=counts, time_ns=t0_ns + int(w * window_s * 1e9))

    snaps = [window(w, False) for w in range(baseline_n + control_n)]
    snaps += [window(baseline_n + control_n + i, True)
              for i in range(shifted_n)]
    # One trailing clean window seals the last shifted rollup.
    snaps.append(window(baseline_n + control_n + shifted_n, False))
    n_windows = len(snaps)

    class Src:
        def __init__(self):
            self.snaps = list(snaps)

        def poll(self):
            return self.snaps.pop(0) if self.snaps else None

    class Sink:
        def write(self, labels, blob):
            pass

    store = HotspotStore(
        spec=HotspotSpec(k=10, candidates=128,
                         cm=CountMinSpec(depth=4, width=1 << 10)),
        window_s=window_s)
    sent = RegressionSentinel(spec=RegressionSpec(
        interval_s=window_s, baseline_rollups=baseline_n, min_count=4,
        cm=CountMinSpec(depth=4, width=1 << 10)))
    alerts_path = os.path.join(tempfile.mkdtemp(prefix="regress-smoke-"),
                               "alerts.jsonl")
    sinks = SinkRegistry([PprofSink(),
                          AlertsSink(alerts_path, sentinel=sent)])
    prof = CPUProfiler(
        source=Src(),
        aggregator=DictAggregator(capacity=1 << 13, device=device),
        profile_writer=Sink(), duration_s=0.0, encode_pipeline=True,
        hotspot_store=store, regression=sent, sinks=sinks)

    http = AgentHTTPServer(port=0, profilers=[prof], hotspots=store,
                           regression=sent, sinks=sinks)
    http.start()
    base_url = f"http://127.0.0.1:{http.port}"

    def fetch(path):
        with urllib.request.urlopen(base_url + path, timeout=10) as r:
            return r.read().decode()

    def status_of(path) -> int:
        try:
            with urllib.request.urlopen(base_url + path, timeout=10) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        for w in range(n_windows):
            assert prof.run_iteration()
            assert prof.pipeline.flush(30)
            if w == baseline_n + control_n - 1:
                # End of the clean control: baseline frozen, judgment
                # live, and NOT ONE verdict fired.
                clean = json.loads(fetch("/diff"))
                assert clean["verdicts"] == [], clean["verdicts"]
                assert any(g["baseline_id"] for g in clean["groups"])
                print(f"regress-smoke: {control_n - baseline_n + 1} "
                      "judged clean rollups, zero verdicts (control "
                      "holds)")
        assert prof.pipeline.quiesce(30)

        # -- the fold contract ----------------------------------------------
        pipe = prof.pipeline.stats
        assert pipe["windows_lost"] == 0, pipe
        assert pipe["rollup_errors"] == 0, pipe
        assert sent.stats["fold_errors"] == 0
        assert sent.stats["windows_folded"] == n_windows
        print(f"regress-smoke: {n_windows} windows folded on the encode "
              f"worker (last fold "
              f"{sent.stats['last_fold_s'] * 1e3:.2f} ms)")

        # -- exactly one regressed verdict, right build ----------------------
        body = json.loads(fetch("/diff"))
        verdicts = body["verdicts"]
        assert len(verdicts) == 1, verdicts
        v = verdicts[0]
        assert v["kind"] == "regressed", v
        assert v["build"] == victim_build, v
        assert v["current"] > v["baseline"] * 1.5
        assert v["delta"] > v["threshold"]
        print(f"regress-smoke: the 10x shift -> exactly one regressed "
              f"verdict on build {v['build'][:8]}… "
              f"(baseline {v['baseline']}, current {v['current']}, "
              f"threshold {v['threshold']})")

        # -- the alerts sink landed it as JSONL ------------------------------
        with open(alerts_path) as f:
            records = [json.loads(ln) for ln in f]
        assert len(records) == 1 and records[0]["kind"] == "regressed"
        assert records[0]["build"] == victim_build
        print(f"regress-smoke: verdict on disk as JSONL "
              f"({alerts_path})")

        # -- range mode over the hotspot levels ------------------------------
        a0 = (t0_ns / 1e9) + (baseline_n + control_n) * window_s
        a1 = a0 + shifted_n * window_s
        b0, b1 = t0_ns / 1e9, a0
        rng_body = json.loads(fetch(
            f"/diff?a0={a0}&a1={a1}&b0={b0}&b1={b1}&k=5"))
        assert rng_body["mode"] == "range" and rng_body["entries"]
        top = rng_body["entries"][0]
        assert top["delta"] > 0
        assert top["delta_min"] <= top["delta"] <= top["delta_max"]
        print(f"regress-smoke: /diff range mode served "
              f"{len(rng_body['entries'])} bounded deltas from "
              f"level-backed answers (top delta {top['delta']})")

        # -- parameter hygiene -----------------------------------------------
        for bad in ("/diff?kind=bogus", "/diff?limit=0",
                    "/diff?a0=1&a1=2", "/diff?a0=1&a1=2&b0=3&b1=nan",
                    "/diff?since=inf", "/diff?tenant=%00bad"):
            code = status_of(bad)
            assert code == 400, f"{bad} -> {code}, want 400"
        print("regress-smoke: bad parameters all 400")

        # -- observability ---------------------------------------------------
        metrics = fetch("/metrics")
        assert "# TYPE parca_agent_regression_windows_folded_total " \
               "counter" in metrics
        assert 'parca_agent_regression_verdicts_total{kind="regressed"}'\
            " 1" in metrics
        assert "parca_agent_regression_baselines " in metrics
        healthz = json.loads(fetch("/healthz"))
        assert "regression" in healthz, healthz
        assert healthz["regression"]["fold_errors"] == 0
        assert healthz["regression"]["verdicts"]["regressed"] == 1
        assert status_of("/healthz") == 200
        print("regress-smoke: /metrics families present, /healthz "
              "regression section reported, readiness untouched")

        assert prof.crashed is None and prof.last_error is None
        print("regress-smoke: PASS")
        return 0
    finally:
        http.stop()
        if prof.pipeline is not None:
            prof.pipeline.close(10)


if __name__ == "__main__":
    sys.exit(main())
