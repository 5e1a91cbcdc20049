"""The hotspot rollup service's end-to-end drill, on the port.

The port's copy of parca_agent_tpu/tools/hotspot_smoke.py. Runs a short
session of the port's window loop (synthetic capture, the dict
aggregator on the card, fast encode, encode pipeline, hotspot store,
HTTP surface) and asserts the read-path contract (docs/hotspots.md):

  1. Every shipped window folds on the encode worker
     (windows_folded == windows shipped, zero fold errors).
  2. `/hotspots` serves top-K answers with human-readable frame context
     and candidate-exact counts; the label selector filters.
  3. Bad parameters (non-numeric k, negative range, unknown scope) are
     400s, never 500s.
  4. `scope=fleet` with no fleet attached degrades to a node-local
     answer flagged stale (fallback=local) — the endpoint always
     answers.
  5. `/metrics` exposes the rollup gauges in the strict grouped-family
     format and `/healthz` carries a `hotspots` section WITHOUT turning
     readiness red.

Exit 0 on success; raises (exit 1) with a readable assertion otherwise;
no fallback stands behind the card.
The port's dictionary runs on ``--device`` (default ``cuda``; ``cpu``
for a host-only run). Run: ``python -m
parca_agent_tpu_torch.tools.hotspot_smoke [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request


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
    from parca_agent_tpu_torch.web import AgentHTTPServer

    n_windows = int(os.environ.get("PARCA_HOTSPOT_SMOKE_WINDOWS", "6"))
    snaps = [generate(SyntheticSpec(
        n_pids=6, n_unique_stacks=256, n_rows=256, total_samples=1024,
        mean_depth=8, seed=i)) for i in range(n_windows)]

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
        window_s=10.0)
    prof = CPUProfiler(
        source=Src(),
        aggregator=DictAggregator(capacity=1 << 12, device=device),
        profile_writer=Sink(), duration_s=0.0, encode_pipeline=True,
        hotspot_store=store)

    http = AgentHTTPServer(port=0, profilers=[prof], hotspots=store)
    http.start()
    base = f"http://127.0.0.1:{http.port}"

    def fetch(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.read().decode()

    def status_of(path) -> int:
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        for _ in range(n_windows):
            assert prof.run_iteration()
            # Per-window flush: the smoke drives windows back-to-back;
            # a backpressure fallback would (correctly) skip a fold.
            assert prof.pipeline.flush(30)
        assert prof.pipeline.quiesce(30)

        # -- every window folded on the worker -------------------------------
        pipe = prof.pipeline.stats
        assert pipe["windows_rolled"] == n_windows, pipe
        assert pipe["rollup_errors"] == 0, pipe
        assert pipe["windows_lost"] == 0, pipe
        assert store.stats["windows_folded"] == n_windows
        print(f"hotspot-smoke: {n_windows} windows folded on the encode "
              f"worker (last fold {store.stats['last_fold_s'] * 1e3:.2f} ms)")

        # -- the query API ---------------------------------------------------
        ans = json.loads(fetch("/hotspots?k=10"))
        assert ans["scope"] == "local" and ans["entries"], ans
        assert ans["total_samples"] == n_windows * 1024
        top = ans["entries"][0]
        assert top["count"] >= ans["entries"][-1]["count"]
        assert top["frames"], "top entry has no frame context"
        assert top["labels"] and "pid" in top["labels"]
        print(f"hotspot-smoke: /hotspots top-{ans['k']} served from "
              f"level={ans['level']} (top count {top['count']}, "
              f"frame[0]={top['frames'][0]!r})")

        # Label selector: the top pid's share only.
        pid = top["labels"]["pid"]
        sel = json.loads(fetch(f"/hotspots?k=10&pid={pid}"))
        assert sel["entries"], sel
        assert all(e["labels"]["pid"] == pid for e in sel["entries"])
        none = json.loads(fetch("/hotspots?k=10&pid=no-such-pid"))
        assert none["entries"] == []
        print(f"hotspot-smoke: label selector pid={pid} -> "
              f"{len(sel['entries'])} entries, bogus selector -> 0")

        # -- parameter hygiene -----------------------------------------------
        for bad in ("/hotspots?k=abc", "/hotspots?range=-5",
                    "/hotspots?scope=galaxy", "/hotspots?t0=9&t1=1",
                    "/hotspots?range=nan"):
            code = status_of(bad)
            assert code == 400, f"{bad} -> {code}, want 400"
        print("hotspot-smoke: bad parameters all 400")

        # -- fleet scope degrades, never refuses -----------------------------
        fleet = json.loads(fetch("/hotspots?scope=fleet"))
        assert fleet["fallback"] == "local" and fleet["stale"], fleet
        assert fleet["entries"], "fleet fallback served no entries"
        print("hotspot-smoke: fleet scope with no fleet -> node-local "
              "answer flagged stale")

        # -- observability ---------------------------------------------------
        metrics = fetch("/metrics")
        assert "# TYPE parca_agent_hotspot_level_bytes gauge" in metrics
        assert 'parca_agent_hotspot_level_summaries{level="window"' \
            in metrics
        assert "parca_agent_hotspot_windows_folded_total" in metrics
        healthz = json.loads(fetch("/healthz"))
        assert "hotspots" in healthz, healthz
        assert healthz["hotspots"]["windows_folded"] == n_windows
        assert status_of("/healthz") == 200
        print("hotspot-smoke: /metrics gauges present, /healthz hotspots "
              "section reported, readiness untouched")

        assert prof.crashed is None and prof.last_error is None
        print("hotspot-smoke: PASS")
        return 0
    finally:
        http.stop()
        if prof.pipeline is not None:
            prof.pipeline.close(10)


if __name__ == "__main__":
    sys.exit(main())
