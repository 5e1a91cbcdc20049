"""The port's endurance soak (bench_zoo/soak.py) and its web surface held
to parca_agent_tpu's.

Every case of tests/test_soak.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions: the soak's
accounting bars, the soak.tick chaos site, and the soak families on
/metrics and the never-red /healthz ``endurance`` section of the port's
web.py. Below them, both packages are compared: the soak source's window
stream, cycle after cycle, is the same for the same seed; the slope
regression is the same arithmetic; the same status renders the same
soak families; and the port's soak measures its slopes past the warm-up
with every bar held.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    pkg,
    plain,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

from parca_agent_tpu_torch.bench_zoo.soak import (  # noqa: E402
    WARMUP_WINDOWS,
    SoakStatus,
    run_soak,
)
from parca_agent_tpu_torch.web import AgentHTTPServer  # noqa: E402

port_cases("test_soak", globals())

pytestmark = pytest.mark.chaos

BOTH = ("jax", "port")


@pytest.mark.parametrize("names", [None, ["deep_stacks", "jit_churn"]])
def test_parity_soak_source_stream(names):
    """Three cycles of re-seeded schedules: each polled window's
    snapshot, the world it leaves (files, starttimes), the scenario it
    came from and the fed-sample count, equal in both packages."""
    out = {}
    for which in BOTH:
        soak = pkg(which, "bench_zoo.soak")
        fs = pkg(which, "utils.vfs").FakeFS()
        world = {}
        src = soak._SoakSource(1234, 0.25, fs, world, deadline=1.0,
                               names=names, clock=lambda: 0.0)
        got = []
        while src.cycles < 3:
            snap = src.poll()
            got.append((src.current, src.scenario, plain(snap),
                        src.samples_fed))
        out[which] = got, dict(fs.files), dict(world), src.cycles
    assert out["jax"] == out["port"]
    assert len(out["port"][0]) > 3


def test_parity_slope_regression_and_constants():
    jax_soak, port_soak = (pkg(w, "bench_zoo.soak") for w in BOTH)
    for attr in ("WARMUP_WINDOWS", "_MIN_SLOPE_POINTS",
                 "DEFAULT_RSS_SLOPE_LIMIT", "DEFAULT_LANE_SLOPE_LIMIT"):
        assert getattr(jax_soak, attr) == getattr(port_soak, attr)
    regs = {}
    for which, mod in zip(BOTH, (jax_soak, port_soak)):
        r = mod._SlopeReg()
        for i in range(50):
            r.add(i, 1000.0 + 3.5 * i + (i % 7) * 0.25)
        regs[which] = (r.n, r.sx, r.sy, r.sxx, r.sxy, r.slope())
    assert regs["jax"] == regs["port"]


def test_parity_soak_families_render_alike():
    """The same status, verdict and lanes render the same soak families
    in both packages' /metrics."""
    verdict = {"passed": True, "windows": 40}
    lanes = {"rss_bytes": 123456.0, "table_bytes": 4096.0,
             "identity_tracked_pids": 12.0}
    text = {}
    for which in BOTH:
        st = pkg(which, "bench_zoo.soak").SoakStatus()
        st.update(running=False, scenario="jit_churn",
                  scenarios=tuple(sorted(pkg(which, "bench_zoo").SCENARIOS)),
                  windows_elapsed=40, rss_bytes=654321, lanes=lanes,
                  verdict=verdict)
        text[which] = pkg(which, "web").render_metrics((), soak=st)
    assert text["jax"] == text["port"]
    assert 'parca_agent_soak_scenario{scenario="jit_churn"} 1' \
        in text["port"]


def test_soak_measures_slopes_past_the_warm_up_and_serves_them():
    """A short soak on the CPU runs far past the warm-up (its windows
    are small), so its slopes are measured and held; /healthz serves the
    verdict and the lanes, healthy."""
    status = SoakStatus()
    v = run_soak(wall_s=4.0, seed=1234, scale=0.25, window_s=1.0,
                 status=status, rss_slope_limit=1 << 20)
    assert v["windows"] > WARMUP_WINDOWS + 8
    assert v["slope_measured"]
    assert v["passed"], (v["bars"], v["bad_lanes"])
    assert v["samples_shipped"] == v["samples_fed"] > 0
    assert v["device"] == "cuda"  # asked for; the tests map it to the CPU
    assert set(v["lane_slopes"]) >= {
        "carry_bytes", "table_bytes", "id_meta_bytes", "key_index_bytes",
        "pid_registry_bytes", "identity_tracked_pids",
        "quarantine_entries"}
    srv = AgentHTTPServer(port=0, soak=status)
    srv.start()
    try:
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz", timeout=5).read())
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read().decode()
    finally:
        srv.stop()
    assert body["status"] == "healthy"
    assert body["endurance"]["windows_elapsed"] == v["windows"]
    assert body["endurance"]["verdict"]["slope_measured"] is True
    assert f"parca_agent_soak_windows_elapsed {v['windows']}" in metrics
