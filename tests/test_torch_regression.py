"""The port's regression sentinel (runtime/regression.py) held to
parca_agent_tpu's.

Every case of tests/test_regression.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions. Below them,
both packages' real window loops take the same windows, one binary's
stacks shifted 8x from the sixth on, with the hotspot store, the
sentinel and the sinks attached as the CLI attaches them; the verdicts,
the sentinel's state, the baseline file's bytes (and each package
adopting the other's), the alerts JSONL and the /diff bodies are
compared exactly, and so are the regression.fold and regression.baseline
chaos sites' counters.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_port_cases import (  # noqa: E402
    analytics_run,
    pkg,
    plain,
    port_cases,
    port_on_cpu,  # noqa: F401 - autouse fixture
)

port_cases("test_regression", globals())

BOTH = ("jax", "port")
TIMINGS = ("query_s", "last_fold_s", "last_emit_s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' loops over the same shifted windows."""
    root = tmp_path_factory.mktemp("regression")
    return {which: analytics_run(which, root / which) for which in BOTH}


def test_parity_verdicts_and_sentinel_state(runs):
    got = {w: (plain(r.sentinel.verdicts(), TIMINGS),
               plain(r.sentinel.metrics(), TIMINGS),
               plain(r.sentinel.snapshot(), TIMINGS))
           for w, r in runs.items()}
    assert got["jax"] == got["port"]
    verdicts = got["port"][0]["verdicts"][1]
    # The shifted binary, and only it, is judged.
    assert verdicts
    assert {v["kind"] for v in verdicts} <= {"regressed", "new_hotspot",
                                             "drifted"}
    assert len({v["build"] for v in verdicts}) == 1


def test_parity_baseline_file_bytes_and_cross_adoption(runs, tmp_path):
    """The saved baseline files are equal byte for byte, and each
    package adopts the other's into the same state."""
    files = {w: open(os.path.join(r.root, "baselines.bin"), "rb").read()
             for w, r in runs.items()}
    assert files["jax"] and files["jax"] == files["port"]
    adopted = {}
    for which, other in (("jax", "port"), ("port", "jax")):
        rg = pkg(which, "runtime.regression")
        spec = runs[which].sentinel.spec
        path = tmp_path / f"{other}-in-{which}.bin"
        path.write_bytes(files[other])
        warm = rg.RegressionSentinel(spec=spec, path=str(path),
                                     clock=runs[which].sentinel._clock)
        adopted[which] = (plain(warm.verdicts(), TIMINGS),
                          plain(warm.metrics(), TIMINGS))
        assert warm.metrics()["baselines_adopted"] >= 1
        # Saved again, the adopted state writes the same bytes.
        assert warm.save()
        adopted[which] += (path.read_bytes() == files[other],)
    assert adopted["jax"] == adopted["port"]
    assert adopted["port"][2]


def test_parity_alerts_jsonl_bytes(runs):
    text = {w: open(os.path.join(r.root, "alerts.jsonl"), "rb").read()
            for w, r in runs.items()}
    assert text["port"] and text["jax"] == text["port"]
    records = [json.loads(ln) for ln in text["port"].splitlines()]
    assert {r["kind"] for r in records} & {"regressed", "new_hotspot"}


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


DIFF_PATHS = [
    "/diff", "/diff?kind=regressed", "/diff?kind=improved",
    "/diff?tenant=default", "/diff?limit=1", "/diff?since=0",
    "/diff?a0=0&a1=1e12&b0=0&b1=1", "/diff?a0=0&a1=1e12&b0=0&b1=1&k=3",
    "/diff?kind=bogus", "/diff?limit=0", "/diff?since=nan",
    "/diff?a0=1&a1=2", "/diff?kin=regressed", "/diff?tenant=%00bad",
]


def test_parity_diff_bodies_metrics_and_healthz(runs):
    """/diff in both packages' servers over the runs' sentinels and
    stores: the same status and body for each form, 400s included; the
    regression and sink families on /metrics; the /healthz sections."""
    got = {}
    for which, r in runs.items():
        web = pkg(which, "web")
        srv = web.AgentHTTPServer(port=0, profilers=[],
                                  regression=r.sentinel, hotspots=r.store,
                                  sinks=r.registry)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            bodies = [(code, plain(body, TIMINGS)
                       if isinstance(body, dict) else body)
                      for code, body in (_get(base, p) for p in DIFF_PATHS)]
            health = _get(base, "/healthz")[1]
        finally:
            srv.stop()
        text = web.render_metrics([], regression=r.sentinel,
                                  sinks=r.registry)
        fams = [ln for ln in text.splitlines()
                if ("parca_agent_regression_" in ln
                    or "parca_agent_sink_" in ln)
                and "_seconds" not in ln]
        got[which] = bodies, fams, {k: health[k] for k in
                                    ("regression", "sinks")}
    assert [c for c, _ in got["port"][0]] == [200] * 8 + [400] * 6
    assert got["port"][1]
    assert got["jax"] == got["port"]


@pytest.mark.parametrize("spec", ["regression.fold:error:p=0.5",
                                  "regression.baseline:error:p=0.5"])
def test_parity_regression_chaos_counters(spec, tmp_path):
    """The sentinel's chaos sites under the same seeded rules: the same
    windows go unjudged or unsaved, counted the same."""
    got = {}
    for which in BOTH:
        faults = pkg(which, "utils.faults")
        faults.install(faults.FaultInjector.from_spec(spec, seed=5))
        try:
            r = analytics_run(which, tmp_path / which, sinks=False)
            fired = faults.get().stats()
        finally:
            faults.install(None)
        m = r.sentinel.metrics()
        got[which] = fired, plain(m, TIMINGS), \
            plain(r.sentinel.verdicts(), TIMINGS), \
            r.pipeline.stats["windows_lost"]
    counted = ("fold_errors" if "fold" in spec else "baseline_save_errors")
    assert got["port"][1][counted] > 0 and got["port"][3] == 0
    assert got["jax"] == got["port"]
