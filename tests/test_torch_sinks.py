"""The port's output sinks (sinks/) held to parca_agent_tpu's.

Every case of tests/test_sinks.py runs here through the port
(tests/torch_port_cases.py), with the original's assertions, but one:
``test_scalar_path_windows_counted_as_skipped``. The original reaches
its scalar path through pipeline backpressure and its CPU fallback
aggregator; the port has no fallback (a busy worker is waited out and
the window encoded inline), and its scalar path is the inline encode's
soft deadline, which the port's case drives instead.

Below them, both packages' real window loops take the same windows with
the sinks attached as the CLI attaches them, and the AutoFDO profdata
files, the series records and the pprof bytes are compared exactly; the
port's pprof bytes with the secondaries equal its bytes without them,
and the sink.emit and sink.flush chaos sites count the same in both.
"""

from __future__ import annotations

import os
import threading

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

original = port_cases(
    "test_sinks", globals(),
    replaced=("test_scalar_path_windows_counted_as_skipped",))

BOTH = ("jax", "port")
TIMINGS = ("last_emit_s",)


def test_scalar_path_windows_counted_as_skipped():
    """A window past the inline encode's soft deadline ships scalar
    profiles: no prepared window, so the registry counts the sinks'
    coverage gap; the next window reaches the secondaries."""
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator
    from parca_agent_tpu_torch.capture.replay import ReplaySource
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.sinks import PprofSink, SeriesSink, SinkRegistry

    snap = original._snap(seed=10)
    series = SeriesSink()
    reg = SinkRegistry([PprofSink(), series])
    w = original.Collect()
    p = CPUProfiler(ReplaySource([snap, snap]),
                    DictAggregator(capacity=1 << 12, device="cpu"),
                    profile_writer=w, encode_pipeline=False,
                    encode_deadline_s=0.05, duration_s=0.01, sinks=reg)
    enc = p.encoder
    gate = threading.Event()
    real = enc.encode

    def slow(*a, **k):
        assert gate.wait(10)
        return real(*a, **k)

    enc.encode = slow
    assert p.run_iteration()      # window 1: past the deadline -> scalar
    gate.set()
    assert p._encode_inflight.wait(10)
    enc.encode = real
    assert p.run_iteration()      # window 2: inline encode, fanned out
    p.close()
    assert p.metrics.encode_deadline_hits_total == 1
    assert p.metrics.scalar_windows_total == 1
    m = reg.metrics()
    assert m["_registry"]["windows_skipped"] == 1
    assert series.stats["windows"] == 1  # the inline window folded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sinks")
    return {which: analytics_run(which, root / which) for which in BOTH}


def test_parity_autofdo_profdata_bytes(runs):
    files = {}
    for which, r in runs.items():
        d = os.path.join(r.root, "afdo")
        files[which] = {f: open(os.path.join(d, f), "rb").read()
                        for f in sorted(os.listdir(d))}
    assert any(f.endswith(".afdo.txt") for f in files["port"])
    assert files["jax"] == files["port"]


def test_parity_series_records_and_sink_stats(runs):
    got = {w: (r.registry.sink("series").series(),
               plain(r.registry.metrics(), TIMINGS),
               plain(r.registry.snapshot(), TIMINGS))
           for w, r in runs.items()}
    assert got["port"][0]
    assert got["jax"] == got["port"]


def test_parity_pprof_bytes_equal_with_and_without_secondaries(runs,
                                                                tmp_path):
    """Every pid's pprof bytes: the port's with the secondaries equal its
    bytes without them, and the original's."""
    bare = analytics_run("port", tmp_path / "bare", sinks=False,
                         analytics=False).writer.got
    assert bare and runs["port"].writer.got == bare
    assert runs["jax"].writer.got == bare


@pytest.mark.parametrize("spec", ["sink.emit:error:p=0.5",
                                  "sink.flush:error:p=0.5"])
def test_parity_sink_chaos_counters(spec, tmp_path):
    """The sinks' chaos sites under the same seeded rules: the same
    emits and flushes fail, counted the same, and the pprof ship loses
    nothing."""
    got = {}
    for which in BOTH:
        faults = pkg(which, "utils.faults")
        faults.install(faults.FaultInjector.from_spec(spec, seed=3))
        try:
            r = analytics_run(which, tmp_path / which)
            fired = faults.get().stats()
        finally:
            faults.install(None)
        got[which] = (fired, plain(r.registry.metrics(), TIMINGS),
                      r.pipeline.stats["windows_lost"],
                      r.pipeline.stats["ship_errors"], len(r.writer.got))
    errors = sum(st.get("errors", 0) for k, st in got["port"][1].items()
                 if isinstance(st, dict))
    assert errors > 0 and got["port"][2:4] == (0, 0)
    assert got["jax"] == got["port"]
