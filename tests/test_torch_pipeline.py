"""The port's EncodePipeline, its fast window loop and the --fast-encode
command line, on the CPU.

The pipeline cases are those of tests/test_encode_pipeline.py, with the
port's DictAggregator (device="cpu") and WindowEncoder: the hand-off
ships the bytes an inline encode gives (and parca_agent_tpu's encoder
gives), backpressure, a worker exception, close() flushing the window in
flight, prebuilds yielding to a hand-off. The loop (profiler/cpu.py) has
no fallback: backpressure waits the worker out and encodes inline, a
pipelined encode's failure raises at the next window. The CLI with
--fast-encode writes, window by window, the mass the CLI writes without
it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.replay import ReplaySource
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import parse_pprof
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline

# One intra-op thread a process: the suite runs in several worker
# processes at once, and torch's default of a thread a core in each
# oversubscribes the host, so that timing-bound tests in other workers
# (an encode pipeline busy at a window's close) take another path.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _kw(seed=7, n_pids=6, rows=200):
    return dict(n_pids=n_pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=rows * 4, mean_depth=8, kernel_fraction=0.25,
                seed=seed)


def _setup(seed, n_pids=6, rows=200, capacity=1 << 12):
    snap = generate(SyntheticSpec(**_kw(seed, n_pids, rows)))
    agg = DictAggregator(capacity=capacity, device="cpu")
    return snap, agg, np.asarray(agg.window_counts(snap))


def _args(snap, dt=0):
    return snap.time_ns + dt, snap.window_ns, snap.period_ns


class Collect:
    def __init__(self):
        self.got = []

    def write(self, labels, blob):
        self.got.append((labels, bytes(blob)))


def _mass(got):
    return sum(sum(v[0] for _, v, _ in parse_pprof(b).samples)
               for _, b in got)


# -- the pipeline ---------------------------------------------------------------


def test_handoff_ships_the_inline_bytes_and_the_jax_encoders():
    kw = _kw(seed=1)
    snap, agg, counts = _setup(1)
    inline = WindowEncoder(agg).encode(counts, *_args(snap))
    shipped = []
    pipe = EncodePipeline(WindowEncoder(agg),
                          ship=lambda out, prep: shipped.extend(
                              (pid, bytes(b)) for pid, b in out))
    assert pipe.submit(counts, *_args(snap)) is not None
    assert pipe.close()
    assert shipped == [(pid, bytes(b)) for pid, b in inline]
    jagg = JaxDict(capacity=1 << 12)
    jsnap = jax_generate(JaxSpec(**kw))
    jout = JaxEncoder(jagg).encode(np.asarray(jagg.window_counts(jsnap)),
                                   *_args(jsnap))
    assert shipped == [(pid, bytes(b)) for pid, b in jout]


def test_backpressure_refuses_and_counts():
    snap, agg, counts = _setup(2)
    enc = WindowEncoder(agg)
    gate, entered = threading.Event(), threading.Event()
    real = enc.encode_prepared

    def slow(prep, views=False):
        entered.set()
        assert gate.wait(10)
        return real(prep, views=views)

    enc.encode_prepared = slow
    shipped = []
    pipe = EncodePipeline(enc, ship=lambda out, prep: shipped.append(out))
    t0 = time.perf_counter()
    assert pipe.submit(counts, *_args(snap)) is not None
    assert time.perf_counter() - t0 < 5.0
    assert entered.wait(10) and pipe.busy
    assert pipe.submit(counts, *_args(snap, 1)) is None
    assert pipe.stats["backpressure_fallbacks"] == 1
    gate.set()
    assert pipe.flush(10)
    assert len(shipped) == 1 and pipe.stats["windows_pipelined"] == 1
    assert pipe.close()


def test_close_flushes_the_window_in_flight():
    snap, agg, counts = _setup(3)
    enc = WindowEncoder(agg)
    real = enc.encode_prepared
    enc.encode_prepared = lambda prep, views=False: (
        time.sleep(0.3), real(prep, views=views))[1]
    shipped = []
    pipe = EncodePipeline(enc, ship=lambda out, prep: shipped.append(out))
    assert pipe.submit(counts, *_args(snap)) is not None
    assert pipe.close()
    assert len(shipped) == 1


def test_worker_exception_disables_without_losing_the_window():
    snap, agg, counts = _setup(4)
    enc = WindowEncoder(agg)
    enc.encode_prepared = lambda prep, views=False: (_ for _ in ()).throw(
        RuntimeError("encoder bug"))
    recovered = []
    pipe = EncodePipeline(enc, ship=lambda out, prep: None)
    assert pipe.submit(counts, *_args(snap),
                       fallback=lambda: recovered.append(1)) is not None
    assert pipe.quiesce(10)
    assert pipe.disabled and recovered == [1]
    assert pipe.stats["encoder_exceptions"] == 1
    assert pipe.stats["windows_lost"] == 0
    assert enc._synced == 0  # the encoder's mirrors were reset
    assert pipe.submit(counts, *_args(snap)) is None


def test_ship_error_does_not_disable_or_reship():
    snap, agg, counts = _setup(14)
    boom = {"on": True}
    shipped, recovered = [], []

    def ship(out, prep):
        if boom["on"]:
            raise OSError("disk full")
        shipped.append(out)

    pipe = EncodePipeline(WindowEncoder(agg), ship=ship)
    assert pipe.submit(counts, *_args(snap),
                       fallback=lambda: recovered.append(1)) is not None
    assert pipe.quiesce(10)
    assert not pipe.disabled and pipe.stats["ship_errors"] == 1
    assert recovered == []
    boom["on"] = False
    assert pipe.submit(counts, *_args(snap, 1)) is not None
    assert pipe.close() and len(shipped) == 1


def test_prebuild_runs_on_the_worker_and_yields_to_a_handoff():
    snap, agg, counts = _setup(5, n_pids=10, rows=400, capacity=1 << 13)
    enc = WindowEncoder(agg)
    shipped = []
    pipe = EncodePipeline(enc, ship=lambda out, prep: shipped.append(out))
    for _ in range(3):
        pipe.request_prebuild(snap.period_ns, budget_s=0.05)
    assert pipe.quiesce(10)
    assert pipe.stats["prebuilds"] >= 1
    assert enc.statics_backlog(snap.period_ns) == 0
    pipe.request_prebuild(snap.period_ns, budget_s=0.05)
    assert pipe.submit(counts, *_args(snap)) is not None
    assert pipe.close() and len(shipped) == 1


def test_budgeted_prebuild_gives_the_same_bytes():
    snap, agg, counts = _setup(6, n_pids=12, rows=500, capacity=1 << 13)
    enc = WindowEncoder(agg)
    ticks = 0
    while enc.statics_backlog(snap.period_ns) and ticks < 500:
        enc.build_statics(snap.period_ns, budget_s=1e-9, chunk=2,
                          loc_chunk=64)
        ticks += 1
    assert ticks > 1
    a = enc.encode(counts, *_args(snap))
    b = WindowEncoder(agg).encode(counts, *_args(snap))
    assert [(p, bytes(x)) for p, x in a] == [(p, bytes(x)) for p, x in b]
    stop = threading.Event()
    stop.set()
    fresh = WindowEncoder(agg)
    assert fresh.build_statics(snap.period_ns, chunk=2, loc_chunk=64,
                               stop=stop) < len(agg._pids)
    assert fresh.statics_backlog(snap.period_ns) > 0


def test_encoder_dead_row_stats():
    snap, agg, counts = _setup(8)
    enc = WindowEncoder(agg)
    enc.encode(counts, *_args(snap))
    assert enc.stats["dead_rows"] == 0
    c2 = counts.copy()
    c2[: len(c2) // 4] = 0
    enc.encode(c2, *_args(snap, 1))
    assert enc.stats["windows_encoded"] == 2
    assert 0.0 < enc.stats["dead_row_fraction"] <= 0.5


# -- the fast window loop ------------------------------------------------------


def _profiler(snaps, pipeline=True, records=None, **kw):
    w = Collect()
    p = CPUProfiler(ReplaySource(snaps),
                    DictAggregator(capacity=1 << 12, device="cpu"),
                    profile_writer=w, encode_pipeline=pipeline,
                    on_window=(records.append if records is not None
                               else None), **kw)
    return p, w


def test_loop_pipelined_and_inline_write_the_same_bytes():
    snap = generate(SyntheticSpec(**_kw(seed=9)))
    records = []
    p, w = _profiler([snap, snap], records=records)
    assert p.run_iteration()
    assert p.pipeline.flush(10)
    assert p.run_iteration()
    assert not p.run_iteration()  # the source is exhausted
    p.close()
    assert p.pipeline.stats["windows_pipelined"] == 2
    assert sorted(r["path"] for r in records) == ["pipeline"] * 2
    assert all(r["handoff_ms"] >= 0 and r["encode_ms"] > 0 for r in records)
    q, w2 = _profiler([snap, snap], pipeline=False)
    assert q.run_iteration() and q.run_iteration()
    q.close()
    assert w.got == w2.got
    assert w.got[0][0] == {"__name__": "parca_agent_cpu",
                           "pid": str(min(snap.pids))}
    assert _mass(w.got) == 2 * snap.total_samples()
    assert p.metrics.profiles_written == len(w.got)


def test_loop_backpressure_waits_then_encodes_inline():
    """The worker is still encoding window 1 at window 2's close: window
    2 is refused (counted), waits the worker out, and is encoded inline
    on the loop's thread; no mass is lost."""
    snap = generate(SyntheticSpec(**_kw(seed=10)))
    records = []
    p, w = _profiler([snap, snap], records=records)
    gate = threading.Event()
    real = p.encoder.encode_prepared

    def slow(prep, views=False):
        assert gate.wait(10)
        return real(prep, views=views)

    p.encoder.encode_prepared = slow
    assert p.run_iteration()
    threading.Timer(0.3, gate.set).start()
    assert p.run_iteration()
    assert p.metrics.encode_backpressure_total == 1
    assert p.pipeline.stats["backpressure_fallbacks"] == 1
    p.close()
    assert [r["path"] for r in sorted(records, key=lambda r: r["window"])] \
        == ["pipeline", "inline"]
    assert _mass(w.got) == 2 * snap.total_samples()


def test_loop_raises_a_pipelined_encode_failure():
    snap = generate(SyntheticSpec(**_kw(seed=11)))
    p, w = _profiler([snap, snap])
    p.encoder.encode_prepared = lambda prep, views=False: (
        _ for _ in ()).throw(RuntimeError("encoder bug"))
    assert p.run_iteration()
    assert p.pipeline.quiesce(10)
    assert p.pipeline.disabled
    assert p.pipeline.stats["windows_lost"] == 1
    with pytest.raises(RuntimeError) as e:
        p.run_iteration()
    assert "encoder bug" in repr(e.value.__cause__)
    with pytest.raises(RuntimeError):
        p.close()
    assert w.got == []


def test_loop_inline_encode_failure_propagates():
    snap = generate(SyntheticSpec(**_kw(seed=12)))
    p, w = _profiler([snap], pipeline=False)
    p.encoder.encode_prepared = lambda prep, views=False: (
        _ for _ in ()).throw(RuntimeError("encoder bug"))
    with pytest.raises(RuntimeError, match="encoder bug"):
        p.run_iteration()
    assert w.got == []


def test_loop_stress_every_window_reported_once():
    """Many small windows, the worker and the loop racing (a shortened
    switch interval): every window is written and reported exactly once,
    with its own mass, whichever path it took."""
    snaps = [generate(SyntheticSpec(**_kw(seed=40 + i % 3, rows=60)))
             for i in range(24)]
    records = []
    p, w = _profiler(snaps, records=records)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        while p.run_iteration():
            pass
        p.close()
    finally:
        sys.setswitchinterval(old)
    assert sorted(r["window"] for r in records) == list(range(1, 25))
    for r in records:
        assert r["mass"] == snaps[r["window"] - 1].total_samples()
    assert _mass(w.got) == sum(s.total_samples() for s in snaps)
    assert p.metrics.profiles_written == len(w.got) \
        == sum(r["profiles"] for r in records)


def test_loop_refuses_an_aggregator_without_window_counts():
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator

    with pytest.raises(ValueError, match="dict-style aggregator"):
        CPUProfiler(ReplaySource([]), CPUAggregator())


# -- the command line -----------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _cli(tmp_path, *flags, device=("--device", "cpu")):
    store = tmp_path / "store"
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", *device,
         "--capture", "synthetic", "--windows", "2",
         "--profiling-duration", "0.1",
         "--local-store-directory", str(store), *flags],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    lines = sorted((json.loads(ln) for ln in r.stdout.splitlines()
                    if ln.startswith("{")), key=lambda ln: ln["window"])
    return r, lines, sorted(store.glob("*.pb.gz"))


_AGG = {"dict": ("--aggregator", "dict"),
        "dict+cm": ("--aggregator", "dict+cm", "--aggregator-capacity",
                    "4096")}


@pytest.fixture(scope="module")
def scalar_masses(tmp_path_factory):
    """Per-window mass of the CLI without --fast-encode."""
    out = {}
    for name, flags in _AGG.items():
        r, lines, _ = _cli(tmp_path_factory.mktemp(name.replace("+", "")),
                           *flags)
        assert r.returncode == 0, r.stderr
        out[name] = [(ln["mass"], ln["profiles"]) for ln in lines]
    return out


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("agg", ["dict", "dict+cm"])
def test_cli_fast_encode_writes_the_scalar_cli_mass(tmp_path, scalar_masses,
                                                    agg, pipeline):
    flags = _AGG[agg] + ("--fast-encode",) + (
        () if pipeline else ("--no-encode-pipeline",))
    r, lines, files = _cli(tmp_path, *flags)
    assert r.returncode == 0, r.stderr
    assert [ln["window"] for ln in lines] == [1, 2]
    assert [(ln["mass"], ln["profiles"]) for ln in lines] \
        == scalar_masses[agg]
    if not pipeline:
        assert {ln["encode_path"] for ln in lines} == {"inline"}
    assert all(ln["encode_ms"] >= 0 for ln in lines)
    assert len(files) == sum(ln["profiles"] for ln in lines)
    mass = sum(v[0] for f in files
               for _, v, _ in parse_pprof(f.read_bytes()).samples)
    assert mass == sum(ln["mass"] for ln in lines) > 0


def test_cli_fast_encode_refuses_the_one_shot_aggregator(tmp_path):
    r, lines, _ = _cli(tmp_path, "--aggregator", "tpu", "--fast-encode")
    assert r.returncode != 0 and not lines
    assert "--fast-encode requires --aggregator dict/dict+cm/sharded" \
        in r.stderr


def test_cli_fast_encode_without_cuda_names_the_missing_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r, lines, files = _cli(tmp_path, "--fast-encode", device=())
    assert r.returncode == 2 and not lines and not files
    assert "CUDA" in r.stderr
