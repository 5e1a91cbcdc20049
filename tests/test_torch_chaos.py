"""The port's chaos sites degrade as parca_agent_tpu's do.

Every site the port wires (utils/faults.py) is driven under the fault
rules that tests/test_chaos.py, tests/test_ingest_poison.py and
tests/test_quarantine.py use. Where both packages run the path, the same
rule goes into each package's own injector over the same seeded inputs
and the degradation must be the same: the same counters moved, the same
counts out, no window lost. The card's paths have no CPU fallback in the
port, so a device fault degrades to what the original does without one
(the watchdog's cases are in tests/test_torch_runtime.py).
"""

from __future__ import annotations

import dataclasses
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
from parca_agent_tpu.pprof.statics_store import StaticsStore as JaxStore
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu.runtime import supervisor as jax_supervisor
from parca_agent_tpu.utils import faults as jax_faults
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.procfs import ProcfsSampler
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.parallel import distributed
from parca_agent_tpu_torch.pprof.statics_store import StaticsStore
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline
from parca_agent_tpu_torch.profiler.streaming import StreamingWindowFeeder
from parca_agent_tpu_torch.runtime import quarantine
from parca_agent_tpu_torch.runtime import supervisor
from parca_agent_tpu_torch.runtime import trace
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import fake_procfs

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.install(None)
    jax_faults.install(None)
    trace.install(None)


def _arm(spec, seed=42):
    """The same rule in both packages' injectors."""
    faults.install(faults.FaultInjector.from_spec(spec, seed=seed))
    jax_faults.install(jax_faults.FaultInjector.from_spec(spec, seed=seed))


def _spec(seed, rows=512, pids=8):
    return dict(n_pids=pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=rows * 3, mean_depth=8, seed=seed)


def _dup(snap, dup):
    idx = np.repeat(np.arange(len(snap)), dup)
    return dataclasses.replace(
        snap, pids=snap.pids[idx], tids=np.arange(len(idx), dtype=np.int32),
        counts=snap.counts[idx], user_len=snap.user_len[idx],
        kernel_len=snap.kernel_len[idx], stacks=snap.stacks[idx])


def _snaps(seed, dup, **kw):
    return (_dup(generate(SyntheticSpec(**_spec(seed, **kw))), dup),
            _dup(jax_generate(JaxSpec(**_spec(seed, **kw))), dup))


@pytest.mark.chaos
def test_feed_coalesce_fault_falls_back_uncoalesced_alike():
    """feed.coalesce:error:count=1: the batch dispatches unfolded, the
    window closes exact, the next window folds again — in both."""
    snap, jsnap = _snaps(43, dup=3)
    want = DictAggregator(capacity=1 << 12, overflow="raise", device="cpu",
                          coalesce=False).window_counts(snap)
    _arm("feed.coalesce:error:count=1")
    d = DictAggregator(capacity=1 << 12, overflow="raise", device="cpu")
    j = JaxDict(capacity=1 << 12, overflow="raise")
    for w in range(2):
        got = d.window_counts(snap)
        assert np.array_equal(got, want), w
        assert np.array_equal(got, np.asarray(j.window_counts(jsnap))), w
    for k in ("coalesce_fallbacks", "coalesce_rows_in", "coalesce_rows_out"):
        assert d.stats.get(k, 0) == j.stats.get(k, 0), k
    assert d.stats["coalesce_fallbacks"] == 1
    assert faults.get().stats() == jax_faults.get().stats() == {
        "feed.coalesce": 1}


@pytest.mark.chaos
def test_feed_carry_fault_dispatches_per_drain_alike():
    """feed.carry:error:count=1: matching is off until the boundary, the
    carried mass still flushes, every window is exact, the next window
    carries again — in both."""
    snap, jsnap = _snaps(47, dup=2)
    want = DictAggregator(capacity=1 << 12, overflow="raise",
                          device="cpu").window_counts(snap)
    _arm("feed.carry:error:count=1")
    d = DictAggregator(capacity=1 << 12, overflow="raise", device="cpu",
                       carry=True)
    j = JaxDict(capacity=1 << 12, overflow="raise", carry=True)
    for w in range(3):
        got = d.window_counts(snap)
        assert np.array_equal(got, want), w
        assert np.array_equal(got, np.asarray(j.window_counts(jsnap))), w
    for k in ("carry_fallbacks", "carry_hits", "carry_mass",
              "carry_admitted"):
        assert d.stats.get(k, 0) == j.stats.get(k, 0), k
    assert d.stats["carry_fallbacks"] == 1


@pytest.mark.chaos
@pytest.mark.parametrize("kind", ["disk_full", "error"])
def test_statics_snapshot_fault_is_counted_and_skipped_alike(tmp_path, kind):
    """statics.snapshot:<kind>:count=1: the first save fails (counted),
    the file is not written, the next save writes it — in both."""
    snap, jsnap = _snaps(5, dup=1, rows=300, pids=5)
    _arm(f"statics.snapshot:{kind}:count=1")
    outs = []
    for dict_cls, enc_cls, store_cls, s, kw in (
            (DictAggregator, WindowEncoder, StaticsStore, snap,
             {"device": "cpu"}),
            (JaxDict, JaxEncoder, JaxStore, jsnap, {})):
        agg = dict_cls(capacity=1 << 11, overflow="raise", **kw)
        enc = enc_cls(agg)
        enc.encode(np.asarray(agg.window_counts(s)), s.time_ns,
                   s.window_ns, s.period_ns)
        path = tmp_path / f"{dict_cls.__module__}.snap"
        store = store_cls(str(path))
        first = store.save(agg, enc, s.period_ns)
        exists = path.exists()
        second = store.save(agg, enc, s.period_ns)
        outs.append((bool(first), exists, bool(second),
                     store.stats["snapshot_write_errors"],
                     store.stats["snapshots_written"]))
    assert outs[0] == outs[1] == (False, False, True, 1, 1)


@pytest.mark.chaos
def test_actor_encode_crash_disables_then_the_probe_revives():
    """actor.encode:crash:count=1 kills the worker on its window: the
    pipeline disables and counts the window (no fallback in the port);
    the supervisor's probe revives it and the next window pipelines."""
    snap = generate(SyntheticSpec(**_spec(3, rows=200, pids=4)))
    agg = DictAggregator(capacity=1 << 11, overflow="raise", device="cpu")
    enc = WindowEncoder(agg)
    shipped = []
    pipe = EncodePipeline(enc, ship=lambda out, prep: shipped.append(
        len(out)))
    sup = supervisor.Supervisor(probe_tick_s=3600)
    sup.add_probe("encode", check=lambda: not pipe.disabled,
                  revive=pipe.revive, critical=False)
    faults.install(faults.FaultInjector.from_spec("actor.encode:crash:count=1"))
    args = (snap.time_ns, snap.window_ns, snap.period_ns)
    assert pipe.submit(agg.window_counts(snap), *args) is not None
    pipe.flush(30)
    assert pipe.disabled and pipe.stats["windows_lost"] == 1
    assert isinstance(pipe.last_error, faults.InjectedCrash)
    sup.poll_probes()
    assert not pipe.disabled
    assert sup.health()["encode"]["restarts"] == 1
    assert pipe.submit(agg.window_counts(snap), *args) is not None
    assert pipe.close(30)
    assert shipped == [4] and pipe.stats["windows_pipelined"] == 1


@pytest.mark.chaos
def test_actor_site_crash_restarts_like_parca_agent_tpu():
    """actor.<name>:crash:count=2 at the actor's tick: restarted twice
    with the same backoffs, then healthy — in both supervisors."""
    results = []
    for sup_mod, fmod in ((supervisor, faults), (jax_supervisor, jax_faults)):
        fmod.install(fmod.FaultInjector.from_spec("actor.worker:crash:count=2"))
        sleeps = []
        sup = sup_mod.Supervisor(sleep=sleeps.append)
        ran = []

        def run(fmod=fmod, ran=ran):
            fmod.inject("actor.worker")
            ran.append(1)

        sup.add_actor("worker", run=run)
        sup.start()
        deadline = time.monotonic() + 10
        while not sup.finished("worker"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        h = sup.health()["worker"]
        results.append((h["state"], h["restarts"], sleeps, ran))
        fmod.install(None)
    assert results[0][:3] == results[1][:3]
    assert results[0][1] == 2 and results[0][3] == [1]


@pytest.mark.chaos
def test_actor_profiler_crash_is_restarted_by_the_cli(tmp_path):
    """The CLI's window loop under actor.profiler:crash:count=1: the
    supervisor restarts it and every window still ships."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--windows", "2", "--fast-encode",
         "--profiling-duration", "0.1",
         "--fault-inject", "actor.profiler:crash:count=1",
         "--fault-seed", "7"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    assert [x["window"] for x in lines if "window" in x] == [1, 2]
    prof = lines[-1]["runtime"]["supervisor"]["profiler"]
    assert prof["restarts"] == 1 and prof["state"] in ("degraded", "exited")


class _Maps:
    def executable_mappings(self, pid):
        return []


class _Objs:
    def build_ids(self, per_pid):
        return {}

    def get(self, pid, m):
        return None


@pytest.mark.chaos
def test_actor_feeder_crash_cools_the_feeder_down():
    """actor.feeder:crash:count=1 at the drain tick: the feeder enters
    its cooldown (never raising into capture), the window re-aggregates
    exact, and after the cooldown the feeder streams again."""
    snap = generate(SyntheticSpec(**_spec(8, rows=200, pids=4)))
    cols = (snap.pids, snap.tids, snap.user_len, snap.kernel_len,
            snap.stacks, snap.counts)
    agg = DictAggregator(capacity=1 << 11, overflow="raise", device="cpu")
    want = agg.window_counts(snap).copy()
    feeder = StreamingWindowFeeder(agg, _Maps(), _Objs(),
                                   reprobe_base_windows=1)
    faults.install(faults.FaultInjector.from_spec("actor.feeder:crash:count=1"))
    feeder.on_drain(cols)
    assert feeder.disabled and feeder.stats["cooldowns"] == 1
    assert feeder.take_window_if_complete(snap) is None
    assert np.array_equal(agg.window_counts(snap), want)
    feeder.on_drain(cols)
    assert np.array_equal(feeder.take_window_if_complete(snap), want)


@pytest.mark.parametrize("spec", ["maps.parse:poison",
                                  "maps.parse:poison:p=0.5"])
def test_maps_poison_sends_pids_down_the_ladder_in_the_procfs_sampler(spec):
    """maps.parse:poison in the procfs sampler: every poisoned pid is
    charged to the registry and degrades to no mappings; the collect
    never raises."""
    fs = fake_procfs([101, 102, 103])
    sampler = ProcfsSampler(fs=fs)
    reg = quarantine.QuarantineRegistry(max_strikes=1)
    sampler.quarantine = reg
    faults.install(faults.FaultInjector.from_spec(spec, seed=1))
    for _ in range(3):
        for pid in (101, 102, 103):
            assert sampler._pid_mappings(pid) == []
    fired = faults.get().stats().get("maps.parse", 0)
    assert fired > 0 and reg.stats["errors_total"] == fired
    assert reg.quarantined_pids()


@pytest.mark.chaos
@pytest.mark.parametrize("kind", ["trace.record:error", "incident.dump:error"])
def test_tracing_faults_never_cost_a_window(tmp_path, kind):
    """trace.record and incident.dump failing: the loop's windows ship
    whole; the recorder counts the faults."""
    snaps = [generate(SyntheticSpec(**_spec(s, rows=200, pids=4)))
             for s in range(10)]
    rec = trace.FlightRecorder(min_count=1, slow_multiple=0.0001,
                               min_duration_s=0.0,
                               incident_dir=str(tmp_path),
                               incident_interval_s=0.0,
                               self_profile=lambda: b"")
    faults.install(faults.FaultInjector.from_spec(kind))
    agg = DictAggregator(capacity=1 << 12, device="cpu")
    records = []

    class Src:
        def poll(self):
            return snaps.pop(0) if snaps else None

    prof = CPUProfiler(Src(), agg, encode_pipeline=False,
                       on_window=records.append, trace_recorder=rec)
    while prof.run_iteration():
        deadline = time.monotonic() + 5
        while rec._dumping and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(records) == 10
    assert all(r["mass"] == r["samples"] for r in records)
    if kind.startswith("trace"):
        assert rec.stats["record_errors"] > 0
    else:
        assert rec.stats["incidents_failed"] >= 1
        assert not list(tmp_path.iterdir())


@pytest.mark.chaos
def test_fleet_join_hang_is_bounded():
    """fleet.join:hang: the join is abandoned at its bound and raises
    FleetJoinError; the process group is never formed. (The rule also
    errors once the hang ends, so the abandoned join never goes on to
    touch the process group from its thread.)"""
    import torch.distributed as dist

    faults.install(faults.FaultInjector.from_spec(
        "fleet.join:hang:ms=1000;fleet.join:error"))
    t0 = time.monotonic()
    with pytest.raises(distributed.FleetJoinError):
        distributed.fleet_initialize("127.0.0.1:1", 2, 0, timeout_s=0.3,
                                     device="cpu")
    assert time.monotonic() - t0 < 2.5
    assert not dist.is_initialized()


def test_fleet_collective_fault_degrades_the_merger():
    """fleet.collective:error on a merge round: the merger goes
    node-local (degraded, counted), never failed; the probe collective
    fires the same site."""
    merger = distributed.FleetWindowMerger(interval_s=0.0,
                                           collective_timeout_s=5.0,
                                           device="cpu")
    faults.install(faults.FaultInjector.from_spec("fleet.collective:error"))
    h = np.arange(16, dtype=np.uint32)
    merger.submit_window(lambda: (h, h), np.ones(16, np.int64))
    merger.merge_round()
    assert merger.failed is None
    fired = faults.get().stats().get("fleet.collective", 0)
    assert fired >= 1
    assert merger.degraded or merger.stats.get("local_only_rounds", 0) >= 1
    with pytest.raises(faults.InjectedFault):
        merger._probe_collective()
