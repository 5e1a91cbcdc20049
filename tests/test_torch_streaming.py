"""The port's streaming window feeder against parca_agent_tpu's.

Drains are fed to the dictionary during the window and the close is one
packed fetch; a window the feeder did not see whole is re-aggregated by
window_counts on the same aggregator. Every case feeds the same seeded
drains to the port's feeder (aggregator on the CPU) and to
parca_agent_tpu's: counts, ids and pprof bytes must be equal. The cases
are those of tests/test_streaming.py that apply to the port (no
sharded aggregator here; the watchdog and cooldown are held in
tests/test_torch_runtime.py), plus the carry cache through the feeder,
the fast loop's statics snapshot across a restart, a feed that raises,
and the port's copies of build_mapping_table, columns_to_snapshot and
registry_content_digest.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.aggregator.dict import \
    registry_content_digest as jax_digest
from parca_agent_tpu.capture.live import \
    columns_to_snapshot as jax_columns_to_snapshot
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu.process import maps as jax_maps
from parca_agent_tpu.profiler.cpu import CPUProfiler as JaxProfiler
from parca_agent_tpu.profiler.streaming import \
    StreamingWindowFeeder as JaxFeeder
from parca_agent_tpu_torch.aggregator.base import ProfileMapping
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.aggregator.dict import (
    DictAggregator,
    registry_content_digest,
)
from parca_agent_tpu_torch.capture.live import columns_to_snapshot
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import parse_pprof
from parca_agent_tpu_torch.pprof.statics_store import StaticsStore
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.process import maps
from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
from parca_agent_tpu_torch.profiler.streaming import StreamingWindowFeeder


class FakeMaps:
    def executable_mappings(self, pid):
        return []


class FakeObjs:
    def build_ids(self, per_pid):
        return {}

    def get(self, pid, m):
        return None


class TableMaps:
    """Maps and objects served from a window's own MappingTable: each
    pid's rows as mappings of the given ProcMapping class, the table's
    build ids, and bases from its own `bases` column."""

    def __init__(self, table, cls):
        self._rows = {}
        self._base = {}
        for r in range(len(table)):
            pid = int(table.pids[r])
            obj = int(table.objs[r])
            m = cls(int(table.starts[r]), int(table.ends[r]), "r-xp",
                    int(table.offsets[r]), "08:01", 1000 + obj,
                    table.obj_paths[obj])
            self._rows.setdefault(pid, []).append(m)
            self._base[(pid, m.start)] = int(table.bases[r])
        self._ids = dict(zip(table.obj_paths, table.obj_buildids))

    def executable_mappings(self, pid):
        if pid not in self._rows:
            raise OSError("exited")
        return self._rows[pid]

    def build_ids(self, per_pid):
        return dict(self._ids)

    def get(self, pid, m):
        base = self._base[(pid, m.start)]
        return type("Obj", (), {"base": staticmethod(lambda: base)})()


def _kw(seed=1, n=300, pids=6):
    return dict(n_pids=pids, n_unique_stacks=n, n_rows=n,
                total_samples=n * 4, mean_depth=8, seed=seed)


def _snaps(seed=1, n=300, pids=6):
    return (generate(SyntheticSpec(**_kw(seed, n, pids))),
            jax_generate(JaxSpec(**_kw(seed, n, pids))))


def _cols(snap, lo, hi):
    """A drain's columns for rows [lo, hi)."""
    return (snap.pids[lo:hi], snap.tids[lo:hi], snap.user_len[lo:hi],
            snap.kernel_len[lo:hi], snap.stacks[lo:hi], snap.counts[lo:hi])


def _pair(cap=1 << 11, carry=False, maps_for=None):
    """(port feeder, JAX feeder) over fresh dictionaries."""
    agg = DictAggregator(capacity=cap, device="cpu", carry=carry)
    jagg = JaxDict(capacity=cap, carry=carry)
    m, jm = ((FakeMaps(), FakeMaps()) if maps_for is None else maps_for)
    objs = m if maps_for is not None else FakeObjs()
    jobjs = jm if maps_for is not None else FakeObjs()
    return (StreamingWindowFeeder(agg, m, objs),
            JaxFeeder(jagg, jm, jobjs))


def _stream(feeders, snaps, step):
    for f, s in zip(feeders, snaps):
        for lo in range(0, len(s), step):
            f.on_drain(_cols(s, lo, min(lo + step, len(s))))


def _take(feeders, snaps):
    out = [f.take_window_if_complete(s) for f, s in zip(feeders, snaps)]
    return [None if c is None else np.asarray(c).copy() for c in out]


@pytest.mark.parametrize("step", [64, 300])
def test_feeder_streams_a_complete_window(step):
    snap, jsnap = _snaps()
    feeders = _pair()
    _stream(feeders, (snap, jsnap), step)
    c, jc = _take(feeders, (snap, jsnap))
    assert c is not None and np.array_equal(c, jc)
    assert int(c.sum()) == snap.total_samples()
    f = feeders[0]
    assert f.stats["drains_fed"] == -(-len(snap) // step)
    assert f.stats["windows_streamed"] == 1
    assert f._agg._key_to_id == feeders[1]._agg._key_to_id
    profiles = {p.pid: p for p in f._agg._build_profiles(snap, c)}
    for op in CPUAggregator().aggregate(snap):
        assert profiles[op.pid].total() == op.total()
        assert np.array_equal(np.sort(profiles[op.pid].values),
                              np.sort(op.values))


def test_streamed_window_normalizes_like_the_snapshot():
    """Per-drain mapping tables rebuilt from the window's own table give
    the registries (bases, build ids, paths) of aggregating the snapshot
    itself, so the pprof bytes are equal."""
    snap, jsnap = _snaps(seed=4, n=400, pids=8)
    feeders = _pair(maps_for=(TableMaps(snap.mappings, maps.ProcMapping),
                              TableMaps(jsnap.mappings,
                                        jax_maps.ProcMapping)))
    order = np.argsort(snap.pids, kind="stable")
    win = dataclasses.replace(
        snap, **{k: getattr(snap, k)[order] for k in (
            "pids", "tids", "counts", "user_len", "kernel_len", "stacks")})
    jwin = dataclasses.replace(
        jsnap, **{k: getattr(jsnap, k)[order] for k in (
            "pids", "tids", "counts", "user_len", "kernel_len", "stacks")})
    # One drain a pid group: registration order is that of the snapshot.
    cuts = [0] + (np.flatnonzero(np.diff(win.pids)) + 1).tolist() \
        + [len(win)]
    for f, s in zip(feeders, (win, jwin)):
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            f.on_drain(_cols(s, lo, hi))
    c, jc = _take(feeders, (win, jwin))
    assert np.array_equal(c, jc)
    ref = DictAggregator(capacity=1 << 11, device="cpu")
    rc = ref.window_counts(win)
    agg = feeders[0]._agg
    for pid, reg in ref._pids.items():
        got = agg._pids[pid]
        assert got.mappings == reg.mappings
        assert sorted(zip(got.loc_address, got.loc_normalized,
                          got.loc_mapping_id)) == \
            sorted(zip(reg.loc_address, reg.loc_normalized,
                       reg.loc_mapping_id))
    out = dict((p, bytes(b)) for p, b in WindowEncoder(agg).encode(
        c, 1, snap.window_ns, snap.period_ns))
    jout = dict((p, bytes(b)) for p, b in JaxEncoder(feeders[1]._agg).encode(
        jc, 1, snap.window_ns, snap.period_ns))
    assert out == jout
    assert {p: sum(v[0] for _, v, _ in parse_pprof(b).samples)
            for p, b in out.items()} == \
        {p.pid: p.total() for p in ref._build_profiles(win, rc)}


def test_incomplete_window_re_aggregates():
    snap, jsnap = _snaps(seed=2)
    feeders = _pair()
    for f, s in zip(feeders, (snap, jsnap)):
        f.on_drain(_cols(s, 0, len(s) // 2))  # half the window
    assert _take(feeders, (snap, jsnap)) == [None, None]
    assert feeders[0].stats["windows_fallback"] == 1
    c = feeders[0]._agg.window_counts(snap)
    jc = np.asarray(feeders[1]._agg.window_counts(jsnap))
    assert np.array_equal(c, jc)
    assert int(c.sum()) == snap.total_samples()
    _stream(feeders, (snap, jsnap), 128)
    c, jc = _take(feeders, (snap, jsnap))
    assert c is not None and np.array_equal(c, jc)


def test_fallback_window_timings_do_not_leak_into_next_stream():
    snap, _ = _snaps(seed=9)
    agg = DictAggregator(capacity=1 << 11, device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs())
    feeder.on_drain(_cols(snap, 0, len(snap) // 2))
    assert feeder.take_window_if_complete(snap) is None
    agg.window_counts(snap)  # the re-aggregated window
    assert "feed_dispatch" in agg.timings
    agg.timings["feed_dispatch"] = 999.0
    agg.timings["feed_settle"] = 999.0
    for lo in range(0, len(snap), 128):
        feeder.on_drain(_cols(snap, lo, min(lo + 128, len(snap))))
    assert feeder.take_window_if_complete(snap) is not None
    assert feeder.stats["last_window_dispatch_s"] < 100.0
    assert feeder.stats["last_window_settle_s"] < 100.0
    assert "feed_dispatch" not in agg.timings
    assert "feed_settle" not in agg.timings


@pytest.mark.parametrize("pipelined", [False, True])
def test_feeder_prebuilds_statics_during_window(pipelined):
    """With an encoder attached, each drain is followed by a budgeted
    statics prebuild (on the pipeline's worker when given): by the close
    every pid is built, and the bytes equal parca_agent_tpu's."""
    from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline

    snap, jsnap = _snaps(seed=10)
    agg = DictAggregator(capacity=1 << 11, device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs(),
                                   prebuild_period_ns=10_000_000)
    enc = WindowEncoder(agg)
    pipe = EncodePipeline(enc, ship=lambda o, p: None) if pipelined \
        else None
    feeder.attach_encoder(enc, prebuild=pipe.request_prebuild
                          if pipe else None)
    for lo in range(0, len(snap), 64):
        feeder.on_drain(_cols(snap, lo, min(lo + 64, len(snap))))
        if pipe is not None:
            assert pipe.quiesce(10)
    assert feeder.stats["statics_prebuilt"] == feeder.stats["drains_fed"]
    if pipe is not None:
        assert pipe.stats["prebuilds"] >= 1
        assert pipe.close()
    assert set(enc._static) == set(agg._pids)
    assert all(st.period_ns == 10_000_000 for st in enc._static.values())
    counts = feeder.take_window_if_complete(snap)
    out = dict(enc.encode(counts, snap.time_ns, snap.window_ns,
                          snap.period_ns))
    jfeeder = JaxFeeder(JaxDict(capacity=1 << 11), FakeMaps(), FakeObjs())
    for lo in range(0, len(jsnap), 64):
        jfeeder.on_drain(_cols(jsnap, lo, min(lo + 64, len(jsnap))))
    jc = np.asarray(jfeeder.take_window_if_complete(jsnap))
    jout = dict(JaxEncoder(jfeeder._agg).encode(
        jc, jsnap.time_ns, jsnap.window_ns, jsnap.period_ns))
    assert {p: bytes(b) for p, b in out.items()} == \
        {p: bytes(b) for p, b in jout.items()}


def test_build_statics_budget_is_incremental():
    snap, _ = _snaps(seed=11, n=900, pids=40)
    agg = DictAggregator(capacity=1 << 12, device="cpu")
    counts = agg.window_counts(snap)
    enc = WindowEncoder(agg)
    built = enc.build_statics(snap.period_ns, budget_s=0.0, chunk=8)
    assert built < len(agg._pids)
    for _ in range(200):
        built = enc.build_statics(snap.period_ns, budget_s=0.0, chunk=8)
        if built == len(agg._pids):
            break
    assert built == len(agg._pids)
    out = dict(enc.encode(counts, snap.time_ns, snap.window_ns,
                          snap.period_ns))
    enc2 = WindowEncoder(agg)
    enc2.build_statics(snap.period_ns)
    assert out == dict(enc2.encode(counts, snap.time_ns, snap.window_ns,
                                   snap.period_ns))


def test_feeder_discards_residual_device_mass():
    """A feed dispatched and never closed leaves mass on the device and in
    the host's pending corrections; the next streamed window discards it
    at its first drain and closes exact."""
    snap, jsnap = _snaps(seed=12)
    feeders = _pair()
    for f, s in zip(feeders, (snap, jsnap)):
        f._agg._needs_reset = True
        f._agg.feed(s)
        assert f._agg._fed_total > 0 or f._agg._pending
    _stream(feeders, (snap, jsnap), 64)
    c, jc = _take(feeders, (snap, jsnap))
    assert int(c.sum()) == snap.total_samples()
    assert np.array_equal(c, jc)


def test_feed_error_propagates_out_of_on_drain():
    """Since the feeder has its watchdog, a feed that raises no longer
    propagates out of on_drain (the capture loop must not die of it): it
    is counted and the feeder cools down, as parca_agent_tpu's does; the
    window it broke is re-aggregated whole at its boundary, on the same
    aggregator, and the next feeds wait out the cooldown."""
    snap, _ = _snaps(seed=3)

    class Boom(DictAggregator):
        fail = True

        def feed(self, *a, **kw):
            if self.fail:
                raise RuntimeError("device gone")
            return super().feed(*a, **kw)

    agg = Boom(capacity=1 << 11, device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs())
    feeder.on_drain(_cols(snap, 0, len(snap)))
    assert feeder.stats["drains_fed"] == 0
    assert feeder.stats["feed_errors"] == 1 and feeder.disabled
    agg.fail = False
    feeder.on_drain(_cols(snap, 0, len(snap)))  # cooling down: not fed
    assert feeder.stats["drains_fed"] == 0
    assert feeder.take_window_if_complete(snap) is None
    assert feeder.stats["windows_fallback"] == 1
    assert int(agg.window_counts(snap).sum()) == snap.total_samples()


def test_streamed_windows_with_the_carry():
    """Three streamed windows through carrying dictionaries: counts and
    carry counters equal parca_agent_tpu's, the steady windows carry."""
    snap, jsnap = _snaps(seed=6, n=600, pids=8)
    feeders = _pair(carry=True)
    for w in range(3):
        _stream(feeders, (snap, jsnap), 100)
        c, jc = _take(feeders, (snap, jsnap))
        assert c is not None and np.array_equal(c, jc), w
        assert int(c.sum()) == snap.total_samples()
    agg, jagg = feeders[0]._agg, feeders[1]._agg
    for k in ("carry_hits", "carry_rows_in", "carry_mass", "carry_flushes",
              "carry_admitted", "carry_entries"):
        assert agg.stats.get(k) == jagg.stats.get(k), k
    assert agg.stats["carry_hits"] > 0
    for k in ("carry", "dispatch", "settle", "hash", "coalesce"):
        assert feeders[0].stats[f"last_window_{k}_s"] >= 0.0


class _Collect:
    def __init__(self):
        self.got = []

    def write(self, labels, blob):
        self.got.append((labels, bytes(blob)))


class _StreamingSource:
    """poll() tees the window's drains to the feeder, then returns it."""

    def __init__(self, feeder, snaps, step=100):
        self._feeder = feeder
        self._snaps = list(snaps)
        self._step = step

    def poll(self):
        if not self._snaps:
            return None
        snap = self._snaps.pop(0)
        for lo in range(0, len(snap), self._step):
            self._feeder.on_drain(_cols(snap, lo,
                                        min(lo + self._step, len(snap))))
        return snap


@pytest.mark.parametrize("pipeline", [False, True])
def test_profiler_uses_streamed_close(pipeline):
    """The fast loop closes streamed windows through the feeder and writes
    the bytes parca_agent_tpu's streaming profiler writes."""
    snap, jsnap = _snaps(seed=5)
    agg = DictAggregator(capacity=1 << 11, device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs())
    w, records = _Collect(), []
    p = CPUProfiler(_StreamingSource(feeder, [snap, snap]), agg,
                    profile_writer=w, encode_pipeline=pipeline,
                    on_window=records.append, streaming_feeder=feeder)
    assert p.run_iteration() and p.run_iteration()
    assert not p.run_iteration()
    p.close()
    assert feeder.stats["windows_streamed"] == 2
    assert [r["streamed"] for r in records] == [True, True]
    assert all(r["feeder_s"]["feed"] > 0 for r in records)
    jagg = JaxDict(capacity=1 << 11)
    jfeeder = JaxFeeder(jagg, FakeMaps(), FakeObjs())
    jw = _Collect()
    jp = JaxProfiler(source=_StreamingSource(jfeeder, [jsnap, jsnap]),
                     aggregator=jagg, profile_writer=jw, fast_encode=True,
                     streaming_feeder=jfeeder)
    assert jp.run_iteration() and jp.run_iteration()
    assert jfeeder.stats["windows_streamed"] == 2
    mine = [(int(lab["pid"]), b) for lab, b in w.got]
    theirs = [(int(lab["pid"]), b) for lab, b in jw.got]
    assert sorted(mine) == sorted(theirs)
    oracle = {p.pid: p.total() for p in CPUAggregator().aggregate(snap)}
    half = len(mine) // 2
    assert {pid: sum(v[0] for _, v, _ in parse_pprof(b).samples)
            for pid, b in mine[:half]} == oracle


def test_profiler_re_aggregates_an_incomplete_window_on_the_same_agg():
    snap, _ = _snaps(seed=8)

    class HalfSource(_StreamingSource):
        def poll(self):
            if not self._snaps:
                return None
            snap = self._snaps.pop(0)
            self._feeder.on_drain(_cols(snap, 0, len(snap) // 2))
            return snap

    agg = DictAggregator(capacity=1 << 11, device="cpu")
    feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs())
    records = []
    p = CPUProfiler(HalfSource(feeder, [snap]), agg, encode_pipeline=False,
                    on_window=records.append, streaming_feeder=feeder)
    assert p.run_iteration()
    assert feeder.stats["windows_fallback"] == 1
    assert records[0]["streamed"] is False
    assert records[0]["mass"] == snap.total_samples()


def test_profiler_streaming_requires_fast_encode():
    with pytest.raises(ValueError):
        CPUProfiler(None, CPUAggregator(), streaming_feeder=object())


def test_profiler_statics_snapshot_restart(tmp_path):
    """The fast loop's worker writes the snapshot; a second profiler over
    a fresh dictionary adopts it and writes the first run's bytes, with
    no statics built."""
    snap, _ = _snaps(seed=14, n=400, pids=8)
    path = str(tmp_path / "statics.snap")
    out = []
    for run in range(2):
        agg = DictAggregator(capacity=1 << 11, device="cpu", carry=True)
        feeder = StreamingWindowFeeder(agg, FakeMaps(), FakeObjs())
        store = StaticsStore(path)
        w = _Collect()
        p = CPUProfiler(_StreamingSource(feeder, [snap]), agg,
                        profile_writer=w, statics_store=store,
                        statics_snapshot_every=1, streaming_feeder=feeder)
        if run:
            adopt = store.adopt(agg, p.encoder, snap.period_ns)
            assert adopt["adopted"] == len(set(snap.pids.tolist()))
        assert p.run_iteration()
        p.close()
        assert store.stats["snapshots_written"] == 1
        out.append(sorted(w.got, key=lambda x: int(x[0]["pid"])))
        if run:
            assert p.encoder.stats["statics_bytes_built"] == 0
    assert out[0] == out[1]


# -- the port's copies -------------------------------------------------------


def _maps_rows(cls):
    return {
        7: [cls(0x400000, 0x401000, "r-xp", 0, "08:01", 11, "/bin/a"),
            cls(0x500000, 0x501000, "rw-p", 0, "08:01", 11, "/bin/a"),
            cls(0x600000, 0x601000, "r-xp", 0x1000, "08:01", 12,
                "/lib/b.so"),
            cls(0x700000, 0x701000, "r-xp", 0, "00:00", 0, "[vdso]"),
            cls(0x800000, 0x801000, "r-xp", 0, "00:00", 0, "")],
        3: [cls(0x200000, 0x280000, "r-xp", 0x2000, "08:01", 12,
                "/lib/b.so"),
            cls(0x100000, 0x101000, "r-xp", 0, "08:01", 13, "/bin/c")],
    }


class _Obj:
    def __init__(self, base):
        self._base = base

    def base(self):
        if self._base is None:
            raise ValueError("no program headers")
        return self._base


class _ObjCache:
    def get(self, pid, m):
        if m.path == "/bin/c":
            return None
        return _Obj(None if m.path == "/lib/b.so" and pid == 3
                    else m.start - 0x1234)


@pytest.mark.parametrize("objcache", [None, _ObjCache()])
def test_build_mapping_table_equals_the_original(objcache):
    ids = {"/bin/a": "aa", "/lib/b.so": "bb"}
    got = maps.build_mapping_table(_maps_rows(maps.ProcMapping), ids,
                                   objcache=objcache)
    want = jax_maps.build_mapping_table(_maps_rows(jax_maps.ProcMapping),
                                        ids, objcache=objcache)
    for k in ("pids", "starts", "ends", "offsets", "objs", "bases"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.obj_paths == want.obj_paths
    assert got.obj_buildids == want.obj_buildids
    assert len(maps.build_mapping_table({})) == 0


@pytest.mark.parametrize("hashes", [False, True])
@pytest.mark.parametrize("dead", [False, True])
def test_columns_to_snapshot_equals_the_original(hashes, dead):
    """Duplicate rows merged (weights summed), pid -1 rows dropped, the
    carried triple gathered onto the kept rows."""
    snap = generate(SyntheticSpec(**_kw(seed=31, n=200, pids=5)))
    idx = np.r_[np.arange(200), np.arange(0, 200, 3)]
    pids = snap.pids[idx].copy()
    if dead:
        pids[::7] = -1
    rng = np.random.default_rng(31)
    cols = (pids, snap.tids[idx], snap.user_len[idx], snap.kernel_len[idx],
            snap.stacks[idx])
    w = rng.integers(1, 9, len(idx))
    trip = None
    if hashes:
        h = DictAggregator(capacity=1 << 10, device="cpu").hash_rows(
            dataclasses.replace(snap, pids=snap.pids[idx],
                                tids=snap.tids[idx], counts=w,
                                user_len=snap.user_len[idx],
                                kernel_len=snap.kernel_len[idx],
                                stacks=snap.stacks[idx]))
        trip = tuple(np.asarray(x) for x in h)
    got = columns_to_snapshot(*cols, snap.mappings, 10**7, 10**10,
                              weights=w, hashes=trip)
    want = jax_columns_to_snapshot(*cols, snap.mappings, 10**7, 10**10,
                                   weights=w, hashes=trip)
    if hashes:
        (got, gh), (want, wh) = got, want
        for a, b in zip(gh, wh):
            assert np.array_equal(a, b)
    for k in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.total_samples() == int(w[pids >= 0].sum())
    empty = columns_to_snapshot(*(c[:0] for c in cols), snap.mappings, 1, 1)
    assert len(empty) == 0


def test_registry_content_digest_equals_the_original():
    rng = np.random.default_rng(5)
    ms = [ProfileMapping(id=i + 1, start=0x1000 * i, end=0x1000 * i + 0x800,
                         offset=0x10 * i, path=f"/lib/x{i}.so",
                         build_id=f"{i:08x}", base=0x1000 * i - 7)
          for i in range(3)]
    n = 50
    cols = (rng.integers(0, 2**63, n, dtype=np.uint64).tolist(),
            rng.integers(0, 2**63, n, dtype=np.uint64).tolist(),
            rng.integers(0, 4, n).tolist(), (rng.random(n) < 0.3).tolist())
    d = registry_content_digest(ms, *cols)
    assert d == jax_digest(ms, *cols) and len(d) == 16
    assert registry_content_digest(ms[:2], *cols) != d
    assert registry_content_digest([], [], [], [], []) == \
        jax_digest([], [], [], [], [])
