"""The port's warm statics snapshot (pprof/statics_store.py) against
parca_agent_tpu's.

The contract: a snapshot-warmed aggregator and encoder give pprof bytes
equal to a cold-built pair over the same windows — across a rotation and
pid churn — while a stale, corrupt or torn snapshot degrades to a cold
build for exactly the records it touches. The file format is the JAX
package's byte for byte: each package adopts the other's snapshot, and
both write the same bytes for the same state. The cases are those of
tests/test_statics_store.py that apply to the port (its chaos-site cases
provoke the write failure with an unwritable path instead).
"""

from __future__ import annotations

import os
import threading
import zlib

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof.statics_store import StaticsStore as JaxStore
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof import statics_store as ss
from parca_agent_tpu_torch.pprof.statics_store import StaticsStore
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.profiler.encode_pipeline import EncodePipeline

torch.set_num_threads(1)


def _kw(seed=7, n_pids=10, rows=300):
    return dict(n_pids=n_pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=rows * 4, mean_depth=8, kernel_fraction=0.25,
                seed=seed)


def _agg(cap=1 << 12, **kw):
    return DictAggregator(capacity=cap, device="cpu", **kw)


def _warm_pair(tmp_path, seed=7, n_pids=10, rows=300):
    """One aggregated and encoded window, snapshotted to disk. Returns
    (window, store, path)."""
    snap = generate(SyntheticSpec(**_kw(seed, n_pids, rows)))
    agg = _agg()
    enc = WindowEncoder(agg)
    counts = agg.window_counts(snap)
    enc.encode(counts, snap.time_ns, snap.window_ns, snap.period_ns)
    path = str(tmp_path / "statics.snap")
    store = StaticsStore(path)
    assert store.save(agg, enc, snap.period_ns)
    return snap, store, path


def _blobs(out):
    return [(pid, bytes(b)) for pid, b in out]


def _encode(enc, counts, snap, period=None):
    return _blobs(enc.encode(counts, snap.time_ns, snap.window_ns,
                             snap.period_ns if period is None else period))


_FHEAD = len(ss._FMARK) + ss._FRAME.size  # marker + len/crc header


def _frames(data: bytes):
    """(frame offset, payload length) of every frame after the magic."""
    out = []
    off = len(ss._MAGIC)
    while off < len(data):
        assert data[off: off + len(ss._FMARK)] == ss._FMARK
        length, _crc = ss._FRAME.unpack_from(data, off + len(ss._FMARK))
        out.append((off, length))
        off += _FHEAD + length
    return out


def _adopt_both(path, period_ns, **store_kw):
    """Adopt `path` into a cold port pair and a cold parca_agent_tpu pair;
    the outcomes must be equal. Returns the port's outcome and pair."""
    agg, jagg = _agg(), JaxDict(capacity=1 << 12)
    enc = WindowEncoder(agg)
    out = StaticsStore(path, **store_kw).adopt(agg, enc, period_ns)
    jout = JaxStore(path, **store_kw).adopt(jagg, JaxEncoder(jagg),
                                            period_ns)
    assert out == jout
    return out, agg, enc


# -- warm-restart byte identity ----------------------------------------------


def test_adoption_outcomes_all_adopted(tmp_path):
    snap, store, path = _warm_pair(tmp_path)
    out, _agg2, enc2 = _adopt_both(path, snap.period_ns)
    n_pids = len({int(p) for p in snap.pids})
    assert out == {"adopted": n_pids, "stale": 0, "corrupt": 0,
                   "outcome": "adopted"}
    assert enc2.stats["statics_adopted_pids"] == n_pids


def test_warm_encoder_byte_identical_to_cold(tmp_path):
    """A snapshot-warmed restart's bytes equal a cold encoder's on the
    same state and the bytes before the restart; nothing was encoded."""
    snap, store, _ = _warm_pair(tmp_path)
    agg1 = _agg()
    c1 = agg1.window_counts(snap)
    ref = _encode(WindowEncoder(agg1), c1, snap)
    agg2 = _agg()
    enc2 = WindowEncoder(agg2)
    store.adopt(agg2, enc2, snap.period_ns)
    c2 = agg2.window_counts(snap)
    warm = _encode(enc2, c2, snap)
    assert warm == _encode(WindowEncoder(agg2), c2, snap)
    assert warm == ref
    assert enc2.stats["statics_bytes_built"] == 0


@pytest.mark.parametrize("with_carry", [False, True])
def test_warm_byte_identity_across_rotation_and_churn(tmp_path, with_carry):
    """Warm against cold through a rotation (statics dropped, the content
    cache serves the rebuild) and pid churn (a pid dead one window, back
    the next), with and without the carry."""
    snap, store, _ = _warm_pair(tmp_path, seed=9, n_pids=8, rows=250)
    pairs = []
    for warm in (True, False):
        agg = _agg(rotate_min_age=1, carry=with_carry)
        enc = WindowEncoder(agg)
        if warm:
            assert store.adopt(agg, enc, snap.period_ns)["adopted"] > 0
        pairs.append((agg, enc))
    snap2 = generate(SyntheticSpec(**_kw(seed=10, n_pids=8, rows=250)))
    for w in range(4):
        outs = []
        for agg, enc in pairs:
            if w == 1:
                agg.window_counts(snap2)  # age snap's ids
                agg._rotate_pending = True
            c = agg.window_counts(snap)
            if w == 2:  # pid churn: one whole pid dead this window
                c[agg._id_pid[: len(c)] == int(snap.pids[0])] = 0
            outs.append(_blobs(enc.encode(
                c, snap.time_ns + w, snap.window_ns, snap.period_ns)))
        assert outs[0] == outs[1], f"window {w} diverged"
    assert pairs[0][0].stats.get("rotations", 0) == 1


def test_period_mismatch_adopts_registry_counts_stale(tmp_path):
    """A snapshot at another period still warms registries and location
    blobs; head/tail rebuild, and the bytes equal a cold build's."""
    snap, store, path = _warm_pair(tmp_path)
    other = snap.period_ns + 12345
    out, agg2, enc2 = _adopt_both(path, other)
    assert out["adopted"] > 0 and out["stale"] == out["adopted"]
    c2 = agg2.window_counts(snap)
    assert _encode(enc2, c2, snap, other) == \
        _encode(WindowEncoder(agg2), c2, snap, other)


# -- corruption and staleness -------------------------------------------------


def test_any_single_corrupt_record_is_discarded_rest_adopt(tmp_path):
    """One byte flipped inside record k: exactly that record reads
    corrupt (in both packages), the others adopt, and the window still
    encodes to the cold bytes."""
    snap, store, path = _warm_pair(tmp_path)
    data = open(path, "rb").read()
    records = _frames(data)[1:]  # frame 0 is the json header
    n = len(records)
    assert n == len({int(p) for p in snap.pids})
    for k, (off, length) in enumerate(records):
        mut = bytearray(data)
        mut[off + _FHEAD + length // 2] ^= 0xFF
        open(path, "wb").write(bytes(mut))
        out, agg, enc = _adopt_both(path, snap.period_ns)
        assert out["corrupt"] == 1 and out["adopted"] == n - 1, k
        c = agg.window_counts(snap)
        assert _encode(enc, c, snap) == _encode(WindowEncoder(agg), c,
                                                snap), k


def test_digest_mismatch_with_valid_crc_is_corrupt(tmp_path):
    """A payload mutated with its CRC recomputed is caught by the registry
    content digest."""
    snap, store, path = _warm_pair(tmp_path)
    data = bytearray(open(path, "rb").read())
    off, length = _frames(bytes(data))[1]
    payload = bytearray(data[off + _FHEAD: off + _FHEAD + length])
    payload[ss._REC_HEAD.size - 1] ^= 0xFF  # flip a digest byte
    ss._FRAME.pack_into(data, off + len(ss._FMARK), length,
                        zlib.crc32(bytes(payload)))
    data[off + _FHEAD: off + _FHEAD + length] = payload
    open(path, "wb").write(bytes(data))
    out, _a, _e = _adopt_both(path, snap.period_ns)
    assert out["corrupt"] == 1


def test_truncated_snapshot_salvages_prefix(tmp_path):
    snap, store, path = _warm_pair(tmp_path)
    data = open(path, "rb").read()
    frames = _frames(data)
    off, length = frames[-1]  # cut inside the LAST record
    open(path, "wb").write(data[: off + _FHEAD + length // 2])
    out, agg, _enc = _adopt_both(path, snap.period_ns)
    assert out["adopted"] == len(frames) - 2 and out["corrupt"] == 1
    assert int(agg.window_counts(snap).sum()) == snap.total_samples()


def test_garbage_and_missing_snapshot(tmp_path):
    agg = _agg(1 << 10)
    enc = WindowEncoder(agg)
    missing = StaticsStore(str(tmp_path / "nope.snap"))
    assert missing.adopt(agg, enc, 1)["outcome"] == "absent"
    bad = str(tmp_path / "bad.snap")
    open(bad, "wb").write(b"not a snapshot at all")
    assert StaticsStore(bad).adopt(agg, enc, 1)["outcome"] == "corrupt"


def test_old_snapshot_is_stale(tmp_path):
    snap, _, path = _warm_pair(tmp_path)
    clk = {"t": 1e9}
    store = StaticsStore(path, max_age_s=60.0, clock=lambda: clk["t"])
    agg = _agg()
    enc = WindowEncoder(agg)
    agg.window_counts(snap)
    assert store.save(agg, enc, snap.period_ns)
    os.utime(path, times=(clk["t"], clk["t"]))
    clk["t"] += 61.0
    out = store.adopt(_agg(), WindowEncoder(_agg()), snap.period_ns)
    assert out["outcome"] == "stale" and out["adopted"] == 0


def test_clean_skip_keeps_snapshot_fresh(tmp_path):
    """A stationary run (every interval clean-skipped) keeps the snapshot
    adoptable: the skip refreshes the file's mtime."""
    snap = generate(SyntheticSpec(**_kw(seed=18, n_pids=4, rows=80)))
    path = str(tmp_path / "fresh.snap")
    clk = {"t": 1e9}
    store = StaticsStore(path, max_age_s=60.0, clock=lambda: clk["t"])
    agg = _agg(1 << 11)
    enc = WindowEncoder(agg)
    agg.window_counts(snap)
    enc.build_statics(snap.period_ns)       # clean marker -> skippable
    assert store.save(agg, enc, snap.period_ns)
    os.utime(path, times=(clk["t"], clk["t"]))
    for _ in range(5):
        clk["t"] += 50.0
        assert store.save(agg, enc, snap.period_ns) == "skipped"
    clk["t"] += 30.0                         # 280 s since content write
    out = store.adopt(_agg(1 << 11), WindowEncoder(_agg(1 << 11)),
                      snap.period_ns)
    assert out["outcome"] == "adopted" and out["adopted"] == 4


def test_adopt_into_live_pid_refused_as_stale(tmp_path):
    snap, store, _ = _warm_pair(tmp_path)
    agg = _agg()
    agg.window_counts(snap)  # registries already live
    out = store.adopt(agg, WindowEncoder(agg), snap.period_ns)
    assert out["adopted"] == 0
    assert out["stale"] == len({int(p) for p in snap.pids})


def test_snapshot_byte_cap_drops_records_counted(tmp_path):
    snap = generate(SyntheticSpec(**_kw(seed=11, n_pids=6, rows=150)))
    agg = _agg()
    enc = WindowEncoder(agg)
    enc.encode(agg.window_counts(snap), snap.time_ns, snap.window_ns,
               snap.period_ns)
    store = StaticsStore(str(tmp_path / "tiny.snap"), max_bytes=4096)
    assert store.save(agg, enc, snap.period_ns)
    assert store.stats["records_dropped_cap"] > 0
    assert store.stats["snapshot_records"] < 6
    agg2 = _agg()
    assert store.adopt(agg2, WindowEncoder(agg2),
                       snap.period_ns)["corrupt"] == 0


def test_write_failure_counted_not_fatal(tmp_path):
    """A save into a directory that does not exist fails, counted; once
    the directory exists the next save lands."""
    snap = generate(SyntheticSpec(**_kw(seed=12, n_pids=4, rows=80)))
    agg = _agg(1 << 11)
    enc = WindowEncoder(agg)
    agg.window_counts(snap)
    path = tmp_path / "later" / "statics.snap"
    store = StaticsStore(str(path))
    assert store.save(agg, enc, snap.period_ns) is False
    assert store.stats["snapshot_write_errors"] == 1
    assert not path.exists()
    path.parent.mkdir()
    assert store.save(agg, enc, snap.period_ns)
    assert store.stats["snapshots_written"] == 1


def test_pipeline_snapshot_failure_no_disable_no_double_ship(tmp_path):
    """A failed snapshot on the encode worker neither disables the
    pipeline nor re-ships the window; the next interval's snapshot
    lands."""
    snap = generate(SyntheticSpec(**_kw(seed=13, n_pids=4, rows=80)))
    agg = _agg(1 << 11)
    counts = agg.window_counts(snap)
    enc = WindowEncoder(agg)
    path = tmp_path / "later" / "statics.snap"
    store = StaticsStore(str(path))
    shipped = []
    pipe = EncodePipeline(
        enc, ship=lambda out, prep: shipped.append(len(out)),
        snapshot=lambda period_ns: store.save(agg, enc, period_ns),
        snapshot_every=1)
    assert pipe.submit(counts, snap.time_ns, snap.window_ns,
                       snap.period_ns) is not None
    assert pipe.quiesce(10)
    assert not pipe.disabled
    assert pipe.stats["snapshot_errors"] == 1
    assert pipe.stats["snapshots_written"] == 0
    assert shipped == [4]
    path.parent.mkdir()
    assert pipe.submit(counts, snap.time_ns + 1, snap.window_ns,
                       snap.period_ns) is not None
    assert pipe.close()
    assert pipe.stats["snapshots_written"] == 1
    assert shipped == [4, 4]
    assert store.snapshot_info()["present"]


def test_corrupt_snapshot_degrades_to_cold_zero_windows_lost(tmp_path):
    snap, store, path = _warm_pair(tmp_path, seed=14, n_pids=5, rows=100)
    data = bytearray(open(path, "rb").read())
    for i in range(len(ss._MAGIC), len(data), 7):
        data[i] ^= 0xA5
    open(path, "wb").write(bytes(data))
    out, agg, enc = _adopt_both(path, snap.period_ns)
    assert out["adopted"] == 0
    shipped = []
    pipe = EncodePipeline(enc, ship=lambda o, p: shipped.append(len(o)))
    c = agg.window_counts(snap)
    assert int(c.sum()) == snap.total_samples()
    assert pipe.submit(c, snap.time_ns, snap.window_ns,
                       snap.period_ns) is not None
    assert pipe.close()
    assert shipped == [5] and pipe.stats["windows_lost"] == 0


# -- pipeline scheduling -------------------------------------------------------


def test_pipeline_writes_snapshot_on_worker_thread(tmp_path):
    snap = generate(SyntheticSpec(**_kw(seed=15, n_pids=4, rows=80)))
    agg = _agg(1 << 11)
    counts = agg.window_counts(snap)
    enc = WindowEncoder(agg)
    store = StaticsStore(str(tmp_path / "w.snap"))
    calls = []

    def snapshot(period_ns):
        calls.append((period_ns, threading.get_ident()))
        return store.save(agg, enc, period_ns)

    pipe = EncodePipeline(enc, ship=lambda o, p: None,
                          snapshot=snapshot, snapshot_every=2)
    for k in range(4):
        assert pipe.submit(counts, snap.time_ns + k, snap.window_ns,
                           snap.period_ns) is not None
        assert pipe.flush(10)
    assert pipe.close()
    assert len(calls) == 2                       # every 2nd window
    assert all(p == snap.period_ns for p, _ in calls)
    assert all(t != threading.get_ident() for _, t in calls)
    assert pipe.stats["snapshots_written"] == 2
    assert store.stats["snapshots_written"] == 2


def test_header_corruption_never_skips_records_silently(tmp_path):
    snap, store, path = _warm_pair(tmp_path)
    data = bytearray(open(path, "rb").read())
    off, _length = _frames(bytes(data))[0]     # the json header frame
    data[off + _FHEAD] ^= 0xFF
    open(path, "wb").write(bytes(data))
    n = len({int(p) for p in snap.pids})
    out, _a, _e = _adopt_both(path, snap.period_ns)
    assert out["outcome"] == "stale" and out["adopted"] == 0
    assert out["stale"] == n and out["corrupt"] == 1
    out2, _a, _e = _adopt_both(path, snap.period_ns, max_age_s=None)
    assert out2["adopted"] == n and out2["corrupt"] == 1
    assert out2["stale"] == 0


def test_registry_digest_identity_after_adoption(tmp_path):
    """An adopted registry digests equal to one rebuilt by replaying the
    same window, and to parca_agent_tpu's."""
    snap, store, _ = _warm_pair(tmp_path)
    replayed = _agg()
    replayed.window_counts(snap)
    jreplayed = JaxDict(capacity=1 << 12)
    jreplayed.window_counts(jax_generate(JaxSpec(**_kw())))
    adopted = _agg()
    store.adopt(adopted, WindowEncoder(adopted), snap.period_ns)
    assert adopted.registry_epoch == 0
    assert set(replayed._pids) == set(adopted._pids) == set(jreplayed._pids)
    for pid in replayed._pids:
        d = replayed.registry_digest(pid)
        assert d is not None
        assert d == adopted.registry_digest(pid) \
            == jreplayed.registry_digest(pid), pid
        assert replayed.registry_digest(pid, 1, 3) == \
            jreplayed.registry_digest(pid, 1, 3)
    assert replayed.registry_digest(999999) is None
    assert not adopted.adopt_registry(int(snap.pids[0]), [], [], [], [], [])


def test_save_skips_when_nothing_changed(tmp_path):
    snap = generate(SyntheticSpec(**_kw(seed=16, n_pids=4, rows=80)))
    agg = _agg(1 << 11)
    enc = WindowEncoder(agg)
    agg.window_counts(snap)
    enc.build_statics(snap.period_ns)      # full scan -> clean marker
    store = StaticsStore(str(tmp_path / "s.snap"))
    assert store.save(agg, enc, snap.period_ns)
    assert store.save(agg, enc, snap.period_ns) == "skipped"
    assert store.stats["snapshots_written"] == 1
    assert store.stats["snapshots_skipped_clean"] == 1
    snap2 = generate(SyntheticSpec(**_kw(seed=17, n_pids=6, rows=120)))
    agg.window_counts(snap2)               # registry mutation re-arms
    enc.build_statics(snap.period_ns)
    assert store.save(agg, enc, snap.period_ns) is True
    assert store.stats["snapshots_written"] == 2


def test_adopt_bounds_the_read_itself(tmp_path):
    path = str(tmp_path / "big.snap")
    open(path, "wb").write(ss._MAGIC + b"\xa5" * 4096)
    out, _a, _e = _adopt_both(path, 1, max_bytes=1024)
    assert out["outcome"] == "corrupt" and out["adopted"] == 0


def test_header_only_snapshot_is_empty_not_corrupt(tmp_path):
    agg = _agg(1 << 10)
    store = StaticsStore(str(tmp_path / "empty.snap"))
    assert store.save(agg, WindowEncoder(agg), 10_000_000)
    out, _a, _e = _adopt_both(store.path, 10_000_000)
    assert out == {"adopted": 0, "stale": 0, "corrupt": 0,
                   "outcome": "empty"}


def test_corrupt_length_field_resyncs_to_next_record(tmp_path):
    snap, store, path = _warm_pair(tmp_path)
    data = bytearray(open(path, "rb").read())
    frames = _frames(bytes(data))
    victim, _length = frames[2]            # a middle pid record
    ss._FRAME.pack_into(data, victim + len(ss._FMARK), 0x7FFFFFFF, 0)
    open(path, "wb").write(bytes(data))
    out, _a, _e = _adopt_both(path, snap.period_ns)
    assert out["adopted"] == len(frames) - 2 and out["corrupt"] >= 1


# -- across the packages -------------------------------------------------------


def _jax_pair(seed, n_pids, rows):
    jsnap = jax_generate(JaxSpec(**_kw(seed, n_pids, rows)))
    jagg = JaxDict(capacity=1 << 12)
    jenc = JaxEncoder(jagg)
    jc = np.asarray(jagg.window_counts(jsnap))
    jenc.encode(jc, jsnap.time_ns, jsnap.window_ns, jsnap.period_ns)
    return jsnap, jagg, jenc


@pytest.mark.parametrize("seed", [7, 19])
def test_snapshot_file_bytes_equal_jax(tmp_path, seed):
    """The same state written by both packages with the same clock gives
    the same file, byte for byte."""
    snap = generate(SyntheticSpec(**_kw(seed, 10, 300)))
    agg = _agg()
    enc = WindowEncoder(agg)
    enc.encode(agg.window_counts(snap), snap.time_ns, snap.window_ns,
               snap.period_ns)
    jsnap, jagg, jenc = _jax_pair(seed, 10, 300)
    clock = lambda: 1_700_000_000.25  # noqa: E731
    mine, theirs = tmp_path / "port.snap", tmp_path / "jax.snap"
    assert StaticsStore(str(mine), clock=clock).save(agg, enc,
                                                     snap.period_ns)
    assert JaxStore(str(theirs), clock=clock).save(jagg, jenc,
                                                   jsnap.period_ns)
    assert mine.read_bytes() == theirs.read_bytes()


def test_jax_snapshot_adopts_in_the_port(tmp_path):
    """A snapshot parca_agent_tpu wrote warms the port: every record
    adopts, nothing is encoded again, and the warm bytes equal a cold
    parca_agent_tpu encoder's on the same window."""
    jsnap, jagg, jenc = _jax_pair(23, 10, 300)
    path = str(tmp_path / "jax.snap")
    assert JaxStore(path).save(jagg, jenc, jsnap.period_ns)
    snap = generate(SyntheticSpec(**_kw(23, 10, 300)))
    agg = _agg()
    enc = WindowEncoder(agg)
    out = StaticsStore(path).adopt(agg, enc, snap.period_ns)
    assert out["adopted"] == len(jagg._pids) and out["corrupt"] == 0
    warm = _encode(enc, agg.window_counts(snap), snap)
    assert enc.stats["statics_bytes_built"] == 0
    jcold = JaxDict(capacity=1 << 12)
    jc = np.asarray(jcold.window_counts(jsnap))
    assert warm == _blobs(JaxEncoder(jcold).encode(
        jc, jsnap.time_ns, jsnap.window_ns, jsnap.period_ns))


def test_port_snapshot_adopts_in_jax(tmp_path):
    """And back: the port's snapshot warms parca_agent_tpu, whose warm
    bytes equal the port's cold encoder's."""
    snap, store, path = _warm_pair(tmp_path, seed=29)
    jsnap = jax_generate(JaxSpec(**_kw(29)))
    jagg = JaxDict(capacity=1 << 12)
    jenc = JaxEncoder(jagg)
    out = JaxStore(path).adopt(jagg, jenc, jsnap.period_ns)
    assert out["adopted"] == len({int(p) for p in snap.pids})
    jc = np.asarray(jagg.window_counts(jsnap))
    jwarm = _blobs(jenc.encode(jc, jsnap.time_ns, jsnap.window_ns,
                               jsnap.period_ns))
    assert jenc.stats["statics_bytes_built"] == 0
    cold = _agg()
    assert jwarm == _encode(WindowEncoder(cold), cold.window_counts(snap),
                            snap)


def test_cli_second_run_adopts_the_snapshot(tmp_path, capsys):
    """--statics-snapshot-path on the CLI: the first run's encode worker
    writes the snapshot, the second run adopts every pid before its first
    window and writes the same profiles."""
    import json

    from parca_agent_tpu_torch import cli

    snap_path = str(tmp_path / "statics.snap")
    runs = []
    for k in range(2):
        store = tmp_path / f"profiles{k}"
        assert cli.run(["--device", "cpu", "--http-address", "127.0.0.1:0",
                        "--fast-encode", "--windows", "1",
                        "--profiling-duration", "0.01",
                        "--statics-snapshot-path", snap_path,
                        "--statics-snapshot-interval", "1",
                        "--local-store-directory", str(store)]) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.splitlines() if ln.startswith("{")]
        runs.append((lines, {p.name: p.read_bytes()
                             for p in store.glob("*.pb.gz")}))
    (first, files0), (second, files1) = runs
    assert first[0]["statics_adopt"]["outcome"] == "absent"
    assert first[-1]["statics_snapshot"]["snapshots_written"] == 1
    assert second[0]["statics_adopt"]["adopted"] == \
        first[1]["profiles"] == 1000
    assert second[0]["statics_adopt"]["corrupt"] == 0
    assert len(files0) == len(files1) == 1000


def test_cli_replay_adopts_at_the_windows_own_period(tmp_path, capsys):
    """--capture replay of windows sampled at 250 Hz: the second run adopts
    every pid's statics (none stale), since adoption is held to the
    replayed windows' period, not the synthetic source's 100 Hz."""
    import dataclasses
    import json

    from parca_agent_tpu_torch import cli
    from parca_agent_tpu_torch.capture.formats import save_snapshot

    snap = dataclasses.replace(generate(SyntheticSpec(**_kw())),
                               period_ns=4_000_000)
    window = str(tmp_path / "w0.snap")
    save_snapshot(snap, window)
    snap_path = str(tmp_path / "statics.snap")
    adopts = []
    for k in range(2):
        assert cli.run(["--device", "cpu", "--http-address", "127.0.0.1:0",
                        "--fast-encode", "--capture",
                        "replay", "--replay", window,
                        "--profiling-duration", "0.01",
                        "--statics-snapshot-path", snap_path,
                        "--statics-snapshot-interval", "1",
                        "--local-store-directory",
                        str(tmp_path / f"profiles{k}")]) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.splitlines() if ln.startswith("{")]
        adopts.append(lines[0]["statics_adopt"])
    pids = len(np.unique(snap.pids))
    assert adopts[0]["outcome"] == "absent"
    assert adopts[1]["adopted"] == pids
    assert adopts[1]["stale"] == 0 and adopts[1]["corrupt"] == 0
