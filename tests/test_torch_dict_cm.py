"""The port's bounded-memory dictionary (overflow="sketch", the CLI's
--aggregator dict+cm) on the CPU against parca_agent_tpu's, bit for bit.

Both DictAggregators see the same windows (numpy, from a seed) at small
capacities (2^6 to 2^13) and must agree after every window: the counts,
the dictionary (id assignment, the host mirror, the eviction clock), the
count-min and HLL tables, sketch_info, every stat, and the sha256 of
every pid's uncompressed pprof. The scenarios: degradation at capacity,
cold-stack rotation, absorption in the middle of a streamed window with
the rotation at the next boundary, delta closes after a rotation, pid
invalidation applied at once and deferred behind a close in flight, and a
degraded JAX state carried into the port by load_state.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.pprof.builder import build_pprof as jax_build_pprof
from parca_agent_tpu_torch.aggregator.dict import (
    DictAggregator,
    _fcfs_slots,
    _probe_free,
)
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import build_pprof

torch.set_num_threads(1)


def _pair(capacity: int, **kw):
    return (JaxDict(capacity=capacity, **kw),
            DictAggregator(capacity=capacity, device="cpu", **kw))


def _pool(seed: int, n: int, n_pids: int = 12):
    return generate(SyntheticSpec(n_pids=n_pids, n_unique_stacks=n, n_rows=n,
                                  total_samples=10 * n, seed=seed))


def _rows(pool, idx, shift: int = 0):
    """Pool rows `idx`; with `shift`, each row's leaf frame moves by that
    many bytes (a new stack, and a new location, in the same mapping)."""
    idx = np.asarray(idx)
    stacks = pool.stacks[idx].copy()
    if shift:
        stacks[:, 0] += np.uint64(shift)
    return dataclasses.replace(
        pool, pids=pool.pids[idx], tids=pool.tids[idx],
        counts=pool.counts[idx], user_len=pool.user_len[idx],
        kernel_len=pool.kernel_len[idx], stacks=stacks)


def _concat(a, b):
    return dataclasses.replace(
        a, pids=np.concatenate([a.pids, b.pids]),
        tids=np.concatenate([a.tids, b.tids]),
        counts=np.concatenate([a.counts, b.counts]),
        user_len=np.concatenate([a.user_len, b.user_len]),
        kernel_len=np.concatenate([a.kernel_len, b.kernel_len]),
        stacks=np.concatenate([a.stacks, b.stacks]))


def _digests(profiles, build) -> dict:
    return {p.pid: hashlib.sha256(build(p, compress=False)).hexdigest()
            for p in profiles}


def _assert_same(jd, pd_):
    assert pd_._next_id == jd._next_id
    assert pd_._key_to_id == jd._key_to_id
    for name in ("_ids", "_h1", "_h2", "_h3", "_occ", "_last_seen"):
        assert np.array_equal(getattr(pd_, name), getattr(jd, name)), name
    n = jd._next_id
    assert np.array_equal(pd_._id_pid[:n], jd._id_pid[:n])
    assert pd_._unreachable == jd._unreachable
    assert set(pd_._pids) == set(jd._pids)
    for name in ("_cm", "_over_hll"):
        a, b = getattr(pd_, name), getattr(jd, name)
        assert (a is None and b is None) or np.array_equal(a, b), name
    assert pd_.sketch_info() == jd.sketch_info()
    assert pd_.stats == jd.stats
    assert pd_._rotate_pending == jd._rotate_pending
    assert pd_._invalidate_pending == jd._invalidate_pending


def _window(jd, pd_, snap, drains: int = 1, hashes=True):
    """One window through both: fed in `drains` drains (capture-carried
    hashes, or self-hashed) and closed; returns the port's counts after
    checking counts, state and pprof bytes equal."""
    hashes = pd_.hash_rows(snap) if hashes else None
    bounds = np.linspace(0, len(snap), drains + 1).astype(int)
    for d in (jd, pd_):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            d.feed(snap, hashes, lo=int(lo), hi=int(hi))
    cj, cp = jd.close_window(), pd_.close_window()
    assert np.array_equal(cp, cj)
    _assert_same(jd, pd_)
    assert _digests(pd_._build_profiles(snap, cp), build_pprof) == \
        _digests(jd._build_profiles(snap, cj), jax_build_pprof)
    return cp


@pytest.mark.parametrize("seed", [2, 3])
def test_degradation_absorbs_like_jax(seed):
    """At capacity the overflow goes to the count-min sideband: no mass
    lost, the estimate never under an absorbed row's count."""
    snap = generate(SyntheticSpec(n_pids=4, n_unique_stacks=100,
                                  total_samples=1000, seed=seed))
    jd, pd_ = _pair(64)  # id_cap 32 << 100 stacks
    hashes = pd_.hash_rows(snap)
    cj = jd.window_counts(snap, hashes)
    cp = pd_.window_counts(snap, hashes)
    assert np.array_equal(cp, cj)
    _assert_same(jd, pd_)
    info = pd_.sketch_info()
    assert int(cp.sum()) + info["sketch_samples"] == snap.total_samples()
    assert info["sketch_rows"] > 0 and info["sketch_distinct_est"] > 0
    h1, h2, h3 = hashes
    in_dict = np.array([(int(a), int(b), int(c)) in pd_._key_to_id
                        for a, b, c in zip(h1, h2, h3)])
    est = pd_.sketch_estimate(h1)
    assert np.array_equal(est, jd.sketch_estimate(h1))
    assert np.all(est[~in_dict] >= snap.counts[~in_dict])
    assert _digests(pd_._build_profiles(snap, cp), build_pprof) == \
        _digests(jd._build_profiles(snap, cj), jax_build_pprof)


@pytest.mark.parametrize("carried", [True, False])
def test_rotation_recycles_cold_ids_like_jax(carried):
    """A fresh population every window (permanent churn) at id_cap 256,
    then a stationary one that becomes resident as rotation clears the
    cold ids."""
    jd, pd_ = _pair(1 << 9, rotate_min_age=2)
    prev = 0
    for w in range(6):
        snap = generate(SyntheticSpec(n_pids=3, n_unique_stacks=200,
                                      n_rows=200, total_samples=2000,
                                      seed=100 + w))
        counts = _window(jd, pd_, snap, hashes=carried)
        assert pd_._next_id <= pd_._id_cap
        absorbed = pd_.sketch_info()["sketch_samples"] - prev
        prev += absorbed
        assert int(counts.sum()) + absorbed == snap.total_samples()
    assert pd_.sketch_info()["rotations"] >= 1
    snap = generate(SyntheticSpec(n_pids=3, n_unique_stacks=100, n_rows=100,
                                  total_samples=1000, seed=999))
    for _ in range(4):
        counts = _window(jd, pd_, snap, drains=2, hashes=carried)
    assert int(counts.sum()) == snap.total_samples()


def test_absorb_mid_window_then_rotation_like_jax():
    """The dictionary fills in the middle of a streamed window: later
    drains' new stacks are absorbed, the rotation runs at the next
    window's first feed, and the window after it is exact."""
    pool = _pool(5, 1200)
    jd, pd_ = _pair(1 << 10, rotate_min_age=1)  # id_cap 512
    _window(jd, pd_, _rows(pool, np.arange(400)), drains=3)
    # 300 new stacks in 5 drains: the id space runs out in the middle.
    snap = _rows(pool, np.arange(400, 700))
    _window(jd, pd_, snap, drains=5)
    assert pd_.stats["sketch_rows"] > 0 and pd_._rotate_pending
    assert pd_._next_id == pd_._id_cap
    before = pd_.stats["sketch_samples"]
    snap = _rows(pool, np.arange(700, 900))
    counts = _window(jd, pd_, snap, drains=4)
    assert pd_.stats["rotations"] == 1
    assert pd_.stats["sketch_samples"] == before  # exact again
    assert int(counts.sum()) == snap.total_samples()


def test_delta_closes_after_rotation_like_jax():
    """A hot set (the first 600 ids, 5 blocks of 128) beside 200 new
    stacks a window, at id_cap 4096: absorption while full, rotation,
    then delta closes of the hot and fresh blocks."""
    pool = _pool(7, 6000, n_pids=40)
    jd, pd_ = _pair(1 << 13, rotate_min_age=2)
    _window(jd, pd_, _rows(pool, np.arange(4096)), drains=2)
    hot = _rows(pool, np.arange(600))
    rotated_at = None
    for w in range(8):
        f0 = 600 + 200 * w
        snap = _concat(hot, _rows(pool, np.arange(f0, f0 + 200),
                                  shift=4 * (w + 1)))
        _window(jd, pd_, snap, drains=3)
        if rotated_at is None and pd_.stats.get("rotations"):
            rotated_at = pd_.stats.get("delta_closes", 0)
    assert rotated_at is not None
    assert pd_.stats.get("delta_closes", 0) > rotated_at
    assert pd_.stats["sketch_rows"] > 0


def test_invalidate_pid_now_and_deferred_like_jax():
    """invalidate_pid at a boundary drops the pid's ids at once; called
    while a close is in flight it is deferred to the next window's first
    feed. The pid's stacks then register afresh."""
    pool = _pool(9, 900)
    jd, pd_ = _pair(1 << 12)
    snap = _rows(pool, np.arange(900))
    _window(jd, pd_, snap, drains=2)
    pid_a, pid_b = int(pool.pids[0]), int(pool.pids[-1])
    assert [d.invalidate_pid(pid_a) for d in (jd, pd_)] == [True, True]
    _assert_same(jd, pd_)
    assert pid_a not in pd_._pids
    assert pid_a not in pd_._id_pid[:pd_._next_id]
    assert pd_.stats["invalidation_compactions"] == 1
    hashes = pd_.hash_rows(snap)
    for d in (jd, pd_):
        d.feed(snap, hashes)
    handles = [d.close_dispatch() for d in (jd, pd_)]
    assert [d.invalidate_pid(pid_b) for d in (jd, pd_)] == [False, False]
    cj, cp = (d.close_collect(h) for d, h in zip((jd, pd_), handles))
    assert np.array_equal(cp, cj) and int(cp.sum()) == snap.total_samples()
    _assert_same(jd, pd_)
    assert pid_a in pd_._pids and pid_b in pd_._invalidate_pending
    _window(jd, pd_, snap, drains=3)
    assert pd_.stats["pid_invalidations"] == 2
    assert pd_.stats["invalidation_compactions"] == 2
    assert not pd_._invalidate_pending


@pytest.mark.parametrize("home", [0x5A5A5, 0xFFFFFFF0])
def test_compaction_rebuilds_probe_bound_chains_like_jax(home):
    """Capture-carried hashes whose h1 repeats put keys past the probe
    bound (at 0xFFFFFFF0 the chain runs past the table's last slot and
    wraps); an invalidation's compaction re-inserts every survivor, and
    the rebuilt chains (and which keys sit past the bound) must be the
    JAX package's."""
    pool = _pool(15, 600)
    jd, pd_ = _pair(1 << 11)
    snap = _rows(pool, np.arange(600))
    h1, h2, h3 = pd_.hash_rows(snap)
    h1 = h1.copy()
    h1[::4] = np.uint32(home)  # one home slot for a quarter of the rows
    for _ in range(2):
        for d in (jd, pd_):
            d.feed(snap, (h1, h2, h3), hi=300)
            d.feed(snap, (h1, h2, h3), lo=300)
        assert np.array_equal(pd_.close_window(), jd.close_window())
        _assert_same(jd, pd_)
        assert len(pd_._unreachable) > 50
        pid = int(pool.pids[1])
        assert [d.invalidate_pid(pid) for d in (jd, pd_)] == [True, True]
        _assert_same(jd, pd_)
    assert pd_.stats["unreachable_rows"] == jd.stats["unreachable_rows"] > 0


@pytest.mark.parametrize("case", ["spread", "crowded", "wrapping",
                                  "one_home", "half_full"])
def test_fcfs_slots_equal_one_by_one_insertion(case):
    """The compaction's vectorized re-insertion gives the slots that
    _probe_free gives inserting the keys one by one, in order, into an
    empty table, runs that wrap past the last slot included."""
    cap = 1 << 12
    rng = np.random.default_rng(17)
    home = {
        "spread": rng.integers(0, cap, 600),
        "crowded": rng.integers(0, cap // 8, 1200),
        "wrapping": (cap - 1 - rng.integers(0, 64, 900)) % cap,
        "one_home": np.full(700, cap - 3),
        "half_full": rng.integers(0, cap, cap // 2),
    }[case].astype(np.int64)
    occ = np.zeros(cap, bool)
    want = []
    for h in home.tolist():
        want.append(_probe_free(occ, h))
        occ[want[-1]] = True
    assert np.array_equal(_fcfs_slots(home, cap), np.array(want))


def _jax_state(jd) -> dict:
    """The fields load_state takes, read off a JAX DictAggregator."""
    n = jd._next_id
    return {
        "h1": jd._h1, "h2": jd._h2, "h3": jd._h3, "occ": jd._occ,
        "ids": jd._ids, "next_id": n,
        "id_pid": jd._id_pid[:n], "loc_off": jd._loc_off[:n + 1],
        "loc_flat": jd._loc_flat[:int(jd._loc_off[n])],
        "id_h1": jd._id_h1[:n], "id_h2": jd._id_h2[:n],
        "last_seen": jd._last_seen, "windows": jd.stats["windows"],
        "registries": {
            pid: {"loc_address": r.loc_address,
                  "loc_normalized": r.loc_normalized,
                  "loc_mapping_id": r.loc_mapping_id,
                  "loc_is_kernel": r.loc_is_kernel,
                  "mappings": [(m.id, m.start, m.end, m.offset, m.path,
                                m.build_id, m.base) for m in r.mappings]}
            for pid, r in jd._pids.items()},
        "unreachable": [(*k, sid) for k, sid in jd._unreachable.items()],
        "cm": jd._cm, "over_hll": jd._over_hll,
        "rotate_pending": jd._rotate_pending,
        "invalidate_pending": sorted(jd._invalidate_pending),
        "sketch_stats": {k: jd.stats[k] for k in (
            "sketch_rows", "sketch_samples", "rotations",
            "pid_invalidations", "invalidation_compactions")
            if k in jd.stats},
    }


def test_degraded_jax_state_carried_into_port():
    """A JAX dictionary that is full, has absorbed overflow, wants a
    rotation and holds a deferred invalidation goes into the port by
    load_state; the next windows (the rotation, the invalidation, exact
    inserts) then agree."""
    pool = _pool(11, 1500)
    jd = JaxDict(capacity=1 << 10, rotate_min_age=1)
    hot = _rows(pool, np.arange(100))
    for w, idx in enumerate((np.arange(512), np.arange(512, 800))):
        snap = _concat(hot, _rows(pool, idx, shift=4 * w)) if w else \
            _rows(pool, idx)
        jd.feed(snap, jd.hash_rows(snap))
        h = jd.close_dispatch()
        if w:
            assert jd.invalidate_pid(int(pool.pids[3])) is False
        jd.close_collect(h)
    assert jd._rotate_pending and jd._invalidate_pending
    assert jd.stats["sketch_rows"] > 0
    pd_ = DictAggregator(capacity=1 << 10, rotate_min_age=1, device="cpu")
    pd_.load_state(_jax_state(jd))
    assert pd_.sketch_info() == jd.sketch_info()
    carried = ("sketch_rows", "sketch_samples", "rotations",
               "pid_invalidations", "invalidation_compactions")
    assert {k: v for k, v in pd_.stats.items() if k in carried} == \
        {k: v for k, v in jd.stats.items() if k in carried}
    # The run's other counters (inserts, closes, ...) are not carried as
    # state; start them where the JAX run stands so every later window
    # compares them too.
    pd_.stats.update({k: v for k, v in jd.stats.items()
                      if k not in carried})
    _assert_same(jd, pd_)
    for w in range(3):
        snap = _concat(hot, _rows(pool, np.arange(800 + 150 * w,
                                                  950 + 150 * w)))
        counts = _window(jd, pd_, snap, drains=2)
        if w == 0:  # rotated and invalidated at its first feed: exact
            assert pd_.stats["rotations"] == 1
            assert pd_.stats["pid_invalidations"] == 1
            assert int(pool.pids[3]) in pd_._pids  # registered afresh
            assert int(counts.sum()) == snap.total_samples()
    # By the third window the fresh stacks have filled it again.
    assert pd_._rotate_pending and pd_.stats["sketch_rows"] > 288


def test_sketch_state_export_load_round_trip():
    pool = _pool(13, 400)
    a = DictAggregator(capacity=1 << 8, device="cpu")
    a.window_counts(_rows(pool, np.arange(300)))
    assert a._rotate_pending and a._cm is not None
    b = DictAggregator(capacity=1 << 8, device="cpu")
    b.load_state(a.export_state())
    for name in ("_cm", "_over_hll"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert b.sketch_info() == a.sketch_info() and b._rotate_pending
    snap = _rows(pool, np.arange(300, 400))
    assert np.array_equal(a.window_counts(snap), b.window_counts(snap))
    assert a.sketch_info() == b.sketch_info()
    state = a.export_state()
    state["cm"] = state["cm"][:, :1 << 8]  # another sketch's shape
    with pytest.raises(ValueError, match="count-min"):
        DictAggregator(capacity=1 << 8, device="cpu").load_state(state)
