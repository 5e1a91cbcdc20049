"""The port's cross-drain carry cache against parca_agent_tpu's.

DictAggregator(carry=True) folds a stack's mass on the host from its
second drain on and flushes it once at the close. Every case feeds the
same seeded drains to the port's dictionary (on the CPU) with and without
the carry and to parca_agent_tpu's with it: counts, id assignment, the
carry's own counters and the pprof bytes must be equal. The cases are
those of tests/test_feed_carry.py that apply to the port, plus a window
carried whole (nothing dispatched) and the carry across an invalidation's
compaction.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu.utils import faults
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder

CAP = 1 << 12
# The carry's counters, moved alike in both packages.
_CARRY_STATS = ("carry_rows_in", "carry_hits", "carry_mass",
                "carry_admitted", "carry_entries", "carry_flushes",
                "carry_discards", "carry_fallbacks", "inserts")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.install(None)


def _spec(seed, rows, pids, per_row=3):
    return dict(n_pids=pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=rows * per_row, mean_depth=8, seed=seed)


def _dup(snap, dup=2):
    """Every row twice: a drain the coalesce fold halves."""
    idx = np.repeat(np.arange(len(snap)), dup)
    return dataclasses.replace(
        snap, pids=snap.pids[idx],
        tids=np.arange(len(idx), dtype=np.int32),
        counts=snap.counts[idx], user_len=snap.user_len[idx],
        kernel_len=snap.kernel_len[idx], stacks=snap.stacks[idx])


def _snaps(seed=1, rows=512, pids=8, dup=2):
    """The same window in each package: (port snapshot, JAX snapshot)."""
    kw = _spec(seed, rows, pids)
    return (_dup(generate(SyntheticSpec(**kw)), dup),
            _dup(jax_generate(JaxSpec(**kw)), dup))


def _stats(agg) -> dict:
    return {k: agg.stats.get(k, 0) for k in _CARRY_STATS}


def _digest(blobs) -> str:
    h = hashlib.sha256()
    for pid, blob in sorted(blobs):
        h.update(str(pid).encode())
        h.update(bytes(blob))
    return h.hexdigest()


def _trio(**kw):
    """(port without carry, port with carry, parca_agent_tpu with it)."""
    return (DictAggregator(capacity=CAP, device="cpu", **kw),
            DictAggregator(capacity=CAP, device="cpu", carry=True, **kw),
            JaxDict(capacity=CAP, coalesce=True, carry=True, **kw))


@pytest.mark.parametrize("seed", [3, 4])
def test_steady_state_carries_with_counts_of_no_carry(seed):
    """Window 1 dispatches and admits; its second drain and every drain
    of windows 2 and 3 ride the cache: counts equal the carry-off arm's
    and parca_agent_tpu's, and the counters move alike."""
    snap, jsnap = _snaps(seed=seed)
    ref, car, jax = _trio(overflow="raise")
    for w in range(3):
        for _ in range(2):
            ref.feed(snap)
            car.feed(snap)
            jax.feed(jsnap)
        cr = ref.close_window(copy=True)
        cc = car.close_window(copy=True)
        cj = np.asarray(jax.close_window(copy=True))
        assert np.array_equal(cc, cr), w
        assert np.array_equal(cc, cj), w
        assert int(cc.sum()) == 2 * snap.total_samples()
    assert ref._key_to_id == car._key_to_id == jax._key_to_id
    assert _stats(car) == _stats(jax)
    s = car.stats
    assert s["carry_flushes"] == 3 and s.get("carry_fallbacks", 0) == 0
    assert s["carry_hits"] == s["carry_rows_in"] == 5 * 512
    assert s["carry_entries"] == 512


def test_capture_carried_hashes():
    """The hashes-given feed matches and folds like the self-hash feed."""
    snap, jsnap = _snaps(seed=5, rows=400)
    ref, car, jax = _trio(overflow="raise")
    hashes = ref.hash_rows(snap)
    jhashes = jax.hash_rows(jsnap)
    for h, jh in zip(hashes, jhashes):
        assert np.array_equal(h, np.asarray(jh))
    for _ in range(3):
        ref.feed(snap, hashes=hashes)
        car.feed(snap, hashes=hashes)
        jax.feed(jsnap, hashes=jhashes)
        cc = car.close_window(copy=True)
        assert np.array_equal(cc, ref.close_window(copy=True))
        assert np.array_equal(cc, np.asarray(jax.close_window(copy=True)))
    assert car.stats["carry_hits"] > 0
    assert _stats(car) == _stats(jax)


def test_discard_drops_the_open_mass_only():
    """discard_open_window forgets carried mass with the window but keeps
    the cache's entries."""
    snap, jsnap = _snaps(seed=7, rows=300, pids=4)
    want = DictAggregator(capacity=CAP, overflow="raise",
                          device="cpu").window_counts(snap)
    car = DictAggregator(capacity=CAP, overflow="raise", device="cpu",
                         carry=True)
    jax = JaxDict(capacity=CAP, overflow="raise", coalesce=True, carry=True)
    for agg, s in ((car, snap), (jax, jsnap)):
        assert np.array_equal(np.asarray(agg.window_counts(s)), want)
        agg.feed(s)  # fully carried: open mass accumulates on the host
        agg.discard_open_window()
        assert agg.stats["carry_discards"] == 1
        assert agg._carry_open_mass == 0
        assert len(agg._carry_h1) > 0
        assert np.array_equal(np.asarray(agg.window_counts(s)), want)
    assert _stats(car) == _stats(jax)


def test_exact_across_a_bounded_memory_rotation():
    """A rotation remaps the id space: the carry drops wholesale, and
    counts stay equal to the carry-off arm and parca_agent_tpu through
    it; sketch-absorbed keys are never admitted."""
    kw = [_spec(s, 200, 4) for s in (17, 18)]
    snaps = [_dup(generate(SyntheticSpec(**k))) for k in kw]
    jsnaps = [_dup(jax_generate(JaxSpec(**k))) for k in kw]
    ref = DictAggregator(capacity=1 << 9, rotate_min_age=1, device="cpu")
    car = DictAggregator(capacity=1 << 9, rotate_min_age=1, device="cpu",
                         carry=True)
    jax = JaxDict(capacity=1 << 9, rotate_min_age=1, coalesce=True,
                  carry=True)
    for k in (0, 1, 0, 1):
        cc = car.window_counts(snaps[k])
        assert np.array_equal(cc, ref.window_counts(snaps[k]))
        assert np.array_equal(cc, np.asarray(jax.window_counts(jsnaps[k])))
    assert car.stats.get("rotations", 0) >= 1
    assert car.stats["rotations"] == ref.stats["rotations"] \
        == jax.stats["rotations"]
    assert car.stats.get("sketch_samples", 0) == \
        jax.stats.get("sketch_samples", 0) > 0
    assert car._key_to_id == jax._key_to_id
    assert _stats(car) == _stats(jax)


@pytest.mark.parametrize("overflow", ["raise", "sketch"])
def test_invalidation_compaction_drops_the_carry(overflow):
    """invalidate_pid compacts the id space between windows: a carry that
    kept its entries would credit stale sids. Counts and ids equal the
    carry-off arm's and parca_agent_tpu's in the windows after."""
    snap, jsnap = _snaps(seed=21, rows=400, pids=6)
    victim = int(snap.pids[0])
    ref, car, jax = _trio(overflow=overflow)
    for w in range(3):
        for _ in range(2):
            ref.feed(snap)
            car.feed(snap)
            jax.feed(jsnap)
        cc = car.close_window(copy=True)
        assert np.array_equal(cc, ref.close_window(copy=True)), w
        assert np.array_equal(cc, np.asarray(jax.close_window(copy=True)))
        if w == 0:
            for agg in (ref, car, jax):
                assert agg.invalidate_pid(victim)
            assert len(car._carry_h1) == 0
    assert ref._key_to_id == car._key_to_id == jax._key_to_id
    assert _stats(car) == _stats(jax)


def test_a_window_carried_whole_closes_with_its_mass():
    """Every drain of window 2 is carried, so nothing reaches the device
    accumulator (its fed total stays 0): the close still flushes the
    carried mass."""
    snap, jsnap = _snaps(seed=9, rows=256, pids=4, dup=1)
    car = DictAggregator(capacity=CAP, overflow="raise", device="cpu",
                         carry=True)
    jax = JaxDict(capacity=CAP, overflow="raise", coalesce=True, carry=True)
    first = car.window_counts(snap)
    assert np.array_equal(first, np.asarray(jax.window_counts(jsnap)))
    for lo, hi in ((0, 100), (100, 256)):
        car.feed(snap, lo=lo, hi=hi)
        jax.feed(jsnap, lo=lo, hi=hi)
    assert car._fed_total == 0 and car._miss_inflight is None
    assert car._carry_open_mass == snap.total_samples()
    counts = car.close_window(copy=True)
    assert np.array_equal(counts, first)
    assert np.array_equal(counts, np.asarray(jax.close_window(copy=True)))
    assert car.stats["windows"] == jax.stats["windows"] == 2
    assert _stats(car) == _stats(jax)


def test_pprof_bytes_equal_across_the_arms():
    """The same pprof bytes with and without the carry, with the numpy
    self-hash and with capture-carried hashes, and from parca_agent_tpu's
    aggregator and encoder with the carry."""
    snap, jsnap = _snaps(seed=13, rows=384)
    arms = {"no-carry": dict(carry=False), "carry": dict(carry=True),
            "carry-hashes": dict(carry=True, given=True)}
    digests = {}
    for name, cfg in arms.items():
        agg = DictAggregator(capacity=CAP, overflow="raise", device="cpu",
                             carry=cfg["carry"])
        enc = WindowEncoder(agg)
        hashes = agg.hash_rows(snap) if cfg.get("given") else None
        digests[name] = []
        for w in range(3):
            agg.feed(snap, hashes=hashes)
            agg.feed(snap, hashes=hashes)
            digests[name].append(_digest(enc.encode(
                agg.close_window(copy=True), 1_000 + w, 10**10, 10**7)))
    jagg = JaxDict(capacity=CAP, overflow="raise", coalesce=True, carry=True)
    jenc = JaxEncoder(jagg)
    digests["jax-carry"] = []
    for w in range(3):
        jagg.feed(jsnap)
        jagg.feed(jsnap)
        digests["jax-carry"].append(_digest(jenc.encode(
            np.asarray(jagg.close_window(copy=True)), 1_000 + w, 10**10,
            10**7)))
    for name, d in digests.items():
        assert d == digests["no-carry"], name


def test_a_failed_match_falls_back_to_per_drain_dispatch():
    """A failure inside the match costs only the cross-drain fold: it is
    counted, the batch dispatches, matching stays off until the window
    boundary, the window closes exact and the next window carries again.
    The port's failure is a lookup that raises once; parca_agent_tpu's is
    its feed.carry fault site."""
    snap, jsnap = _snaps(seed=47, rows=512, pids=8)
    want = [DictAggregator(capacity=CAP, overflow="raise",
                           device="cpu").window_counts(snap)] * 3
    car = DictAggregator(capacity=CAP, overflow="raise", device="cpu",
                         carry=True)
    lookup = car._carry_lookup
    failed = []

    def lookup_once(h1c):
        if not failed:
            failed.append(len(h1c))
            raise RuntimeError("lookup failed")
        return lookup(h1c)

    car._carry_lookup = lookup_once
    got = [car.window_counts(snap) for _ in range(3)]
    faults.install(faults.FaultInjector.from_spec(
        "feed.carry:error:count=1", seed=42))
    jax = JaxDict(capacity=CAP, overflow="raise", coalesce=True, carry=True)
    jgot = [np.asarray(jax.window_counts(jsnap)) for _ in range(3)]
    assert failed and car.stats["carry_fallbacks"] == 1
    for g, jg, w in zip(got, jgot, want):
        assert np.array_equal(g, w)
        assert np.array_equal(g, jg)
        assert int(g.sum()) == snap.total_samples()
    # Re-armed at the boundary: window 3 carried whole.
    assert car.stats["carry_hits"] == 512
    assert _stats(car) == _stats(jax)


def test_footprint_counts_the_carry():
    """footprint_bytes carries the same lanes as parca_agent_tpu's."""
    snap, jsnap = _snaps(seed=2, rows=256, pids=4, dup=1)
    car = DictAggregator(capacity=CAP, overflow="raise", device="cpu",
                         carry=True)
    jax = JaxDict(capacity=CAP, overflow="raise", coalesce=True, carry=True)
    car.window_counts(snap)
    jax.window_counts(jsnap)
    got, want = car.footprint_bytes(), jax.footprint_bytes()
    assert set(got) == set(want)
    assert got["carry_bytes"] == want["carry_bytes"] > 0
    assert got["pid_registry_bytes"] == want["pid_registry_bytes"]
