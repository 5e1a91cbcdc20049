"""The port's DictAggregator on the CPU against parca_agent_tpu's.

Both aggregators see the same synthetic windows (numpy, from a seed) and
must agree exactly: counts by stack id, id assignment (the key -> id map
and the table mirror), and the sha256 of every pid's uncompressed pprof.
The JAX side runs on the CPU backend with its lax probe, as its own tests
run it. Also: the dictionary's state carried from a warmed JAX aggregator
into the port, and the port's own export/load round trip.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof.builder import build_pprof as jax_build_pprof
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import build_pprof

torch.set_num_threads(1)

CAP = 1 << 12


def _pair():
    return (JaxDict(capacity=CAP, overflow="raise"),
            DictAggregator(capacity=CAP, overflow="raise", device="cpu"))


def _rows(snap, idx, scale=None):
    """Snapshot restricted to rows `idx` (counts optionally rescaled)."""
    counts = snap.counts[idx]
    if scale is not None:
        counts = np.maximum(1, counts * scale[: len(idx)]).astype(np.int64)
    return dataclasses.replace(
        snap, pids=snap.pids[idx], tids=snap.tids[idx], counts=counts,
        user_len=snap.user_len[idx], kernel_len=snap.kernel_len[idx],
        stacks=snap.stacks[idx])


def _windows(seed: int, n_windows: int = 3):
    """A growing population: window w holds a random subset of the first
    300 + 150 w stacks of one generated pool, so every window brings new
    stacks and re-sees old ones."""
    pool = generate(SyntheticSpec(n_pids=24, n_unique_stacks=800,
                                  total_samples=20_000, seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_windows):
        n = 300 + 150 * w
        idx = np.sort(rng.choice(n, int(0.8 * n), replace=False))
        out.append(_rows(pool, idx, rng.integers(1, 4, len(idx))))
    return out


def _pprof_digests(profiles, build) -> dict:
    return {p.pid: hashlib.sha256(build(p, compress=False)).hexdigest()
            for p in profiles}


def _assert_same_dictionary(jd, pd_):
    assert pd_._next_id == jd._next_id
    assert pd_._key_to_id == jd._key_to_id
    assert np.array_equal(pd_._ids, jd._ids)
    assert np.array_equal(pd_._h1, jd._h1)
    assert pd_._unreachable == jd._unreachable


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_one_shot_window_matches_jax(seed):
    snap = generate(SyntheticSpec(n_pids=20, n_unique_stacks=600,
                                  total_samples=8000, seed=seed))
    jd, pd_ = _pair()
    jp = jd.aggregate(snap)
    pp = pd_.aggregate(snap)
    _assert_same_dictionary(jd, pd_)
    assert _pprof_digests(pp, build_pprof) == _pprof_digests(jp,
                                                             jax_build_pprof)
    # The same population again: pure lookups, the same counts.
    assert np.array_equal(pd_.window_counts(snap), jd.window_counts(snap))
    assert pd_.stats["inserts"] == jd.stats["inserts"] == len(snap)


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("drains", [1, 4])
def test_streaming_windows_match_jax(seed, drains):
    jd, pd_ = _pair()
    for snap in _windows(seed):
        hashes = pd_.hash_rows(snap)
        bounds = np.linspace(0, len(snap), drains + 1).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            jd.feed(snap, hashes, lo=lo, hi=hi)
            pd_.feed(snap, hashes, lo=lo, hi=hi)
        cj = jd.close_window()
        cp = pd_.close_window()
        assert np.array_equal(cp, cj)
        assert int(cp.sum()) == snap.total_samples()
        _assert_same_dictionary(jd, pd_)
        pp = pd_._build_profiles(snap, cp)
        assert _pprof_digests(pp, build_pprof) == _pprof_digests(
            jd._build_profiles(snap, cj), jax_build_pprof)
        want = {p.pid: p.total() for p in CPUAggregator().aggregate(snap)}
        assert {p.pid: p.total() for p in pp} == want


def test_probe_bound_chains_settle_on_host_like_jax():
    """Capture-carried hashes whose h1 repeats push keys past the probe
    bound: both sides must absorb them host-side identically."""
    jd, pd_ = _pair()
    for snap in _windows(31):
        h1, h2, h3 = pd_.hash_rows(snap)
        h1 = h1.copy()
        h1[::5] = np.uint32(0xABCDE)  # one home slot for 1/5 of the rows
        for d in (jd, pd_):
            d.feed(snap, (h1, h2, h3), hi=len(snap) // 2)
            d.feed(snap, (h1, h2, h3), lo=len(snap) // 2)
        assert np.array_equal(pd_.close_window(), jd.close_window())
        _assert_same_dictionary(jd, pd_)
    assert pd_.stats["unreachable_rows"] == jd.stats["unreachable_rows"] > 0
    assert pd_.stats["overflow_misses"] == jd.stats["overflow_misses"]


def test_capacity_exhaustion_raises_like_jax():
    snap = generate(SyntheticSpec(n_pids=4, n_unique_stacks=200,
                                  total_samples=1000, seed=3))
    with pytest.raises(RuntimeError, match="capacity exhausted"):
        JaxDict(capacity=1 << 7, overflow="raise").window_counts(snap)
    d = DictAggregator(capacity=1 << 7, overflow="raise", device="cpu")
    with pytest.raises(RuntimeError, match="capacity exhausted"):
        d.window_counts(snap)
    assert d._next_id == 0 and not d._key_to_id  # nothing half-inserted


def test_synthetic_windows_identical_across_packages():
    """The windows these tests feed both sides are the same bits."""
    a = generate(SyntheticSpec(n_pids=24, n_unique_stacks=800,
                               total_samples=20_000, seed=21))
    b = jax_generate(JaxSpec(n_pids=24, n_unique_stacks=800,
                             total_samples=20_000, seed=21))
    assert np.array_equal(a.stacks, b.stacks)
    assert np.array_equal(a.counts, b.counts)


# -- the state carried across ------------------------------------------------


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
    }


@pytest.mark.parametrize("seed", [41, 42])
def test_state_from_jax_then_next_window_identical(seed):
    w0, w1, w2 = _windows(seed)
    jd = JaxDict(capacity=CAP, overflow="raise")
    jd.window_counts(w0)
    jd.window_counts(w1)
    pd_ = DictAggregator(capacity=CAP, overflow="raise", device="cpu")
    pd_.load_state(_jax_state(jd))
    _assert_same_dictionary(jd, pd_)
    hashes = pd_.hash_rows(w2)
    for d in (jd, pd_):
        d.feed(w2, hashes, hi=len(w2) // 3)
        d.feed(w2, hashes, lo=len(w2) // 3)
    cj, cp = jd.close_window(), pd_.close_window()
    assert np.array_equal(cp, cj)
    _assert_same_dictionary(jd, pd_)
    assert _pprof_digests(pd_._build_profiles(w2, cp), build_pprof) == \
        _pprof_digests(jd._build_profiles(w2, cj), jax_build_pprof)


def test_export_load_round_trip():
    w0, w1, w2 = _windows(51)
    a = DictAggregator(capacity=CAP, overflow="raise", device="cpu")
    a.window_counts(w0)
    a.window_counts(w1)
    b = DictAggregator(capacity=CAP, overflow="raise", device="cpu")
    b.load_state(a.export_state())
    pa, pb = a.aggregate(w2), b.aggregate(w2)
    assert a._key_to_id == b._key_to_id
    assert _pprof_digests(pa, build_pprof) == _pprof_digests(pb, build_pprof)
    with pytest.raises(ValueError):
        DictAggregator(capacity=CAP * 2, overflow="raise",
                       device="cpu").load_state(
            a.export_state())
