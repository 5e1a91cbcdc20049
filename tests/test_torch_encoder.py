"""The port's WindowEncoder against parca_agent_tpu's, byte for byte.

Each package aggregates the same seeded windows with its own
DictAggregator (the port's on the CPU), and each package's encoder
serializes its own counts: every pid's profile bytes must be equal. The
scenarios are those of tests/test_window_encoder.py (single window,
incremental growth, rotation, gzip, period change, empty window, the
churn-tolerant template's patch / append / relocate / rebuild paths and
its multi-window fuzz, the content cache, cross-pid dedup, adopted
statics), the vec.py primitives at the varint edges, and the one place
the port departs on purpose: after invalidate_pid's compaction the
port's long-lived encoder must equal a FRESH parca_agent_tpu encoder and
the port's build_pprof (parca_agent_tpu's long-lived encoder keeps
stale mirrors there).
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture import formats as jax_formats
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof import vec as jax_vec
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture import formats
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof import vec
from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder

torch.set_num_threads(1)

# Structural stats that must move the same in both encoders.
_STATS = ("windows_encoded", "template_rows", "dead_rows",
          "statics_cache_hits", "statics_cache_misses",
          "statics_bytes_built", "statics_bytes_reused",
          "append_fast_groups", "append_slow_groups")


def _spec_kw(seed=7, n_pids=12, rows=400):
    return dict(n_pids=n_pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=rows * 4, mean_depth=10, kernel_fraction=0.25,
                seed=seed)


class Twin:
    """One aggregator and one encoder in each package, fed alike."""

    def __init__(self, capacity=1 << 12, compress=False, **agg_kw):
        self.jagg = JaxDict(capacity=capacity, **agg_kw)
        self.pagg = DictAggregator(capacity=capacity, device="cpu", **agg_kw)
        self.jenc = JaxEncoder(self.jagg, compress=compress)
        self.penc = WindowEncoder(self.pagg, compress=compress)
        self.compress = compress

    def snaps(self, **kw):
        return jax_generate(JaxSpec(**kw)), generate(SyntheticSpec(**kw))

    def window(self, snaps):
        jc = np.asarray(self.jagg.window_counts(snaps[0]))
        pc = np.asarray(self.pagg.window_counts(snaps[1]))
        np.testing.assert_array_equal(jc, pc)
        return pc

    def encode(self, counts, snap, period_ns=None, time_ns=None, **kw):
        args = (snap.time_ns if time_ns is None else time_ns,
                snap.window_ns,
                snap.period_ns if period_ns is None else period_ns)
        for enc in (self.jenc, self.penc):
            enc.timings.clear()
        jout = self.jenc.encode(counts.copy(), *args, **kw)
        pout = self.penc.encode(counts.copy(), *args, **kw)
        assert_same_blobs(jout, pout, self.compress)
        assert set(self.jenc.timings) == set(self.penc.timings)
        for k in _STATS:
            assert self.penc.stats[k] == self.jenc.stats[k], k
        return pout


def assert_same_blobs(jout, pout, compress=False, ordered=True):
    """Equal bytes for every pid; with `ordered`, in the same order too
    (an encoder appends a pid new to its template at the end, so only
    encoders with the same history list pids alike)."""
    if not ordered:
        jout, pout = sorted(jout), sorted(pout)
    assert [p for p, _ in pout] == [p for p, _ in jout]
    for (pid, jb), (_, pb) in zip(jout, pout):
        jb, pb = bytes(jb), bytes(pb)
        if compress:
            # gzip stamps the wall clock into its header.
            assert pb[:2] == jb[:2] == b"\x1f\x8b"
            jb, pb = gzip.decompress(jb), gzip.decompress(pb)
        assert pb == jb, f"pid {pid}"


def assert_matches_builder(agg, snap, counts, encoded):
    """parse_pprof of every blob describes the port's build_pprof
    profile (count-0 template rows aside)."""
    profiles = {p.pid: p for p in agg._build_profiles(snap, counts)}
    got = dict(encoded)
    assert set(got) == set(profiles)
    for pid, prof in profiles.items():
        want = parse_pprof(build_pprof(prof, compress=False))
        have = parse_pprof(bytes(got[pid]))
        assert {k: v for k, v in have.stacks_by_address().items()
                if v > 0} == want.stacks_by_address()
        assert have.mappings == want.mappings
        assert have.locations == want.locations
        assert have.period == want.period
        assert sorted(have.strings) == sorted(want.strings)


# -- vec primitives -----------------------------------------------------------

_EDGES = np.array([0, 1, 127, 128, 1 << 14, (1 << 14) - 1, 1 << 21,
                   2**32 - 1, 2**63 - 1], np.uint64)


def test_vec_primitives_equal_jax_at_the_varint_edges():
    rng = np.random.default_rng(0)
    vals = np.concatenate([_EDGES, rng.integers(0, 2**63, 300,
                                                dtype=np.uint64)])
    np.testing.assert_array_equal(vec.varint_len(vals),
                                  jax_vec.varint_len(vals))
    for a, b in zip(vec.encode_varint_stream(vals),
                    jax_vec.encode_varint_stream(vals)):
        np.testing.assert_array_equal(a, b)
    lens = vec.varint_len(vals)
    pos = np.zeros(len(vals), np.int64)
    np.cumsum(lens[:-1] + 3, out=pos[1:])
    size = int(pos[-1] + 13)
    outs = [np.zeros(size, np.uint8) for _ in range(4)]
    vec.put_varints(outs[0], pos, vals, lens)
    jax_vec.put_varints(outs[1], pos, vals, lens)
    vec.put_varints_padded(outs[2], np.arange(len(vals)) * 10, vals, 10)
    jax_vec.put_varints_padded(outs[3], np.arange(len(vals)) * 10, vals, 10)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[2][: len(vals) * 10],
                                  outs[3][: len(vals) * 10])
    small = _EDGES[_EDGES < 2**35]
    a = np.zeros(len(small) * 5, np.uint8)
    b = np.zeros(len(small) * 5, np.uint8)
    vec.put_varints_padded(a, np.arange(len(small)) * 5, small, 5)
    jax_vec.put_varints_padded(b, np.arange(len(small)) * 5, small, 5)
    np.testing.assert_array_equal(a, b)


def test_vec_rejects_bad_positions_and_widths():
    out = np.zeros(16, np.uint8)
    vals = np.array([1, 2], np.uint64)
    with pytest.raises(IndexError):
        vec.put_varints(out, np.array([0], np.int64), vals)
    with pytest.raises(IndexError):
        vec.put_varints(out, np.array([0, -1], np.int64), vals)
    with pytest.raises(ValueError):
        vec.put_varints_padded(out, np.array([0, 5], np.int64), vals, 11)


# -- the encoder scenarios ------------------------------------------------------


def test_single_window_batch_and_straggler_paths():
    t = Twin()
    snaps = t.snaps(**_spec_kw())
    c = t.window(snaps)
    t.jenc.build_statics(snaps[0].period_ns)
    t.penc.build_statics(snaps[1].period_ns)
    out = t.encode(c, snaps[1])
    assert len(out) > 1
    assert_matches_builder(t.pagg, snaps[1], c, out)
    # The per-pid statics path of a fresh encoder gives the same bytes.
    out2 = WindowEncoder(t.pagg).encode(c, snaps[1].time_ns,
                                        snaps[1].window_ns,
                                        snaps[1].period_ns)
    assert_same_blobs(out, out2)


def test_incremental_new_stacks_and_pids():
    t = Twin(capacity=1 << 13)
    s1 = t.snaps(**_spec_kw(seed=1))
    s2 = t.snaps(**_spec_kw(seed=2, n_pids=20, rows=600))
    c1 = t.window(s1)
    t.encode(c1, s1[1])
    c2 = t.window(s2)
    out2 = t.encode(c2, s2[1])
    assert_matches_builder(t.pagg, s2[1], c2, out2)
    t.encode(c1, s1[1])  # an older, shorter counts vector


def test_streaming_close_path():
    t = Twin()
    snaps = t.snaps(**_spec_kw(seed=3))
    for agg, snap in ((t.jagg, snaps[0]), (t.pagg, snaps[1])):
        h = agg.hash_rows(snap)
        agg.feed(snap, h, 0, len(snap) // 2)
        agg.feed(snap, h, len(snap) // 2, len(snap))
    jc = np.asarray(t.jagg.close_window())
    c = t.pagg.close_window()
    np.testing.assert_array_equal(jc, c)
    t.encode(c, snaps[1])


def test_rotation_in_bounded_memory():
    t = Twin(rotate_min_age=1)
    s1 = t.snaps(**_spec_kw(seed=4))
    s2 = t.snaps(**_spec_kw(seed=5))
    t.encode(t.window(s1), s1[1])
    t.window(s2)
    t.jagg._rotate_pending = t.pagg._rotate_pending = True
    c2 = t.window(s2)
    assert t.pagg.stats.get("rotations", 0) == 1
    assert t.pagg.registry_epoch == 1
    out = t.encode(c2, s2[1])
    assert_matches_builder(t.pagg, s2[1], c2, out)


def test_gzip():
    t = Twin(capacity=1 << 10, compress=True)
    snaps = t.snaps(**_spec_kw(seed=6, n_pids=3, rows=50))
    out = t.encode(t.window(snaps), snaps[1])
    assert out and all(parse_pprof(b).samples for _, b in out)


def test_period_change_reemits_statics():
    t = Twin(capacity=1 << 10)
    snaps = t.snaps(**_spec_kw(seed=9, n_pids=4, rows=80))
    c = t.window(snaps)
    t.encode(c, snaps[1])
    out = t.encode(c, snaps[1], period_ns=999_999)
    assert all(parse_pprof(b).period == 999_999 for _, b in out)
    t.encode(c, snaps[1], period_ns=999_999, time_ns=snaps[1].time_ns + 1)
    assert "encode_patch" in t.penc.timings


def test_empty_window_and_stale_counts():
    t = Twin(capacity=1 << 10)
    assert t.penc.encode(np.zeros(0, np.int64), 0, 0, 1) == []
    snaps = t.snaps(**_spec_kw(seed=8, n_pids=3, rows=50))
    c = t.window(snaps)
    with pytest.raises(ValueError):
        t.penc.encode(np.concatenate([c, [1]]), 0, 0, 1)


def _churn(seed=21, n_pids=10, rows=500):
    t = Twin(capacity=1 << 13)
    snaps = t.snaps(**_spec_kw(seed=seed, n_pids=n_pids, rows=rows))
    return t, snaps[1], t.window(snaps)


def test_count_churn_is_patched_in_place():
    t, snap, c_full = _churn()
    t.encode(c_full, snap)
    rng = np.random.default_rng(5)
    c2 = c_full.copy()
    c2[rng.random(len(c2)) < 0.2] = 0
    c2[c2 > 0] += 3
    out = t.encode(c2, snap)
    assert "encode_patch" in t.penc.timings
    assert "encode_build" not in t.penc.timings
    assert_matches_builder(t.pagg, snap, c2, out)


def test_new_stacks_append_into_slack():
    t, snap, c_full = _churn()
    pid_of = t.pagg._id_pid[: len(c_full)]
    c1 = c_full.copy()
    c1[np.random.default_rng(6).random(len(c1)) < 0.15] = 0
    c1[pid_of == int(pid_of[0])] = 0  # one whole pid hidden
    t.encode(c1, snap)
    out = t.encode(c_full, snap)
    assert "encode_build" not in t.penc.timings
    assert_matches_builder(t.pagg, snap, c_full, out)
    t.encode(c1, snap)


def test_slack_exhaustion_relocates_a_blob():
    t, snap, c_full = _churn(rows=800)
    pid_of = t.pagg._id_pid[: len(c_full)]
    big = int(np.bincount(pid_of.astype(np.int64)).argmax())
    c1 = c_full.copy()
    c1[np.flatnonzero(pid_of == big)[2:]] = 0
    t.encode(c1, snap)
    waste0 = t.penc._tmpl.waste
    t.encode(c_full, snap)
    assert "encode_build" not in t.penc.timings
    assert t.penc._tmpl.waste > waste0 == 0
    assert t.penc._tmpl.waste == t.jenc._tmpl.waste


def test_heavy_churn_rebuilds():
    t, snap, c_full = _churn()
    t.encode(c_full, snap)
    c2 = c_full.copy()
    c2[np.arange(len(c2)) % 3 != 0] = 0
    t.encode(c2, snap)
    assert "encode_build" in t.penc.timings


def test_churn_append_takes_the_vectorized_path():
    t, snap, c_full = _churn(seed=53, n_pids=12, rows=600)
    c1 = c_full.copy()
    c1[np.random.default_rng(8).random(len(c1)) < 0.3] = 0
    t.encode(c1, snap)
    t.encode(c_full, snap)
    assert t.penc.stats["append_fast_groups"] > 0


@pytest.mark.parametrize("seed", [31, 32, 33, 34, 35])
def test_churn_fuzz_multi_window(seed):
    rng = np.random.default_rng(seed)
    t = Twin(capacity=1 << 13)
    sa = t.snaps(**_spec_kw(seed=seed, n_pids=8, rows=300))
    sb = t.snaps(**_spec_kw(seed=seed + 100, n_pids=14, rows=500))
    snap, c_full = sa[1], t.window(sa)
    paths = set()
    for w in range(10):
        if w == 5:
            snap, c_full = sb[1], t.window(sb)
        c = c_full.copy()
        c[rng.random(len(c)) < 1 - rng.uniform(0.2, 1.0)] = 0
        if rng.random() < 0.5:
            c[c > 0] += rng.integers(1, 5)
        pid_of = t.pagg._id_pid[: len(c)]
        if rng.random() < 0.4 and len(np.unique(pid_of)) > 2:
            c[pid_of == int(rng.choice(pid_of))] = 0
        out = t.encode(c, snap)
        if not int((c > 0).sum()):
            assert out == []
            continue
        paths.add("build" if "encode_build" in t.penc.timings else "patch")
    assert "patch" in paths


def test_rotation_rebuild_served_from_the_content_cache():
    t = Twin(capacity=1 << 13, rotate_min_age=1)
    s1 = t.snaps(**_spec_kw(seed=51))
    s2 = t.snaps(**_spec_kw(seed=52))
    t.encode(t.window(s1), s1[1])
    t.encode(t.window(s2), s2[1])
    t.jagg._rotate_pending = t.pagg._rotate_pending = True
    c2 = t.window(s2)
    built = t.penc.stats["statics_bytes_built"]
    out = t.encode(c2, s2[1])
    assert t.penc.stats["statics_cache_hits"] > 0
    assert t.penc.stats["statics_bytes_built"] == built
    assert_same_blobs(out, WindowEncoder(t.pagg).encode(
        c2, s2[1].time_ns, s2[1].window_ns, s2[1].period_ns))


def _dedup_snapshot(fmt):
    table = fmt.MappingTable(
        pids=[1, 2], starts=[0x1000, 0x1000], ends=[0x9000, 0x9000],
        offsets=[0, 0], objs=[0, 0], obj_paths=("/bin/app",),
        obj_buildids=("ab" * 20,))
    stacks = np.zeros((4, fmt.STACK_SLOTS), np.uint64)
    for i in range(4):
        stacks[i, :2] = [0x1000 + 0x10 * (i % 2 + 1),
                         0x1000 + 0x100 * (i % 2 + 1)]
    return fmt.WindowSnapshot(
        pids=[1, 1, 2, 2], tids=[1, 1, 2, 2], counts=[3, 4, 3, 4],
        user_len=[2] * 4, kernel_len=[0] * 4, stacks=stacks, mappings=table)


def test_cross_pid_dedup_shares_statics():
    t = Twin(capacity=1 << 10)
    snaps = (_dedup_snapshot(jax_formats), _dedup_snapshot(formats))
    c = t.window(snaps)
    t.penc.build_statics(snaps[1].period_ns)
    st1, st2 = t.penc._static[1], t.penc._static[2]
    assert st1.head is st2.head and st1.tail is st2.tail
    assert st1.loc_bytes is st2.loc_bytes
    t.jenc.build_statics(snaps[0].period_ns)
    t.encode(c, snaps[1])


def test_adopted_statics_build_nothing():
    """Registries carried into a fresh dictionary (load_state of a state
    with no stacks but the registries), statics adopted from the first
    encoder: nothing is built, and the bytes equal the first encoder's
    and parca_agent_tpu's (adopt_registry + adopt_statics there)."""
    kw = _spec_kw(seed=54, n_pids=6, rows=150)
    t = Twin()
    snaps = t.snaps(**kw)
    c1 = t.window(snaps)
    t.encode(c1, snaps[1])

    state = DictAggregator(capacity=1 << 12, device="cpu").export_state()
    state["registries"] = t.pagg.export_state()["registries"]
    agg2 = DictAggregator(capacity=1 << 12, device="cpu")
    agg2.load_state(state)
    enc2 = WindowEncoder(agg2)
    jagg2 = JaxDict(capacity=1 << 12)
    jenc2 = JaxEncoder(jagg2)
    for pid, reg in t.jagg._pids.items():
        assert jagg2.adopt_registry(
            pid, list(reg.mappings), list(reg.loc_address),
            list(reg.loc_normalized), list(reg.loc_mapping_id),
            list(reg.loc_is_kernel))
    for pid, st in t.penc._static.items():
        args = (pid, st.head, st.tail, bytes(st.loc_bytes), st.n_mappings,
                st.n_locs, st.period_ns)
        enc2.adopt_statics(*args)
        jenc2.adopt_statics(*args)
    assert enc2.statics_backlog(snaps[1].period_ns) == 0
    c2 = agg2.window_counts(snaps[1])
    np.testing.assert_array_equal(c2, c1)
    args = (snaps[1].time_ns, snaps[1].window_ns, snaps[1].period_ns)
    out = enc2.encode(c2, *args)
    assert enc2.stats["statics_bytes_built"] == 0
    assert_same_blobs(out, t.penc.encode(c1, *args))
    jc2 = np.asarray(jagg2.window_counts(snaps[0]))
    assert_same_blobs(jenc2.encode(jc2, *args), out)


# -- the invalidation compaction (parca_agent_tpu's stale mirrors) ------------


def _without_pid(snap, pid):
    keep = np.flatnonzero(snap.pids != pid)
    return dataclasses.replace(
        snap, pids=snap.pids[keep], tids=snap.tids[keep],
        counts=snap.counts[keep], user_len=snap.user_len[keep],
        kernel_len=snap.kernel_len[keep], stacks=snap.stacks[keep])


@pytest.mark.parametrize("overflow", ["sketch", "raise"])
def test_invalidation_compaction_keeps_the_encoder_exact(overflow):
    """_spec(seed=4), capacity 2^12: after invalidate_pid(1000) the ids
    remap (400 -> 367) without a rotation. The port's long-lived encoder
    equals a fresh parca_agent_tpu encoder and its own build_pprof, and
    stays so for a window after (the pid's stacks back, new ids)."""
    t = Twin(overflow=overflow)
    snaps = t.snaps(**_spec_kw(seed=4))
    t.encode(t.window(snaps), snaps[1])
    for agg in (t.jagg, t.pagg):
        assert agg.invalidate_pid(1000)
    assert t.pagg._next_id == t.jagg._next_id < 400
    assert t.pagg.registry_epoch == 1 and not t.pagg.stats.get("rotations")
    for w, pair in enumerate([tuple(_without_pid(s, 1000) for s in snaps),
                              snaps]):
        jc = np.asarray(t.jagg.window_counts(pair[0]))
        c = t.pagg.window_counts(pair[1])
        np.testing.assert_array_equal(jc, c)
        args = (pair[1].time_ns + w, pair[1].window_ns, pair[1].period_ns)
        out = t.penc.encode(c, *args)
        assert_same_blobs(JaxEncoder(t.jagg).encode(jc, *args), out,
                          ordered=False)
        assert_matches_builder(t.pagg, pair[1], c, out)


def test_invalidation_keeps_the_surviving_pids_statics():
    """An invalidation's compaction edits no surviving registry, so the
    long-lived encoder keeps those pids' statics (the same objects, no
    byte built or looked up) and drops only the invalidated pid's; with
    the pid back, only its statics are made again (served from the
    content cache, its new registry holding the old content)."""
    t = Twin()
    snaps = t.snaps(**_spec_kw(seed=4))
    t.encode(t.window(snaps), snaps[1])
    kept = {p: st for p, st in t.penc._static.items() if p != 1000}
    assert 1000 in t.penc._static and kept
    for agg in (t.jagg, t.pagg):
        assert agg.invalidate_pid(1000)
    before = {k: t.penc.stats[k] for k in (
        "statics_bytes_built", "statics_bytes_reused", "statics_cache_hits",
        "statics_cache_misses")}
    for w, pair in enumerate([tuple(_without_pid(s, 1000) for s in snaps),
                              snaps]):
        jc = np.asarray(t.jagg.window_counts(pair[0]))
        c = t.pagg.window_counts(pair[1])
        args = (pair[1].time_ns + w, pair[1].window_ns, pair[1].period_ns)
        out = t.penc.encode(c, *args)
        assert_same_blobs(JaxEncoder(t.jagg).encode(jc, *args), out,
                          ordered=False)
        assert_matches_builder(t.pagg, pair[1], c, out)
        assert all(t.penc._static[p] is st for p, st in kept.items())
        if w == 0:
            assert 1000 not in t.penc._static
            assert {k: t.penc.stats[k] for k in before} == before
    st = t.penc._static[1000]
    assert st.reg is t.pagg._pids[1000]
    made = sum(t.penc.stats[k] - before[k]
               for k in ("statics_bytes_built", "statics_bytes_reused"))
    assert made == len(st.head) + len(st.tail) + len(st.loc_bytes)


def test_recycled_pid_registered_again_before_the_encoder_syncs():
    """invalidate_pid, then a window that brings the pid back, before any
    encode: the encoder meets the pid's fresh registry at its first sync
    after the compaction and must not keep the old pid's statics."""
    t = Twin()
    snaps = t.snaps(**_spec_kw(seed=4))
    t.encode(t.window(snaps), snaps[1])
    old = t.penc._static[1000]
    for agg in (t.jagg, t.pagg):
        assert agg.invalidate_pid(1000)
    jc = np.asarray(t.jagg.window_counts(snaps[0]))
    c = t.pagg.window_counts(snaps[1])
    args = (snaps[1].time_ns + 1, snaps[1].window_ns, snaps[1].period_ns)
    out = t.penc.encode(c, *args)
    assert t.penc._static[1000] is not old
    assert t.penc._static[1000].reg is t.pagg._pids[1000]
    assert_same_blobs(JaxEncoder(t.jagg).encode(jc, *args), out,
                      ordered=False)
    assert_matches_builder(t.pagg, snaps[1], c, out)


def test_rotation_and_invalidation_between_two_encodes():
    """A rotation and an invalidation before the same sync: the rotation
    rule holds (every static dropped, rebuilt from the content cache) and
    the bytes equal a fresh parca_agent_tpu encoder's."""
    t = Twin(capacity=1 << 13, rotate_min_age=1)
    s1 = t.snaps(**_spec_kw(seed=51))
    s2 = t.snaps(**_spec_kw(seed=52))
    t.encode(t.window(s1), s1[1])
    t.encode(t.window(s2), s2[1])
    pid = int(np.unique(s2[1].pids)[3])
    for agg in (t.jagg, t.pagg):
        assert agg.invalidate_pid(pid)
        agg._rotate_pending = True
    jc = np.asarray(t.jagg.window_counts(s2[0]))
    c = t.pagg.window_counts(s2[1])
    np.testing.assert_array_equal(jc, c)
    assert t.pagg.stats["rotations"] == 1
    hits = t.penc.stats["statics_cache_hits"]
    args = (s2[1].time_ns + 1, s2[1].window_ns, s2[1].period_ns)
    out = t.penc.encode(c, *args)
    assert t.penc.stats["statics_cache_hits"] > hits
    assert_same_blobs(JaxEncoder(t.jagg).encode(jc, *args), out,
                      ordered=False)
    assert_matches_builder(t.pagg, s2[1], c, out)
