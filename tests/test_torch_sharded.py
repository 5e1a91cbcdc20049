"""The port's sharded stack dictionary against parca_agent_tpu's, bit for
bit.

parca_agent_tpu's ShardedDictAggregator runs over a mesh of n of the 8
virtual CPU devices (tests/conftest.py), the port's on the CPU with
n_shards sub-tables on its one device (the plain versions of the B7
programs). The same seeded inputs go through both at capacities 2^9 to
2^13, and every comparison is exact: route_h2, the counts, ids in
per-shard miss order, the host mirror, the close buffers at every width,
the feed (on the unpartitioned buffer, against JAX's program on JAX's
partition and against a loop over the rows) and the close, sub-table
overflow under "raise" and "sketch" (the sketch state after it), the pid
router, rotation and pid invalidation, the streaming feeder with the
carry cache, the window encoder's bytes, a slice of the differential
fuzz, and the CLI.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator import sharded as jax_sharded
from parca_agent_tpu.aggregator.sharded import ShardedDictAggregator as JaxSh
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.parallel.mesh import fleet_mesh
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu.profiler.streaming import \
    StreamingWindowFeeder as JaxFeeder
from parca_agent_tpu_torch.aggregator import close, sharded
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.aggregator.probe import PROBES
from parca_agent_tpu_torch.aggregator.sharded import (
    ShardedDictAggregator,
    route_h2,
    sharded_feed_step,
    sharded_feed_step_plain,
)
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.pprof.builder import parse_pprof
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.profiler.streaming import StreamingWindowFeeder

# One intra-op thread a process: the suite runs in several worker
# processes at once, and torch's default of a thread a core in each
# oversubscribes the host, so that timing-bound tests in other workers
# (an encode pipeline busy at a window's close) take another path.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHARDS = [1, 2, 8]


def _kw(seed=1, n_pids=16, rows=600, samples=None, **extra):
    return dict(n_pids=n_pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=samples or rows * 5, mean_depth=12,
                kernel_fraction=0.2, seed=seed, **extra)


def _snaps(**kw):
    return jax_generate(JaxSpec(**kw)), generate(SyntheticSpec(**kw))


def _pair(capacity, n, **kw):
    return (JaxSh(capacity=capacity, mesh=fleet_mesh(n), **kw),
            ShardedDictAggregator(capacity=capacity, n_shards=n,
                                  device="cpu", **kw))


def _assert_same(jd, pd_):
    """Ids, the host mirror, the eviction clock, the unreachable keys,
    the sketch and its stats."""
    assert pd_._next_id == jd._next_id
    assert pd_._key_to_id == jd._key_to_id
    for name in ("_ids", "_h1", "_h2", "_h3", "_occ", "_last_seen"):
        assert np.array_equal(getattr(pd_, name), getattr(jd, name)), name
    n = jd._next_id
    for name in ("_id_pid", "_id_h1", "_id_h2"):
        assert np.array_equal(getattr(pd_, name)[:n],
                              getattr(jd, name)[:n]), name
    assert pd_._unreachable == jd._unreachable
    for name in ("_cm", "_over_hll"):
        a, b = getattr(pd_, name), getattr(jd, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a, np.asarray(b)), name
    assert pd_.sketch_info() == jd.sketch_info()
    for k in ("inserts", "overflow_misses", "windows", "rotations",
              "pid_invalidations", "invalidation_compactions",
              "sketch_rows", "sketch_samples", "miss_vec_inserts",
              "full_closes", "close_retries", "unreachable_rows"):
        assert pd_.stats.get(k) == jd.stats.get(k), k


def _window(jd, pd_, snaps, step=None):
    """One window through both: window_counts, or feeds of `step` rows
    then close_window. Returns the port's counts (equal to JAX's)."""
    js, ps = snaps
    if step is None:
        jc, pc = jd.window_counts(js), pd_.window_counts(ps)
    else:
        jh, ph = jd.hash_rows(js), pd_.hash_rows(ps)
        for lo in range(0, len(ps), step):
            hi = min(lo + step, len(ps))
            jd.feed(js, jh, lo, hi)
            pd_.feed(ps, ph, lo, hi)
        jc, pc = jd.close_window(), pd_.close_window()
    assert np.array_equal(np.asarray(jc), pc)
    return pc


# -- route_h2 and the feed ----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_route_h2_equals_jax(n):
    rng = np.random.default_rng(n)
    h2 = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    # The top partial block: h2 // n * n + residue would pass 2^32 - 1.
    h2[:20] = 0xFFFFFFFF - np.arange(20, dtype=np.uint32)
    pids = rng.integers(1, 40, 500)

    def router(pid):
        return (pid * 7 + 3) % 11

    got = route_h2(h2, pids, router, n)
    want = jax_sharded.route_h2(h2, pids, router, n)
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.int64) % n,
                          np.array([router(int(p)) % n for p in pids]))
    # The rest of the hash is kept; only the top partial block steps down.
    step = h2.astype(np.int64) // n - got.astype(np.int64) // n
    assert set(np.unique(step).tolist()) <= {0, 1}
    assert not step[20:].any()


def _subtables(n_shards: int, cap_s: int, keys: np.ndarray) -> np.ndarray:
    """uint32 [n_shards, cap_s, 4]: `keys` (uint32 [k, 3]) placed one by
    one, id k + 1 in the id word, each at the first free slot from h1 in
    its home sub-table h2 % n_shards (wrapping inside it); keys past a
    full sub-table are left out."""
    table = np.zeros((n_shards, cap_s, 4), np.uint32)
    for sid, (a, b, c) in enumerate(keys.tolist()):
        sub = table[b % n_shards]
        for k in range(cap_s):
            idx = (a + k) & (cap_s - 1)
            if not sub[idx, 3]:
                sub[idx] = (a, b, c, sid + 1)
                break
    return table


def _feed_loop(table, acc, packed):
    """The B7 feed a row at a time in numpy: each live row probed in its
    home sub-table, a hit added to acc[shard, id] (ids past id_cap
    dropped), a miss appended to its shard's list. Returns the lists."""
    n_shards, cap_s = table.shape[:2]
    lists = [[] for _ in range(n_shards)]
    for r in range(packed.shape[1]):
        q1, q2, q3, c = (int(x) for x in packed[:, r])
        if c == 0 or c >= 2**31:
            continue
        s, found = q2 % n_shards, -1
        for k in range(PROBES):
            e = table[s, (q1 + k) & (cap_s - 1)]
            if not e[3]:
                break
            if (int(e[0]), int(e[1]), int(e[2])) == (q1, q2, q3):
                found = int(e[3]) - 1
                break
        if found < 0:
            lists[s].append(r)
        elif found < acc.shape[1]:
            acc[s, found] += c
    return lists


@pytest.mark.parametrize("case", ["s1", "s3", "s8", "empty_shard",
                                  "one_shard", "dead_lanes", "past_bound"])
def test_feed_compaction_equals_the_shard_loop(case):
    """The plain B7 feed on the unpartitioned [4, n_pad] buffer against a
    numpy loop over the rows: the accumulator, each shard's miss count
    and its miss rows in packed order; the wrapper runs the plain version
    on CPU tensors and launches nothing."""
    n_shards = {"s1": 1, "s3": 3, "s8": 8, "empty_shard": 4,
                "one_shard": 8, "dead_lanes": 3, "past_bound": 2}[case]
    cap_s = 1 << 7
    rng = np.random.default_rng(len(case) * 7 + n_shards)
    keys = rng.integers(0, 2**32, (int(0.6 * n_shards * cap_s), 3),
                        dtype=np.uint64).astype(np.uint32)
    if case == "past_bound":
        # One home a shard, 24 keys deep (key i in shard i % 2 at step
        # i // 2): keys 32 and on lie past the probe bound and miss.
        keys[:48, 0] = keys[0, 0]
        keys[:48, 1] = (keys[:48, 1] // 2) * 2 + np.arange(48) % 2
    table = _subtables(n_shards, cap_s, keys)
    nq = 3 * cap_s
    known = keys[rng.integers(0, len(keys), nq // 2)]
    unknown = rng.integers(0, 2**32, (nq - len(known), 3),
                           dtype=np.uint64).astype(np.uint32)
    q = np.concatenate([known, unknown])[rng.permutation(nq)]
    if case == "past_bound":
        q[:48] = keys[:48]
    if case == "empty_shard":
        q[q[:, 1] % 4 == 2, 1] += 1
    if case == "one_shard":
        q[:, 1] = (q[:, 1] // 8) * 8 + 5
    packed = np.zeros((4, 1 << (nq - 1).bit_length()), np.uint32)
    packed[:3, :nq] = q.T
    packed[3, :nq] = rng.integers(1, 9, nq)
    if case == "dead_lanes":
        packed[3, rng.choice(nq, nq // 5, replace=False)] = 0
    id_cap = len(keys) // 2  # ids past it are dropped
    acc0 = rng.integers(0, 50, (n_shards, id_cap)).astype(np.int32)
    want_acc = acc0.astype(np.int64)
    want = _feed_loop(table, want_acc, packed)
    dtab, dpacked = (torch.from_numpy(a.view(np.int32)) for a in (table,
                                                                   packed))
    for fn in (sharded_feed_step_plain, sharded_feed_step):
        acc = torch.from_numpy(acc0.copy())
        n_miss, rows = fn(dtab, acc, dpacked, False)
        assert np.array_equal(acc.numpy(), want_acc)
        assert n_miss.tolist() == [len(w) for w in want]
        for s, w in enumerate(want):
            assert rows[s, :len(w)].tolist() == w, s
    assert sharded.LAUNCHES["sharded_feed"] == 0
    per = [len(w) for w in want]
    assert sum(per) > 0 and (acc.numpy() != acc0).any()
    if case == "empty_shard":
        assert per[2] == 0 and min(per[:2] + per[3:]) > 0
    if case == "one_shard":
        assert per[5] == sum(per)
    if case == "past_bound":
        assert [r for r in range(48) if r in want[r % 2]] \
            == list(range(32, 48))


# -- the dictionary at n_shards in {1, 2, 8} ---------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_window_counts_ids_and_mirrors_equal_jax(n):
    jd, pd_ = _pair(1 << 13, n)
    _window(jd, pd_, _snaps(**_kw(seed=1)))
    _assert_same(jd, pd_)
    # Streamed: new stacks in a second window, then a steady third.
    snaps = _snaps(**_kw(seed=5, rows=800, n_pids=24))
    _window(jd, pd_, snaps, step=128)
    _assert_same(jd, pd_)
    inserts = pd_.stats["inserts"]
    counts = _window(jd, pd_, snaps, step=256)
    assert pd_.stats["inserts"] == inserts
    assert int(counts.sum()) == snaps[1].total_samples()
    # Profiles equal the numpy oracle's.
    got = {p.pid: p for p in pd_._build_profiles(snaps[1], counts)}
    for op in CPUAggregator().aggregate(snaps[1]):
        assert got[op.pid].total() == op.total()
        assert np.array_equal(np.sort(got[op.pid].values),
                              np.sort(op.values))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("width", [4, 8, 16])
def test_close_buffers_equal_jax(n, width):
    """The plain B7 close against parca_agent_tpu's _sharded_close_program
    on the same per-shard accumulators: sideband overrun, tail mass, and
    an id whose shard sum wraps int32."""
    id_cap, n_fetch, n_over_buf = 2048, 1024, 32
    rng = np.random.default_rng(width * 10 + n)
    acc = np.where(rng.random((n, id_cap)) < 0.3,
                   rng.integers(1, 9, (n, id_cap)), 0).astype(np.int32)
    big = rng.choice(n_fetch, 60, replace=False)
    acc[rng.integers(0, n, 60), big] = rng.integers((1 << width) - 1, 1 << 20,
                                                    60)
    acc[0, 7] = 2**31 - 1
    if n > 1:
        acc[n - 1, 7] = 5  # the shard sum wraps int32
    acc[:, n_fetch + 3] = 2  # mass past the fetched prefix
    want = np.asarray(jax_sharded._sharded_close_program(
        fleet_mesh(n), n, id_cap, n_fetch, width, n_over_buf)(
            jnp.asarray(acc)))[0]
    got = close.close_pack_sharded(torch.from_numpy(acc), n_fetch, width,
                                   n_over_buf).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert int(got[-2]) > n_over_buf and int(got[-1]) != 0
    assert close.LAUNCHES["close_pack_sharded"] == 0  # plain on the CPU


def _feed_case(n: int, seed: int):
    """A sharded table filled to ~0.7 of each sub-table through the
    aggregator's own placement (chains past the probe bound, wrapping in
    the sub-table) and a packed buffer of queries: known keys, h1-only
    collisions, unknown keys and dead lanes."""
    cap = 1 << 9
    agg = ShardedDictAggregator(capacity=cap, n_shards=n, device="cpu")
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (int(0.7 * cap), 3),
                        dtype=np.uint64).astype(np.uint32)
    keys[1:24, 0] = keys[0, 0]  # one long chain from one home
    keys[1:24, 1] = keys[0, 1] + n * np.arange(1, 24, dtype=np.uint32)
    sid = 0
    for k in map(tuple, keys.tolist()):
        slot = agg._try_insert_slot(k)
        if slot is None:
            continue
        agg._occ[slot] = True
        agg._h1[slot], agg._h2[slot], agg._h3[slot] = k
        agg._ids[slot] = sid
        sid += 1
    agg._ensure_device()
    nq = 300
    known = keys[rng.integers(0, len(keys), nq // 2)]
    h1_only = keys[rng.integers(0, len(keys), nq // 4)].copy()
    h1_only[:, 2] ^= 1
    unknown = rng.integers(0, 2**32, (nq - len(known) - len(h1_only), 3),
                           dtype=np.uint64).astype(np.uint32)
    q = np.concatenate([known, h1_only, unknown])
    q = q[rng.permutation(len(q))]
    packed = np.zeros((4, 512), np.uint32)
    packed[:3, :nq] = q.T
    packed[3, :nq] = rng.integers(0, 6, nq)  # count 0: dead lanes
    return agg, packed


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("reset", [0, 1])
def test_feed_program_equals_jax(n, reset):
    """The plain B7 feed on the unpartitioned packed buffer against
    parca_agent_tpu's _sharded_feed_program on the JAX package's own
    partition of the same buffer, same table and accumulator: the
    accumulator, the per-shard miss counts and each shard's ordered miss
    rows (the prefix of n_miss entries)."""
    agg, packed = _feed_case(n, seed=n + 10 * reset)
    table = agg._dev
    id_cap = agg._id_cap
    acc0 = np.random.default_rng(3).integers(0, 50, (n, id_cap)).astype(
        np.int32)
    part = JaxSh._partition_packed(
        SimpleNamespace(_n_shards=n, _part_bufs={}), packed)
    prog = jax_sharded._sharded_feed_program(
        fleet_mesh(n), n, agg._cap_s, id_cap, part.shape[2])
    jacc, jn, jrows = prog(jnp.asarray(table.numpy().view(np.uint32)),
                           jnp.asarray(acc0), jnp.asarray(part),
                           np.uint32(reset))
    jn, jrows = np.asarray(jn), np.asarray(jrows)
    acc = torch.from_numpy(acc0.copy())
    dpacked = torch.from_numpy(packed.view(np.int32))
    n_miss, rows = sharded_feed_step_plain(table, acc, dpacked, bool(reset))
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    assert np.array_equal(n_miss.numpy(), jn)
    for s in range(n):
        assert np.array_equal(rows[s, :jn[s]].numpy(), jrows[s, :jn[s]]), s
    assert int(n_miss.sum()) > 0 and (acc.numpy() != acc0).any()
    # The dispatching wrapper runs the same plain version on the CPU.
    acc2 = torch.from_numpy(acc0.copy())
    n2, rows2 = sharded_feed_step(table, acc2, dpacked, bool(reset))
    assert torch.equal(acc2, acc) and torch.equal(n2, n_miss) \
        and torch.equal(rows2, rows)
    assert sharded.LAUNCHES["sharded_feed"] == 0


# -- placement, overflow, routing, compaction --------------------------------


def test_subtable_overflow_is_bounded():
    """test_aggregator_sharded.py's case: a full sub-table refuses its
    keys (sketch) or raises before any mutation (raise)."""
    for overflow in ("raise", "sketch"):
        jd, pd_ = _pair(1 << 9, 8, overflow=overflow)
        for d in (jd, pd_):
            d._occ[:d._cap_s] = True
        key, key1 = (5, 0, 7), (5, 1, 7)
        assert pd_._try_insert_slot(key) is None
        assert pd_._try_insert_slot(key1) == jd._try_insert_slot(key1)
        pd_._check_insert_room([], {key1})
        if overflow == "raise":
            with pytest.raises(RuntimeError, match="sub-table"):
                pd_._check_insert_room([], {key})
            with pytest.raises(RuntimeError, match="sub-table 0"):
                pd_._check_insert_room_vec(
                    np.array([5], np.uint32), np.array([8], np.uint32),
                    np.array([7], np.uint32))
        else:
            pd_._check_insert_room([], {key})
            pd_._check_insert_room_vec(
                np.array([5], np.uint32), np.array([8], np.uint32),
                np.array([7], np.uint32))


def _skewed(pid):
    """Three pids of four to shard 0."""
    return 0 if pid % 4 else pid // 4


@pytest.mark.parametrize("overflow", ["raise", "sketch"])
def test_skewed_router_overflows_one_subtable(overflow):
    """Shard 0's sub-table fills while the table is half empty: "sketch"
    absorbs the rest one key at a time (the sketch state equal to JAX's,
    exact mass + sketch samples = the window's), "raise" raises before
    any mutation, in both packages."""
    snaps = _snaps(**_kw(seed=9, n_pids=40, rows=700))
    jd, pd_ = _pair(1 << 11, 8, overflow=overflow, shard_of_pid=_skewed,
                    rotate_min_age=1)
    if overflow == "raise":
        for d, s in zip((jd, pd_), snaps):
            with pytest.raises(RuntimeError, match="sub-table 0"):
                d.window_counts(s)
        _assert_same(jd, pd_)
        assert pd_._next_id == 0
        return
    counts = _window(jd, pd_, snaps)
    _assert_same(jd, pd_)
    absorbed = pd_.stats["sketch_samples"]
    assert absorbed > 0 and pd_._rotate_pending
    assert int(counts.sum()) + absorbed == snaps[1].total_samples()
    assert pd_._shard_free()[0] == 0 and pd_._shard_free()[1:].min() > 0
    # A second window of the same rows: the same keys absorb again.
    _window(jd, pd_, snaps, step=200)
    _assert_same(jd, pd_)
    # Other rows, then the first again: the rotation evicts the ids the
    # second set did not see and re-inserts the survivors one sub-table
    # at a time, shard 0's full one key by key.
    other = _snaps(**_kw(seed=19, n_pids=40, rows=700))
    _window(jd, pd_, other)
    full = int((pd_._occ[:pd_._cap_s]).sum())
    _window(jd, pd_, snaps, step=300)
    _assert_same(jd, pd_)
    assert pd_.stats["rotations"] == 1 and full > pd_._cap_s // 2


@pytest.mark.parametrize("n", SHARDS)
def test_pid_router_places_by_pid(n):
    snaps = _snaps(**_kw(seed=4, n_pids=12, rows=500))

    def router(pid):
        return pid % 3

    jd, pd_ = _pair(1 << 12, n, shard_of_pid=router)
    counts = _window(jd, pd_, snaps)
    _assert_same(jd, pd_)
    slots = np.flatnonzero(pd_._occ)
    pids = pd_._id_pid[pd_._ids[slots]].astype(np.int64)
    assert np.array_equal(slots // pd_._cap_s, (pids % 3) % n)
    assert int(counts.sum()) == snaps[1].total_samples()
    # Carried hashes go through the same rewrite.
    h = pd_.hash_rows(snaps[1])
    assert np.array_equal(h[1], jd.hash_rows(snaps[0])[1])
    _window(jd, pd_, snaps, step=100)
    _assert_same(jd, pd_)


@pytest.mark.parametrize("n", SHARDS)
def test_rotation_and_invalidation_equal_jax(n):
    """Compactions re-insert the survivors within their sub-tables, in id
    order, as JAX's one-by-one re-insertion does."""
    jd, pd_ = _pair(1 << 11, n, rotate_min_age=1)
    a = _snaps(**_kw(seed=21, n_pids=10, rows=500))
    b = _snaps(**_kw(seed=22, n_pids=10, rows=700))
    _window(jd, pd_, a)
    _window(jd, pd_, b, step=150)
    _assert_same(jd, pd_)
    for d in (jd, pd_):
        d._rotate_pending = True
    _window(jd, pd_, a)  # the rotation evicts what b added
    _assert_same(jd, pd_)
    assert pd_.stats["rotations"] == 1
    pid = int(pd_._id_pid[0])
    assert pd_.invalidate_pid(pid) and jd.invalidate_pid(pid)
    _assert_same(jd, pd_)
    _window(jd, pd_, b)
    _assert_same(jd, pd_)


def _cols(snap, lo, hi):
    return (snap.pids[lo:hi], snap.tids[lo:hi], snap.user_len[lo:hi],
            snap.kernel_len[lo:hi], snap.stacks[lo:hi], snap.counts[lo:hi])


class _NoMaps:
    def executable_mappings(self, pid):
        return []

    def build_ids(self, per_pid):
        return {}

    def get(self, pid, m):
        return None


@pytest.mark.parametrize("n", [2, 8])
def test_streaming_feeder_with_carry_equals_jax(n):
    """The streaming feeder over carrying sharded dictionaries: three
    windows, counts and carry counters equal to JAX's, steady windows
    carry."""
    snaps = _snaps(**{**_kw(seed=7, n_pids=8, rows=400), "mean_depth": 8})
    jd, pd_ = _pair(1 << 12, n, carry=True)
    feeders = (JaxFeeder(jd, _NoMaps(), _NoMaps()),
               StreamingWindowFeeder(pd_, _NoMaps(), _NoMaps()))
    for w in range(3):
        for f, s in zip(feeders, snaps):
            for lo in range(0, len(s), 96):
                f.on_drain(_cols(s, lo, min(lo + 96, len(s))))
        jc, pc = (f.take_window_if_complete(s) for f, s in zip(feeders,
                                                                snaps))
        assert pc is not None and np.array_equal(np.asarray(jc), pc), w
        assert int(pc.sum()) == snaps[1].total_samples()
    _assert_same(jd, pd_)
    for k in ("carry_hits", "carry_rows_in", "carry_mass", "carry_flushes",
              "carry_admitted", "carry_entries"):
        assert pd_.stats.get(k) == jd.stats.get(k), k
    assert pd_.stats["carry_hits"] > 0


@pytest.mark.parametrize("seed", [31, 33])
def test_window_encoder_bytes_equal_jax(seed):
    """The churn fuzz of the window encoder over both sharded
    dictionaries (8 shards): every pid's bytes equal, every window."""
    rng = np.random.default_rng(seed)
    jd, pd_ = _pair(1 << 13, 8)
    jenc, penc = JaxEncoder(jd), WindowEncoder(pd_)
    sa = _snaps(**_kw(seed=seed, n_pids=8, rows=300))
    sb = _snaps(**_kw(seed=seed + 100, n_pids=14, rows=500))
    snap, c_full = sa[1], _window(jd, pd_, sa)
    for w in range(8):
        if w == 4:
            snap, c_full = sb[1], _window(jd, pd_, sb)
        c = c_full.copy()
        c[rng.random(len(c)) < 1 - rng.uniform(0.2, 1.0)] = 0
        if rng.random() < 0.5:
            c[c > 0] += rng.integers(1, 5)
        args = (snap.time_ns + w, snap.window_ns, snap.period_ns)
        jout = jenc.encode(c.copy(), *args)
        pout = penc.encode(c.copy(), *args)
        assert [p for p, _ in pout] == [p for p, _ in jout]
        for (pid, jb), (_, pb) in zip(jout, pout):
            assert bytes(pb) == bytes(jb), (w, pid)


def _fuzz_trial(seed: int) -> None:
    """test_dict_fuzz.py's _trial(sharded=True) through both packages:
    random chunking, capacity pressure, sketch degradation, rotation;
    every window's counts, dictionary and sketch equal."""
    rng = np.random.default_rng(seed)
    n_pids = int(rng.integers(1, 40))
    uniq = int(rng.integers(1, 3000))
    kw = dict(n_pids=n_pids, n_unique_stacks=uniq, n_rows=uniq,
              total_samples=int(rng.integers(uniq, uniq * 50 + 1)),
              mean_depth=int(rng.integers(2, 60)),
              kernel_fraction=float(rng.random()),
              n_funcs=int(rng.choice([4, 64, 4096])), seed=seed)
    windows = [_snaps(**kw)]
    mode = rng.integers(0, 3)
    if mode == 1:
        windows += [_snaps(**{**kw, "seed": seed + 9999}),
                    _snaps(**{**kw, "seed": seed + 77777})]
    elif mode == 2:
        windows.append(windows[0])
    cap_lo = max(4, (uniq - 1).bit_length() - 1)
    cap_exp = cap_lo if rng.random() < 0.45 else int(rng.integers(cap_lo, 14))
    cap = max(1 << cap_exp, 1 << 9)
    overflow = "sketch" if rng.random() < 0.7 else "raise"
    jd, pd_ = _pair(cap, 8, overflow=overflow, rotate_min_age=1)
    for snaps in windows:
        before = pd_.stats.get("sketch_samples", 0)
        h = (jd.hash_rows(snaps[0]), pd_.hash_rows(snaps[1]))
        n = len(snaps[1])
        cuts = None
        if rng.random() >= 0.5:
            cuts = np.sort(rng.integers(0, n + 1,
                                        size=int(rng.integers(0, 6))))
            cuts = [0, *[int(c) for c in cuts], n]
        outs = []
        for d, s, hh in zip((jd, pd_), snaps, h):
            try:
                if cuts is None:
                    outs.append(np.asarray(d.window_counts(s, hh)))
                else:
                    for lo, hi in zip(cuts[:-1], cuts[1:]):
                        d.feed(s, hh, lo, hi)
                    outs.append(np.asarray(d.close_window()))
            except RuntimeError as e:
                outs.append(str(e))
        if isinstance(outs[0], str):
            assert overflow == "raise" and outs[1] == outs[0]
            return
        assert np.array_equal(outs[0], outs[1])
        absorbed = pd_.stats.get("sketch_samples", 0) - before
        assert int(outs[1].sum()) + absorbed == snaps[1].total_samples()
        _assert_same(jd, pd_)


@pytest.mark.parametrize("seed", range(6))
def test_differential_fuzz_slice_equals_jax(seed):
    _fuzz_trial(seed)


# -- the CLI -----------------------------------------------------------------


def test_cli_sharded_on_cpu(tmp_path):
    """--aggregator sharded --fast-encode on the CPU: one shard, every
    window's mass in the store, the encode pipeline used."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    store = tmp_path / "store"
    r = subprocess.run(
        [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "synthetic", "--aggregator", "sharded", "--fast-encode",
         "--windows", "2", "--profiling-duration", "0.5",
         "--local-store-directory", str(store)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{") and '"window"' in ln]
    assert [ln["aggregator"] for ln in lines] == ["sharded"] * 2
    assert all(ln["mass"] == ln["samples"] for ln in lines)
    files = sorted(store.glob("*.pb.gz"))
    assert len(files) == sum(ln["profiles"] for ln in lines)
    mass = sum(v[0] for f in files
               for _, v, _ in parse_pprof(f.read_bytes()).samples)
    assert mass == sum(ln["samples"] for ln in lines)


def test_constructor_checks_and_defaults():
    with pytest.raises(ValueError, match="divide"):
        ShardedDictAggregator(capacity=(1 << 13) + 4, n_shards=8,
                              device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        ShardedDictAggregator(capacity=3 << 10, n_shards=2, device="cpu")
    agg = ShardedDictAggregator(capacity=1 << 10, device="cpu")
    assert agg._n_shards == 1 and agg._blk == 0 and agg._touch is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedDictAggregator(capacity=1 << 10)
