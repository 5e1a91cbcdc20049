"""The port's one-shot window aggregator on the CPU against parca_agent_tpu's.

Inputs are made with numpy from a seed (the synthetic generators of both
packages, held equal by test_torch_capture) and handed to both sides: the
port's torch hashing paths, row hash, location table, window program and
TPUAggregator (plain versions, on CPU tensors), and the JAX package's jnp
hashing, its window program (`_jitted_kernel`, with the Pallas location
table in interpret mode, as its own tests run it on the CPU) and its
TPUAggregator. Everything compared is an integer or bytes, compared
exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator import tpu as jax_tpu
from parca_agent_tpu.aggregator.pallas_probe import make_loc_table_builder
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.ops import hashing as jax_hashing
from parca_agent_tpu.pprof.builder import build_pprof as jax_build_pprof
from parca_agent_tpu_torch.aggregator import probe
from parca_agent_tpu_torch.aggregator import tpu
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.ops import hashing, row_hash
from parca_agent_tpu_torch.pprof.builder import build_pprof
from tests.test_torch_cuda import EDGE_DEPTHS, _edge_rows

# One intra-op thread a process: the suite runs in several worker
# processes at once, and torch's default of a thread a core in each
# oversubscribes the host, so that timing-bound tests in other workers
# (an encode pipeline busy at a window's close) take another path.
torch.set_num_threads(1)

CPU = torch.device("cpu")

# The windows of the JAX package's own tests of this path:
# tests/test_aggregator_tpu.py's synthetic spec, test_close_overlap.py's
# _snap(seed=61, rows=512, pids=8), and a small function pool, where a
# pid's frames repeat across most of its stacks.
SPECS = {
    "pids13": dict(n_pids=13, n_unique_stacks=300, seed=7),
    "snap61": dict(n_pids=8, n_unique_stacks=512, n_rows=512,
                   total_samples=1536, mean_depth=8, seed=61),
    "funcs16": dict(n_pids=5, n_unique_stacks=400, total_samples=5000,
                    n_funcs=16, seed=3),
}


def _snaps(name):
    return (generate(SyntheticSpec(**SPECS[name])),
            jax_generate(JaxSpec(**SPECS[name])))


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 torch tensor of the same bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _profile_fields(p):
    return (p.pid, p.stack_loc_ids.tolist(), p.stack_depths.tolist(),
            p.values.tolist(), p.loc_address.tolist(),
            p.loc_normalized.tolist(), p.loc_mapping_id.tolist(),
            p.loc_is_kernel.tolist(),
            [dataclasses.astuple(m) for m in p.mappings], p.period_ns,
            p.time_ns, p.duration_ns)


# -- hashing: torch paths against jnp -----------------------------------------


def test_torch_hashing_matches_jnp():
    rng = np.random.default_rng(0)
    lanes = rng.integers(0, 2**32, (64, 259), dtype=np.uint64).astype(
        np.uint32)
    lanes[:8] = 0xFFFFFFFF  # every lane with the top bit set
    lanes[8:16] |= np.uint32(0x80000000)
    for which in range(hashing.N_FAMILIES):
        want = np.asarray(jax_hashing.multilinear_hash_u32(
            jnp.asarray(lanes), which))
        got = hashing.multilinear_hash_u32(_t(lanes), which)
        assert got.dtype == torch.int32
        assert np.array_equal(_u32(got), want)
        # int64 lanes in [0, 2^32) hash alike.
        wide = torch.from_numpy(lanes.astype(np.int64))
        assert np.array_equal(_u32(hashing.multilinear_hash_u32(wide, which)),
                              want)
    for seed in (0, 0x9E3779B9, 0xFFFFFFFF):
        want = np.asarray(jax_hashing.mix32(jnp.asarray(lanes[:, 3]), seed))
        assert np.array_equal(_u32(hashing.mix32(_t(lanes[:, 3]), seed)),
                              want)
    hi, lo = lanes[:, :5], lanes[:, 5:10]
    extra = [lanes[:, 10], lanes[:, 11]]
    want = np.asarray(jax_hashing.fold_u64_rows(
        jnp.asarray(hi), jnp.asarray(lo), [jnp.asarray(e) for e in extra]))
    got = hashing.fold_u64_rows(_t(hi), _t(lo), [_t(e) for e in extra])
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_row_hash_plain_matches_window_kernel_hash_and_numpy(name):
    snap, _ = _snaps(name)
    host, _dims = tpu.pack_window_inputs(snap)
    pid, _cnt, ulen, klen, shi, slo = host[:6]
    # _window_kernel's step 1, as it computes it (jnp).
    lanes = jax_hashing.fold_u64_rows(
        jnp.asarray(shi), jnp.asarray(slo),
        extra=[jnp.asarray(pid), jnp.asarray(ulen).astype(jnp.uint32),
               jnp.asarray(klen).astype(jnp.uint32)])
    want = [np.asarray(jax_hashing.multilinear_hash_u32(lanes, k))
            for k in (0, 1)]
    got = row_hash.row_hash_plain(_t(shi), _t(slo), _t(pid),
                                  torch.from_numpy(ulen),
                                  torch.from_numpy(klen))
    assert all(np.array_equal(_u32(g), w) for g, w in zip(got, want))
    stacks = (shi.astype(np.uint64) << np.uint64(32)) | slo
    np_hashes = hashing.row_hash_np(stacks, pid, ulen, klen)
    assert all(np.array_equal(_u32(g), w) for g, w in zip(got, np_hashes))


@pytest.mark.parametrize("n", [1, 5, 4097])
def test_row_hash_plain_matches_window_kernel_hash_on_edge_rows(n):
    """The rows the CUDA kernel's edge tests use (depths EDGE_DEPTHS,
    padding rows, n not a multiple of 4), hashed by _window_kernel's
    step 1 (jnp) and by the port's CPU dispatch."""
    shi, slo, pid, ulen, klen = _edge_rows(n, seed=n)
    assert n < len(EDGE_DEPTHS) or \
        set(EDGE_DEPTHS) <= set((ulen + klen).tolist())
    lanes = jax_hashing.fold_u64_rows(
        jnp.asarray(shi), jnp.asarray(slo),
        extra=[jnp.asarray(pid), jnp.asarray(ulen).astype(jnp.uint32),
               jnp.asarray(klen).astype(jnp.uint32)])
    want = [np.asarray(jax_hashing.multilinear_hash_u32(lanes, k))
            for k in (0, 1)]
    got = row_hash.row_hash(_t(shi), _t(slo), _t(pid),
                            torch.from_numpy(ulen), torch.from_numpy(klen))
    assert all(np.array_equal(_u32(g), w) for g, w in zip(got, want))


def test_row_hash_plain_chunks_agree_and_count_no_launches(monkeypatch):
    snap, _ = _snaps("snap61")
    host, _ = tpu.pack_window_inputs(snap)
    args = [torch.from_numpy(a.view(np.int32)) for a in host[:6]]
    pid, _cnt, ulen, klen, shi, slo = args
    row_hash.reset_launches()
    whole = row_hash.row_hash(shi, slo, pid, ulen, klen)
    monkeypatch.setattr(row_hash, "_CHUNK_ROWS", 100)
    chunked = row_hash.row_hash(shi, slo, pid, ulen, klen)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
    assert row_hash.LAUNCHES == {"row_hash": 0}
    with pytest.raises(ValueError):
        row_hash.row_hash(shi, slo, pid.to(torch.int64), ulen, klen)
    with pytest.raises(ValueError):
        row_hash.row_hash(shi, slo[:, :64].contiguous(), pid, ulen, klen)


# -- the location table: plain version against the Pallas kernel --------------


def _loc_case(kind: str):
    """make_loc_table_builder's test cases (test_close_overlap.py): keys
    whose probe bases collide mod 8 with 25% dead lanes, an 8-slot table
    that overflows, and a window-like case with family-3 bases; and two
    more: most lanes on one key (its home slot's claim contended), and
    keys (p, 0, 0) beside (p, 0, 1) and (p, 1, 0) on one chain."""
    if kind == "collide_mod8":
        rng = np.random.default_rng(7)
        f_cap, cap_l = 256, 64
        uniq = rng.integers(1, 2**31, size=(24, 3), dtype=np.uint64)
        pick = rng.integers(0, 24, size=f_cap)
        kpid, khi, klo = (uniq[pick, j].astype(np.uint32) for j in range(3))
        kpid[rng.random(f_cap) < 0.25] = np.uint32(0xFFFFFFFF)
        base = (kpid % 8).astype(np.uint32)
    elif kind == "overflow":
        rng = np.random.default_rng(9)
        f_cap, cap_l = 64, 8
        kpid, khi, klo = (rng.integers(1, 2**31, size=f_cap).astype(
            np.uint32) for _ in range(3))
        base = (kpid & np.uint32(cap_l - 1)).astype(np.uint32)
    elif kind == "heavy_dup":
        rng = np.random.default_rng(13)
        f_cap, cap_l = 512, 32
        uniq = rng.integers(0, 2**31, size=(6, 3), dtype=np.uint64)
        pick = np.where(rng.random(f_cap) < 0.9, 0,
                        rng.integers(1, 6, size=f_cap))
        kpid, khi, klo = (uniq[pick, j].astype(np.uint32) for j in range(3))
        kpid[rng.random(f_cap) < 0.1] = np.uint32(0xFFFFFFFF)
        base = np.asarray(jax_hashing.multilinear_hash_u32(
            jnp.asarray(np.stack([kpid, khi, klo], -1)), 3))
    elif kind == "p00":
        rng = np.random.default_rng(17)
        f_cap, cap_l = 128, 32
        uniq = np.array([(p, h, lo) for p in (5, 6, 0x7FFFFFFF)
                         for h, lo in ((0, 0), (0, 1), (1, 0))], np.uint32)
        pick = rng.integers(0, len(uniq), size=f_cap)
        kpid, khi, klo = (uniq[pick, j].copy() for j in range(3))
        base = np.zeros(f_cap, np.uint32)  # one chain for every key
    else:
        rng = np.random.default_rng(11)
        f_cap, cap_l = 2048, 1024
        uniq = rng.integers(0, 2**32, size=(300, 3), dtype=np.uint64)
        pick = rng.integers(0, 300, size=f_cap)
        kpid, khi, klo = (uniq[pick, j].astype(np.uint32) for j in range(3))
        kpid &= np.uint32(0x7FFFFFFF)
        kpid[1500:] = np.uint32(0xFFFFFFFF)  # the compacted tail
        base = np.asarray(jax_hashing.multilinear_hash_u32(
            jnp.asarray(np.stack([kpid, khi, klo], -1)), 3))
    return kpid, khi, klo, base, f_cap, cap_l


LOC_KINDS = ["collide_mod8", "overflow", "family3", "heavy_dup", "p00"]


@pytest.mark.parametrize("kind", LOC_KINDS)
def test_loc_table_plain_matches_pallas(kind):
    """The plain version's slots equal the Pallas kernel's, and its dense
    list is the Pallas table's live keys in slot order (dropped past
    l_cap = cap_l / 2), each beside its slot, then (U32_MAX, 0, 0, cap_l)
    padding; n_entries counts the table's keys."""
    kpid, khi, klo, base, f_cap, cap_l = _loc_case(kind)
    l_cap = cap_l // 2
    slot_w, tpid, thi, tlo = (np.asarray(x) for x in make_loc_table_builder(
        f_cap, cap_l, interpret=True)(kpid, khi, klo, base))
    before = dict(probe.LAUNCHES)
    got = probe.build_loc_table(_t(kpid), _t(khi), _t(klo), _t(base), cap_l,
                                l_cap)
    assert probe.LAUNCHES == before
    slot, epid, ehi, elo, eslot, n_entries = (x.numpy() for x in got)
    assert np.array_equal(slot, slot_w)
    live_slots = np.flatnonzero(tpid != np.uint32(0xFFFFFFFF))
    n = len(live_slots)
    assert n_entries.tolist() == [n]
    k = min(n, l_cap)
    assert np.array_equal(eslot[:k], live_slots[:k])
    for g, w in ((epid, tpid), (ehi, thi), (elo, tlo)):
        assert np.array_equal(g.view(np.uint32)[:k], w[live_slots[:k]])
    assert (epid[k:] == -1).all() and (ehi[k:] == 0).all()
    assert (elo[k:] == 0).all() and (eslot[k:] == cap_l).all()
    live = kpid != np.uint32(0xFFFFFFFF)
    assert (slot[~live] == -1).all()
    keys = {(a, b, c) for a, b, c in zip(kpid[live], khi[live], klo[live])}
    if kind == "overflow":
        assert (slot[live] < 0).any() and n > l_cap
    else:
        assert (slot[live] >= 0).all()
        assert len(np.unique(slot[live])) == len(keys) == n <= l_cap


@pytest.mark.parametrize("kind", ["family3", "heavy_dup"])
def test_loc_table_base_none_hashes_family3(kind):
    """base=None probes from loc_base of each key: the same tuple as the
    family-3 bases passed in, and as the JAX program's own."""
    kpid, khi, klo, base, _f_cap, cap_l = _loc_case(kind)
    lanes = [_t(x) for x in (kpid, khi, klo)]
    assert np.array_equal(_u32(probe.loc_base(*lanes)), base)
    want = probe.build_loc_table(*lanes, _t(base), cap_l, cap_l // 2)
    got = probe.build_loc_table(*lanes, None, cap_l, cap_l // 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_loc_table_rejects_bad_inputs():
    lane = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        probe.build_loc_table(lane, lane, lane, lane, 24, 12)
    with pytest.raises(ValueError):
        probe.build_loc_table(lane, lane, lane[:8], lane, 32, 16)
    with pytest.raises(ValueError):
        probe.build_loc_table(lane.to(torch.int64), lane, lane, lane, 32, 16)
    with pytest.raises(ValueError):
        probe.build_loc_table(lane, lane, lane, None, 32, 0)


def test_hash_dedup_padding_keeps_live_ranks():
    """A window whose location table has live keys in slot 0 and in the
    last slot, with l_cap four times the locations: the dense list's
    padding (slot cap_loc, the dump entry) leaves every live slot's rank
    as the JAX program has it."""
    snap, jsnap = _snaps("snap61")
    l_cap = 4 * tpu.pack_window_inputs(snap)[1]["l_cap"]
    cap_loc = 2 * l_cap
    # Two frames of row 0 get addresses whose keys' homes are slot 0 and
    # slot cap_loc - 1.
    pid = int(snap.pids[0])
    lo = torch.arange(1, 1 << 20, dtype=torch.int32)
    home = hashing.u32_wide(probe.loc_base(
        torch.full_like(lo, pid), torch.full_like(lo, 0x55), lo)) \
        & (cap_loc - 1)
    addrs = [(0x55 << 32) | int(lo[(home == h).nonzero()[0, 0]])
             for h in (0, cap_loc - 1)]
    assert snap.user_len[0] >= 2
    stacks = snap.stacks.copy()
    stacks[0, :2] = addrs
    snap = dataclasses.replace(snap, stacks=stacks)
    jsnap = dataclasses.replace(jsnap, stacks=stacks.copy())
    host, dims = jax_tpu.pack_window_inputs(
        jax_tpu._coalesce_snapshot_rows(jsnap), l_cap)
    want = [np.asarray(x) for x in jax_tpu._jitted_kernel()(
        *host, hash_locs=True, interpret=True, **dims)]
    got = tpu.window_program(*tpu.to_device(host, CPU), dedup="hash",
                             **dims)
    for g, w, dt in zip(got, want, tpu.OUTPUT_DTYPES):
        assert np.array_equal(g.numpy().view(dt), w)
    # The table really has both end slots live and padding in its list.
    depth = snap.user_len.astype(np.int64) + snap.kernel_len
    rows = np.repeat(np.arange(len(snap)), depth)
    cols = np.arange(depth.sum()) - np.repeat(np.cumsum(depth) - depth, depth)
    frames = snap.stacks[rows, cols]
    _slot, _p, _h, _l, eslot, n_entries = probe.build_loc_table(
        _t(snap.pids[rows].astype(np.uint32)),
        _t((frames >> np.uint64(32)).astype(np.uint32)),
        _t(frames.astype(np.uint32)), None, cap_loc, l_cap)
    assert int(n_entries[0]) < l_cap
    assert {0, cap_loc - 1, cap_loc} <= set(eslot.tolist())


# -- the window program, both arms, against _window_kernel --------------------


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("dedup", ["hash", "sort"])
def test_window_program_matches_jax_window_kernel(name, dedup):
    snap, jsnap = _snaps(name)
    host, dims = jax_tpu.pack_window_inputs(jax_tpu._coalesce_snapshot_rows(
        jsnap))
    want = [np.asarray(x) for x in jax_tpu._jitted_kernel()(
        *host, hash_locs=dedup == "hash", interpret=True, **dims)]
    pos = tpu.to_device(host, CPU)
    got = tpu.window_program(*pos, dedup=dedup, **dims)
    assert len(got) == len(want) == 10
    for g, w, dt in zip(got, want, tpu.OUTPUT_DTYPES):
        assert w.dtype == dt
        assert g.shape == w.shape
        assert np.array_equal(g.numpy().view(dt), w)
    assert 0 < int(got[1]) <= dims["l_cap"]


def test_window_program_rejects_unknown_dedup():
    snap, _ = _snaps("snap61")
    host, dims = tpu.pack_window_inputs(snap)
    with pytest.raises(ValueError):
        tpu.window_program(*tpu.to_device(host, CPU), dedup="auto", **dims)
    with pytest.raises(ValueError):
        tpu.TPUAggregator(dedup="auto", device="cpu")


# -- TPUAggregator: profiles and pprof bytes ----------------------------------


@pytest.mark.parametrize("name", ["pids13", "snap61"])
def test_tpu_aggregator_matches_jax(name):
    snap, jsnap = _snaps(name)
    want = jax_tpu.TPUAggregator().aggregate(jsnap)
    agg = tpu.TPUAggregator(device="cpu")
    got = agg.aggregate(snap)
    assert [_profile_fields(p) for p in got] == \
        [_profile_fields(p) for p in want]
    assert [build_pprof(p, compress=False) for p in got] == \
        [jax_build_pprof(p, compress=False) for p in want]
    assert tpu.shadow_compare(got, CPUAggregator().aggregate(snap))
    assert agg.stats["n_groups"] == sum(len(p.values) for p in got)
    assert set(agg.device_ms) == {"row_hash", "stack_sort_dedup",
                                  "frame_compaction", "loc_table",
                                  "table_sort_ranks", "mapping_join"}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_hash_and_sort_arms_byte_identical(name):
    snap, _ = _snaps(name)
    ph = tpu.TPUAggregator(dedup="hash", device="cpu").aggregate(snap)
    ps = tpu.TPUAggregator(dedup="sort", device="cpu").aggregate(snap)
    assert b"".join(build_pprof(p, compress=False) for p in ph) == \
        b"".join(build_pprof(p, compress=False) for p in ps)


@pytest.mark.parametrize("dedup", ["hash", "sort"])
def test_l_cap_doubling_retry_gives_the_same_profiles(monkeypatch, dedup):
    snap, _ = _snaps("funcs16")
    want = tpu.TPUAggregator(dedup=dedup, device="cpu").aggregate(snap)
    pack = tpu.pack_window_inputs
    monkeypatch.setattr(tpu, "pack_window_inputs",
                        lambda s: pack(s, l_cap=16))
    agg = tpu.TPUAggregator(dedup=dedup, device="cpu")
    got = agg.aggregate(snap)
    assert agg.stats["attempts"] > 1
    assert agg.stats["l_cap"] >= agg.stats["n_locs"] > 16
    assert [_profile_fields(p) for p in got] == \
        [_profile_fields(p) for p in want]


def test_loc_warning_fires_once(monkeypatch, caplog):
    snap, _ = _snaps("snap61")
    agg = tpu.TPUAggregator(device="cpu")
    monkeypatch.setattr(agg, "LOC_WARN_THRESHOLD", 1)
    with caplog.at_level("WARNING", logger=tpu.__name__):
        agg.aggregate(snap)
        agg.aggregate(snap)
    assert sum("adversarial regime" in r.message for r in caplog.records) \
        == 1


def test_empty_snapshot_and_negative_pid():
    snap, _ = _snaps("snap61")
    empty = dataclasses.replace(
        snap, pids=snap.pids[:0], tids=snap.tids[:0], counts=snap.counts[:0],
        user_len=snap.user_len[:0], kernel_len=snap.kernel_len[:0],
        stacks=snap.stacks[:0])
    assert tpu.TPUAggregator(device="cpu").aggregate(empty) == []
    pids = snap.pids.copy()
    pids[3] = -1
    with pytest.raises(ValueError, match="negative pid"):
        tpu.TPUAggregator(device="cpu").aggregate(
            dataclasses.replace(snap, pids=pids))


def _with_duplicates(snap):
    """The window plus a shuffled copy of a third of its rows under other
    tids: exact duplicates in everything the program consumes."""
    rng = np.random.default_rng(5)
    idx = np.concatenate([np.arange(len(snap)),
                          rng.choice(len(snap), len(snap) // 3)])
    idx = idx[rng.permutation(len(idx))]
    return dataclasses.replace(
        snap, pids=snap.pids[idx], tids=snap.tids[idx] + 7,
        counts=snap.counts[idx], user_len=snap.user_len[idx],
        kernel_len=snap.kernel_len[idx], stacks=snap.stacks[idx])


def test_pack_and_coalesce_copies_match_jax():
    snap, jsnap = _snaps("funcs16")
    snap, jsnap = _with_duplicates(snap), _with_duplicates(jsnap)
    got, want = tpu._coalesce_snapshot_rows(snap), \
        jax_tpu._coalesce_snapshot_rows(jsnap)
    assert len(got) < len(snap)
    for f in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    for l_cap in (None, 64):
        (ga, gd), (wa, wd) = tpu.pack_window_inputs(got, l_cap), \
            jax_tpu.pack_window_inputs(want, l_cap)
        assert gd == wd
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(ga, wa))
    # The fold sums counts, so the profiles are those of the window.
    prof = tpu.TPUAggregator(device="cpu").aggregate(snap)
    assert tpu.shadow_compare(prof, CPUAggregator().aggregate(snap))
