"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: each test skips on a host without a CUDA device. This file
imports neither jax nor parca_agent_tpu, so it runs on a machine that has
neither; run it there with the repository's conftest left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from parca_agent_tpu_torch.aggregator import probe, tpu
from parca_agent_tpu_torch.aggregator.dict import DictAggregator, feed_step
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.ops import row_hash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _table_and_queries(seed: int, cap: int, n_query: int):
    """Table at ~1/4 load with a chain past the probe bound and
    h1-only collisions; queries hit, miss on empty slots, and miss past
    the bound."""
    rng = np.random.default_rng(seed)
    n_keys = cap // 4
    keys = rng.integers(0, 2**32, size=(n_keys, 3), dtype=np.uint64)
    keys[1:1 + probe.PROBES + 4, 0] = keys[0, 0]
    table = np.zeros((cap, 4), np.uint32)
    for sid, (a, b, c) in enumerate(keys):
        idx = int(a) & (cap - 1)
        while table[idx, 3]:
            idx = (idx + 1) & (cap - 1)
        table[idx] = (a, b, c, sid + 1)
    h1_only = keys[rng.integers(0, n_keys, n_query // 4)].copy()
    h1_only[:, 2] ^= np.uint64(1)
    unknown = rng.integers(0, 2**32, size=(n_query // 4, 3), dtype=np.uint64)
    known = keys[rng.integers(0, n_keys, n_query - 2 * (n_query // 4))]
    q = np.concatenate([known, h1_only, unknown])[:n_query].astype(np.uint32)
    q = q[rng.permutation(len(q))]
    return table, q.T.copy()


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


@pytest.mark.parametrize("cap", [1 << 8, 1 << 12, 1 << 16])
def test_batch_probe_kernel_equals_plain(cuda, cap):
    table, (h1, h2, h3) = _table_and_queries(cap, cap, 3 * cap + 5)
    args = [_t(x, cuda) for x in (table, h1, h2, h3)]
    before = probe.LAUNCHES["batch_probe"]
    got = probe.batch_probe(*args)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["batch_probe"] == before + 1
    want = probe.batch_probe_plain(*args)
    assert torch.equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def _chain_case(cap: int, seed: int):
    """Rows whose walk stops (a hit, or an empty slot) at chosen steps k:
    slots home .. home + k - 1 hold other keys, one of them sharing the
    row's h1; the first chain starts 5 slots before the table's end, so
    it wraps past cap - 1. The kernel reads the home slot (step 0) alone,
    then G = 8 slots a round from step 1 (steps 1-8, then 9-15): steps
    7 and 8 are G - 1 and G, 8 and 9 sit on the rounds' boundary, 15 is
    the last step inside the bound, 16 and 17 past it (misses). 47 rows:
    the last group is partial."""
    rng = np.random.default_rng(seed)
    table = np.zeros((cap, 4), np.uint32)
    rows, steps = [], []
    for c, k in enumerate(([9, 15, 16, 17, 0, 1, 2, 4, 7, 8, 12, 13]
                           * 4)[:47]):
        home = (cap - 5 + 20 * c) % cap
        h1 = np.uint32(home | (int(rng.integers(1, 1 << 20)) << 12))
        h2, h3 = rng.integers(1, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        for j in range(k):
            fill_h1 = h1 if j == k // 2 else np.uint32(rng.integers(2**32))
            table[(home + j) % cap] = (fill_h1, h2 ^ np.uint32(1), h3,
                                       1000 + 32 * c + j)
        if c % 2 == 0:  # a hit at step k; else the empty slot stops it
            table[(home + k) % cap] = (h1, h2, h3, 1 + c)
        rows.append((h1, h2, h3))
        steps.append(k)
    q = np.array(rows, np.uint32)
    return table, q[:, 0].copy(), q[:, 1].copy(), q[:, 2].copy(), steps


def test_probe_kernel_chain_stops_and_wraps(cuda):
    table, h1, h2, h3, steps = _chain_case(1 << 10, 8)
    cnt = np.arange(1, len(h1) + 1, dtype=np.uint32)
    tab, d1, d2, d3, dc = (_t(x, cuda) for x in (table, h1, h2, h3, cnt))
    got = probe.batch_probe(tab, d1, d2, d3)
    want = probe.batch_probe_plain(tab, d1, d2, d3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    hit = [c % 2 == 0 and k < probe.PROBES for c, k in enumerate(steps)]
    assert ((want >= 0).cpu().numpy() == np.array(hit)).all()
    outs = []
    for fn in (probe.feed_accumulate, probe.feed_accumulate_plain):
        acc = torch.zeros(64, dtype=torch.int32, device=cuda)
        touch = torch.zeros(8, dtype=torch.int32, device=cuda)
        outs.append((fn(tab, acc, touch, 8, d1, d2, d3, dc), acc, touch))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("blk", [0, 128])
def test_feed_accumulate_kernel_equals_plain(cuda, blk):
    cap, id_cap = 1 << 14, 1 << 13
    table, (h1, h2, h3) = _table_and_queries(7, cap, 20_000)
    cnt = np.random.default_rng(1).integers(0, 9, len(h1)).astype(np.uint32)
    lanes = [_t(x, cuda) for x in (h1, h2, h3, cnt)]
    tab = _t(table, cuda)
    outs = []
    for fn in (probe.feed_accumulate, probe.feed_accumulate_plain):
        acc = torch.zeros(id_cap, dtype=torch.int32, device=cuda)
        touch = (torch.zeros(id_cap // blk, dtype=torch.int32, device=cuda)
                 if blk else None)
        found = fn(tab, acc, touch, blk, *lanes)
        outs.append((found, acc, touch))
    torch.cuda.synchronize()
    (f0, a0, t0), (f1, a1, t1) = outs
    assert torch.equal(f0, f1) and torch.equal(a0, a1)
    if blk:
        assert torch.equal(t0, t1)


def test_feed_step_cuda_equals_cpu(cuda):
    cap, id_cap = 1 << 12, 1 << 11
    table, (h1, h2, h3) = _table_and_queries(3, cap, 3000)
    packed = np.zeros((4, 4096), np.uint32)
    packed[:3, :3000] = (h1, h2, h3)
    packed[3, :3000] = np.random.default_rng(2).integers(0, 5, 3000)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        acc = torch.ones(id_cap, dtype=torch.int32, device=dev)
        touch = torch.zeros(id_cap // 128, dtype=torch.int32, device=dev)
        nm, rows = feed_step(_t(table, dev), acc, touch, 128,
                             _t(packed, dev), True)
        res[dev.type] = [x.cpu() for x in (acc, touch, nm, rows)]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)


def test_dict_aggregator_cuda_equals_cpu(cuda):
    snap = generate(SyntheticSpec(n_pids=30, n_unique_stacks=3000,
                                  total_samples=50_000, seed=9))
    dc = DictAggregator(capacity=1 << 13, device="cuda")
    dh = DictAggregator(capacity=1 << 13, device="cpu")
    before = probe.LAUNCHES["feed_accumulate"]
    for _ in range(3):
        hashes = dh.hash_rows(snap)
        for d in (dc, dh):
            d.feed(snap, hashes, hi=1000)
            d.feed(snap, hashes, lo=1000)
        assert np.array_equal(dc.close_window(), dh.close_window())
    assert probe.LAUNCHES["feed_accumulate"] == before + 6
    assert dc._key_to_id == dh._key_to_id


def _window(spec: dict):
    snap = generate(SyntheticSpec(**spec))
    return tpu.pack_window_inputs(tpu._coalesce_snapshot_rows(snap))


def test_row_hash_kernel_equals_plain(cuda):
    host, _ = _window(dict(n_pids=40, n_unique_stacks=5000, seed=4))
    pid, _cnt, ulen, klen, shi, slo = tpu.to_device(host[:6], cuda)
    before = row_hash.LAUNCHES["row_hash"]
    got = row_hash.row_hash(shi, slo, pid, ulen, klen)
    torch.cuda.synchronize()
    assert row_hash.LAUNCHES["row_hash"] == before + 1
    want = row_hash.row_hash_plain(shi, slo, pid, ulen, klen)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# Depths at the kernel's edges: none, one frame, either side of its
# 32-frame step, two steps, and a row one short of full and full.
EDGE_DEPTHS = (0, 1, 31, 32, 33, 64, 127, 128)


def _edge_rows(n: int, seed: int, slots: int = 128):
    """(shi, slo, pid, ulen, klen) as numpy: rows cycling through
    EDGE_DEPTHS, split at random between ulen and klen, random uint32
    frames (top bit included) up to the depth and zero past it; every
    fifth row is padding (pid U32_MAX, depth 0, all zero)."""
    rng = np.random.default_rng(seed)
    depth = np.array(EDGE_DEPTHS)[(np.arange(n) + 6) % len(EDGE_DEPTHS)]
    depth = np.minimum(depth, slots)
    pad = np.arange(n) % 5 == 4
    depth[pad] = 0
    klen = (rng.random(n) * (depth + 1)).astype(np.int32)
    ulen = (depth - klen).astype(np.int32)
    live = np.arange(slots)[None, :] < depth[:, None]
    shi, slo = (np.where(live, rng.integers(0, 2**32, (n, slots),
                                            dtype=np.uint64), 0)
                .astype(np.uint32) for _ in range(2))
    pid = rng.integers(0, 2**32 - 1, n, dtype=np.uint64).astype(np.uint32)
    pid[pad] = 0xFFFFFFFF
    return shi, slo, pid, ulen, klen


@pytest.mark.parametrize("n", [1, 5, 4097])
def test_row_hash_kernel_edge_rows(cuda, n):
    """Depths 0 to 128 across the kernel's steps, padding rows, and row
    counts that leave the last warp's quad of rows partial."""
    args = [_t(a, cuda) for a in _edge_rows(n, seed=n)]
    before = row_hash.LAUNCHES["row_hash"]
    got = row_hash.row_hash(*args)
    torch.cuda.synchronize()
    assert row_hash.LAUNCHES["row_hash"] == before + 1
    want = row_hash.row_hash_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_row_hash_kernel_rejects_what_it_cannot_load(cuda):
    """The kernel reads 4 frames a 16-byte load: S = 130 and a shi view
    4 bytes off alignment raise, and launch nothing."""
    shi, slo, pid, ulen, klen = (_t(a, cuda) for a in _edge_rows(
        64, seed=2, slots=130))
    before = row_hash.LAUNCHES["row_hash"]
    with pytest.raises(ValueError, match="multiple of 4"):
        row_hash.row_hash(shi, slo, pid, ulen, klen)
    n, s = 64, 128
    flat = torch.zeros(n * s + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(n, s)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    args = [_t(a, cuda) for a in _edge_rows(n, seed=3)]
    with pytest.raises(ValueError, match="aligned"):
        row_hash.row_hash(shifted, *args[1:])
    assert row_hash.LAUNCHES["row_hash"] == before


def _loc_keys(kind: str, n: int, seed: int):
    """Key lanes (uint32): 1,500 distinct keys with 20% dead lanes; most
    lanes on one key (its home slot's CAS contended); or keys (p, 0, 0)
    beside (p, 0, 1) and (p, 1, 0)."""
    rng = np.random.default_rng(seed)
    if kind == "spread":
        uniq = rng.integers(0, 2**31, size=(1500, 3), dtype=np.uint64)
        keys = uniq[rng.integers(0, 1500, n)].astype(np.uint32)
    elif kind == "heavy_dup":
        uniq = rng.integers(0, 2**31, size=(40, 3), dtype=np.uint64)
        keys = uniq[np.where(rng.random(n) < 0.9, 0,
                             rng.integers(1, 40, n))].astype(np.uint32)
    else:
        p = rng.integers(0, 2**31, 300, dtype=np.uint64)
        uniq = np.array([(q, h, lo) for q in p
                         for h, lo in ((0, 0), (0, 1), (1, 0))], np.uint32)
        keys = uniq[rng.integers(0, len(uniq), n)]
    keys[rng.random(n) < 0.2, 0] = np.uint32(0xFFFFFFFF)
    return keys


@pytest.mark.parametrize("kind,cap_l", [
    ("spread", 1 << 12), ("spread", 1 << 8), ("spread", 1 << 11),
    ("heavy_dup", 1 << 7), ("p00", 1 << 11), ("p00", 1 << 9)])
def test_loc_table_kernel_keeps_the_plain_versions_invariants(cuda, kind,
                                                              cap_l):
    """Slots and the list's order may differ (compare-and-swap claims);
    what must not: the -1 set, each placed lane's slot holding its key in
    the dense list, one slot per distinct key, the padding, the count and
    the sorted list. 2^8 slots cannot hold the 1,500 keys, and 2^9 not
    the 900 (p, h, lo) keys: there some live lane must come back -1. With
    2^11 slots the 1,500 keys place, but the list keeps 2^10 of them and
    counts them all."""
    keys = _loc_keys(kind, 6000, cap_l)
    kpid, khi, klo = (_t(np.ascontiguousarray(keys[:, j]), cuda)
                      for j in range(3))
    l_cap = cap_l // 2
    before = probe.LAUNCHES["loc_table"]
    got = probe.build_loc_table(kpid, khi, klo, None, cap_l, l_cap)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["loc_table"] == before + 1
    want = probe.build_loc_table_plain(kpid, khi, klo, None, cap_l, l_cap)
    slot, epid, ehi, elo, eslot, n_entries = got
    live, placed = kpid != -1, slot >= 0
    assert not (placed & ~live).any()
    n = int(n_entries[0])
    k = min(n, l_cap)
    assert torch.equal(eslot[k:], torch.full_like(eslot[k:], cap_l))
    assert not (epid[k:] + 1).any() and not ehi[k:].any() \
        and not elo[k:].any()
    assert torch.unique(eslot[:k]).numel() == k
    assert int(eslot[:k].min()) >= 0 and int(eslot[:k].max()) < cap_l
    # Each placed lane whose slot is listed finds its key at that entry.
    entry = torch.full((cap_l + 1,), -1, dtype=torch.int64, device=cuda)
    entry[eslot[:k].long()] = torch.arange(k, device=cuda)
    e = entry[slot[placed].long()]
    listed = e >= 0
    assert listed.any()
    for lst, lane in ((epid, kpid), (ehi, khi), (elo, klo)):
        assert torch.equal(lst[e[listed]], lane[placed][listed])
    n_keys = torch.unique(torch.stack([kpid, khi, klo], 1)[live],
                          dim=0).shape[0]
    if n_keys > cap_l:  # the table fills up
        assert (live & ~placed).any() and (live & (want[0] < 0)).any()
        assert n == int(want[5][0]) == cap_l
        return
    assert torch.equal(placed, want[0] >= 0) and torch.equal(placed, live)
    assert n == int(want[5][0]) == n_keys
    if n > l_cap:  # the list keeps l_cap of the keys
        assert not listed.all()
        return
    assert listed.all()
    got_order = tpu.argsort3(epid, ehi, elo)
    want_order = tpu.argsort3(*want[1:4])
    for x, y in zip((epid, ehi, elo), want[1:4]):
        assert torch.equal(x[got_order], y[want_order])


def test_loc_table_kernel_base_none_equals_loc_base(cuda):
    """The kernel's own base hash: the -1 set and the sorted list equal
    those of a run given loc_base explicitly, and the explicit bases
    equal the plain ones."""
    keys = _loc_keys("spread", 6000, 3)
    kpid, khi, klo = (_t(np.ascontiguousarray(keys[:, j]), cuda)
                      for j in range(3))
    base = probe.loc_base(kpid, khi, klo)
    outs = [probe.build_loc_table(kpid, khi, klo, b, 1 << 12, 1 << 11)
            for b in (None, base)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0] >= 0, outs[1][0] >= 0)
    assert torch.equal(outs[0][5], outs[1][5])
    orders = [tpu.argsort3(*o[1:4]) for o in outs]
    for j in (1, 2, 3):
        assert torch.equal(outs[0][j][orders[0]], outs[1][j][orders[1]])


@pytest.mark.parametrize("dedup", ["hash", "sort"])
def test_tpu_aggregator_cuda_equals_cpu(cuda, dedup):
    snap = generate(SyntheticSpec(n_pids=60, n_unique_stacks=20_000,
                                  total_samples=200_000, n_funcs=64, seed=5))
    outs = {}
    for dev in ("cuda", "cpu"):
        agg = tpu.TPUAggregator(dedup=dedup, device=dev)
        outs[dev] = agg.window_outputs(snap)[1]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
