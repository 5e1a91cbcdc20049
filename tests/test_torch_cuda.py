"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: each test skips on a host without a CUDA device. This file
imports neither jax nor parca_agent_tpu, so it runs on a machine that has
neither; run it there with the repository's conftest left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from parca_agent_tpu_torch.aggregator import close, probe, sharded, tpu
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
    dc = DictAggregator(capacity=1 << 13, overflow="raise", device="cuda")
    dh = DictAggregator(capacity=1 << 13, overflow="raise", device="cpu")
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


def _close_case(seed: int, id_cap: int, n_fetch: int, width: int,
                n_big: int, tail: bool, blk_n: int = 0, n_touch: int = 0,
                untouched_mass: bool = False):
    """An accumulator of small counts with `n_big` counts at or above the
    width's sentinel (and the sentinel's edges), mass past n_fetch only
    when `tail` (7 x 2^30: the u32 guard wraps, to nonzero). With
    `n_touch`: touch flags (of `blk_n`) for that many of the prefix's
    128-id blocks, the big counts inside them, and mass in untouched
    prefix blocks only when `untouched_mass`."""
    rng = np.random.default_rng(seed)
    acc = np.where(rng.random(id_cap) < 0.3,
                   rng.integers(1, 15, id_cap), 0).astype(np.int32)
    acc[n_fetch:] = 0
    touch, cand = None, np.arange(n_fetch)
    if blk_n:
        nb_prefix = n_fetch // 128
        hit = np.sort(rng.choice(nb_prefix, n_touch, replace=False))
        touch = np.zeros(blk_n, np.int32)
        touch[hit] = rng.integers(1, 3, n_touch)
        if blk_n > nb_prefix:  # flags past the prefix count for nothing
            touch[nb_prefix + rng.choice(blk_n - nb_prefix, 2)] = 1
        if not untouched_mass:
            blocks = acc[:n_fetch].reshape(nb_prefix, 128)
            cold = np.ones(nb_prefix, bool)
            cold[hit] = False
            blocks[cold] = 0
        cand = (hit[:, None] * 128 + np.arange(128)).ravel()
    big = rng.choice(cand, n_big, replace=False)
    acc[big] = rng.integers((1 << width) - 1, 1 << 24, n_big)
    edge = rng.choice(np.setdiff1d(cand, big), 3, replace=False)
    acc[edge] = (1 << width) - 2 + np.arange(3)
    if tail:
        acc[n_fetch + rng.choice(id_cap - n_fetch, 7, replace=False)] = \
            1 << 30
    return acc, touch


# (id_cap, n_fetch): a prefix shorter than one tile of the kernel, the
# dictionary's shapes at id_cap 2^20 (n_fetch 2^18 and 2^20).
CLOSE_SHAPES = [(1 << 12, 1 << 11), (1 << 20, 1 << 18), (1 << 20, 1 << 20)]


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("id_cap,n_fetch", CLOSE_SHAPES)
@pytest.mark.parametrize("overrun", [False, True])
def test_close_pack_kernel_equals_plain(cuda, width, id_cap, n_fetch,
                                        overrun):
    """Every word of the full close buffer: the sideband overrun or not,
    the tail guard nonzero (and wrapping) or zero."""
    n_over_buf = 1 << 10
    acc, _ = _close_case(width + n_fetch, id_cap, n_fetch, width,
                         n_over_buf + 100 if overrun else n_over_buf // 2,
                         tail=overrun and id_cap > n_fetch)
    a = _t(acc, cuda)
    before = close.LAUNCHES["close_pack"]
    got = close.close_pack(a, n_fetch, width, n_over_buf)
    torch.cuda.synchronize()
    assert close.LAUNCHES["close_pack"] == before + 1
    want = close.close_pack_plain(a, n_fetch, width, n_over_buf)
    assert torch.equal(got, want)
    host = got.cpu().numpy().view(np.uint32)
    assert (int(host[-2]) > n_over_buf) == overrun
    if id_cap > n_fetch:
        assert (int(host[-1]) != 0) == overrun


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("id_cap,n_fetch", CLOSE_SHAPES)
@pytest.mark.parametrize("overrun", [False, True])
def test_close_pack_delta_kernel_equals_plain(cuda, width, id_cap, n_fetch,
                                              overrun):
    """Every word of the delta buffer: touched blocks past n_blk_buf (the
    sideband then counts the fetched blocks only), a sideband overrun,
    mass in untouched blocks and past n_fetch, or none of these."""
    nb_prefix = n_fetch // 128
    n_blk_buf = max(4, nb_prefix // 8)
    n_touch = n_blk_buf + 5 if overrun else n_blk_buf // 2
    n_over_buf = 64 if overrun else 1 << 12
    acc, touch = _close_case(width + n_fetch + 1, id_cap, n_fetch, width,
                             192, tail=overrun and id_cap > n_fetch,
                             blk_n=id_cap // 128, n_touch=n_touch,
                             untouched_mass=overrun)
    a, t = _t(acc, cuda), _t(touch, cuda)
    before = close.LAUNCHES["close_pack_delta"]
    got = close.close_pack_delta(a, t, n_fetch, width, n_over_buf, n_blk_buf,
                                 128)
    torch.cuda.synchronize()
    assert close.LAUNCHES["close_pack_delta"] == before + 1
    want = close.close_pack_delta_plain(a, t, n_fetch, width, n_over_buf,
                                        n_blk_buf, 128)
    assert torch.equal(got, want)
    host = got.cpu().numpy().view(np.uint32)
    assert (int(host[-4]) > n_blk_buf) == overrun
    assert (int(host[-3]) > n_over_buf) == overrun
    assert (int(host[-2]) != 0) == overrun
    if id_cap > n_fetch:
        assert (int(host[-1]) != 0) == overrun


def test_close_kernels_reject_what_they_cannot_pack(cuda):
    acc = torch.zeros(1 << 12, dtype=torch.int32, device=cuda)
    touch = torch.zeros(1 << 5, dtype=torch.int32, device=cuda)
    before = dict(close.LAUNCHES)
    with pytest.raises(ValueError, match="128-id blocks"):
        close.close_pack_delta(acc, touch[:16], 1 << 11, 8, 64, 4, 256)
    with pytest.raises(ValueError, match="multiple of"):
        close.close_pack(acc, 1 << 11 | 4, 4, 64)
    assert close.LAUNCHES == before


def _churn_windows(n_windows: int, hot: int, fresh: int, seed: int):
    """A pool of stacks and, per window, the first `hot` rows plus
    `fresh` rows whose leaf frame moved by a per-window offset (new
    stacks every window)."""
    import dataclasses

    pool = generate(SyntheticSpec(n_pids=40, n_unique_stacks=6000,
                                  n_rows=6000, total_samples=60_000,
                                  seed=seed))

    def rows(idx):
        return dataclasses.replace(
            pool, pids=pool.pids[idx], tids=pool.tids[idx],
            counts=pool.counts[idx], user_len=pool.user_len[idx],
            kernel_len=pool.kernel_len[idx], stacks=pool.stacks[idx])

    out = [rows(np.arange(4096))]
    for w in range(n_windows):
        f0 = hot + (w * fresh) % (6000 - hot - fresh)
        idx = np.concatenate([np.arange(hot), np.arange(f0, f0 + fresh)])
        snap = rows(idx)
        snap.stacks[hot:, 0] += np.uint64(4 * (w + 1))
        out.append(snap)
    return out


def test_dict_cm_cuda_equals_cpu(cuda):
    """overflow="sketch" on the card against the CPU, window by window,
    through absorption, rotation, delta closes and pid invalidation
    (immediate and deferred): counts, ids, the sketch tables and stats."""
    dc = DictAggregator(capacity=1 << 13, rotate_min_age=2, device="cuda")
    dh = DictAggregator(capacity=1 << 13, rotate_min_age=2, device="cpu")
    close.reset_launches()
    windows = _churn_windows(8, hot=600, fresh=200, seed=17)
    for w, snap in enumerate(windows):
        hashes = dh.hash_rows(snap)
        for d in (dc, dh):
            for lo in range(0, len(snap), 1000):
                d.feed(snap, hashes, lo=lo, hi=min(len(snap), lo + 1000))
        handles = [d.close_dispatch() for d in (dc, dh)]
        if w == 5:  # deferred: a close is in flight
            assert [d.invalidate_pid(1003) for d in (dc, dh)] == [False] * 2
        cc, ch = (d.close_collect(h) for d, h in zip((dc, dh), handles))
        assert np.array_equal(cc, ch)
        if w == 3:  # immediate, at a boundary
            assert [d.invalidate_pid(1001) for d in (dc, dh)] == [True] * 2
        assert dc._key_to_id == dh._key_to_id
        assert np.array_equal(dc._cm, dh._cm)
        assert np.array_equal(dc._over_hll, dh._over_hll)
        assert dc.sketch_info() == dh.sketch_info()
        assert dc.stats == dh.stats
    assert dc.stats["rotations"] >= 1 and dc.stats["sketch_rows"] > 0
    assert dc.stats["pid_invalidations"] == 2
    assert dc.stats.get("delta_closes", 0) >= 1
    assert close.LAUNCHES["close_pack"] >= 1
    assert close.LAUNCHES["close_pack_delta"] >= 1


def _close_equal(acc, touch, n_fetch, width, n_over_buf, n_blk_buf=0):
    """Launch the close kernel (delta when `touch` is given) once and
    hold every word against the plain version; returns the buffer (u32)."""
    if touch is None:
        got = close.close_pack(acc, n_fetch, width, n_over_buf)
        want = close.close_pack_plain(acc, n_fetch, width, n_over_buf)
    else:
        got = close.close_pack_delta(acc, touch, n_fetch, width, n_over_buf,
                                     n_blk_buf, 128)
        want = close.close_pack_delta_plain(acc, touch, n_fetch, width,
                                            n_over_buf, n_blk_buf, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("n_fetch", [1 << 23, 1 << 21])
@pytest.mark.parametrize("delta", [False, True])
def test_close_kernel_tiles_past_one_wave(cuda, n_fetch, delta):
    """id_cap 2^23: 2,048 tiles of 4,096 ids, more than the card holds at
    once, so tiles look back at tiles of an earlier wave."""
    id_cap = 1 << 23
    nb_prefix = n_fetch // 128
    acc, touch = _close_case(3 + n_fetch + delta, id_cap, n_fetch, 8, 5000,
                             tail=n_fetch < id_cap,
                             blk_n=id_cap // 128 if delta else 0,
                             n_touch=nb_prefix // 3 if delta else 0)
    _close_equal(_t(acc, cuda), None if touch is None else _t(touch, cuda),
                 n_fetch, 8, 1 << 12, nb_prefix // 2)


def test_close_kernel_back_to_back_calls_reuse_the_scratch(cuda):
    """1,000 calls queued on one stream, alternating the full and delta
    forms and two id_caps, with no sync between them: each call reuses its
    id_cap's cached scratch, its status records and its epoch."""
    cases = []
    for id_cap in (1 << 16, 1 << 18):
        n_fetch = id_cap // 2
        acc, touch = _close_case(id_cap, id_cap, n_fetch, 8, 300, tail=True,
                                 blk_n=id_cap // 128,
                                 n_touch=n_fetch // 128 // 4)
        a, t = _t(acc, cuda), _t(touch, cuda)
        n_blk_buf = n_fetch // 128 // 8  # the touched blocks overrun it
        cases.append((lambda a=a, n=n_fetch: close.close_pack(a, n, 8, 256),
                      close.close_pack_plain(a, n_fetch, 8, 256)))
        cases.append((lambda a=a, t=t, n=n_fetch, nb=n_blk_buf:
                      close.close_pack_delta(a, t, n, 8, 256, nb, 128),
                      close.close_pack_delta_plain(a, t, n_fetch, 8, 256,
                                                   n_blk_buf, 128)))
    order = [0, 2, 1, 3]  # full, full, delta, delta; two id_caps each
    differ = torch.zeros((), dtype=torch.bool, device=cuda)
    for i in range(1000):
        fn, want = cases[order[i % 4]]
        differ |= (fn() != want).any()
    assert not bool(differ)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert {k[2] for k in close._SCRATCH
            if k[1] == stream} >= {1 << 16, 1 << 18}


def test_close_kernel_on_a_second_stream(cuda):
    """A call on another CUDA stream takes a scratch of its own."""
    acc, touch = _close_case(7, 1 << 20, 1 << 20, 8, 2000, tail=False,
                             blk_n=1 << 13, n_touch=1500)
    a, t = _t(acc, cuda), _t(touch, cuda)
    want = close.close_pack_delta_plain(a, t, 1 << 20, 8, 4096, 4096, 128)
    close.close_pack_delta(a, t, 1 << 20, 8, 4096, 4096, 128)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = close.close_pack_delta(a, t, 1 << 20, 8, 4096, 4096, 128)
    side.synchronize()
    assert torch.equal(got, want)
    assert (cuda.index or 0, side.cuda_stream, 1 << 20) in {
        (k[0] or 0, k[1], k[2]) for k in close._SCRATCH}


def _close_edge(edge: str, width: int, delta: bool, id_cap: int = 1 << 20):
    """(acc, touch, n_over_buf, n_blk_buf) of one buffer edge at n_fetch =
    id_cap: exactly n_blk_buf touched blocks ("exact_touched"), exactly
    n_over_buf over ids ("exact_over"), no touched block ("no_touched",
    mass left in the untouched blocks), an all-zero accumulator
    ("zero_acc"), and the touched block of rank n_blk_buf in the middle of
    a tile ("mid_tile_cut": every other block touched, the cut at block
    32 * 5 + 16)."""
    rng = np.random.default_rng(200 + width)
    nb_prefix, n_blk_buf = id_cap // 128, 512
    acc = np.where(rng.random(id_cap) < 0.3,
                   rng.integers(1, 15, id_cap), 0).astype(np.int32)
    if edge == "mid_tile_cut":
        hit, n_blk_buf = np.arange(0, nb_prefix, 2), (32 * 5 + 16) // 2
    else:
        n_touch = {"exact_touched": n_blk_buf, "no_touched": 0}.get(edge,
                                                                   300)
        hit = np.sort(rng.choice(nb_prefix, n_touch, replace=False))
    touch = np.zeros(nb_prefix, np.int32)
    touch[hit] = 1
    if delta and edge != "no_touched":
        cold = np.ones(nb_prefix, bool)
        cold[hit] = False
        acc.reshape(nb_prefix, 128)[cold] = 0
    big = rng.choice(id_cap, 3000, replace=False)
    acc[big] = np.where(acc[big] > 0, rng.integers(
        (1 << width) - 1, 1 << 24, 3000), 0)
    if edge == "zero_acc":
        acc[:] = 0
    n_over = int((acc >= (1 << width) - 1).sum())
    if delta and edge == "exact_over":
        assert len(hit) <= n_blk_buf
    n_over_buf = n_over if edge == "exact_over" else 1 << 12
    return acc, (touch if delta else None), n_over_buf, n_blk_buf


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("edge,delta", [
    ("exact_over", False), ("zero_acc", False), ("exact_touched", True),
    ("exact_over", True), ("no_touched", True), ("zero_acc", True),
    ("mid_tile_cut", True)])
def test_close_kernel_buffer_edges(cuda, width, edge, delta):
    acc, touch, n_over_buf, n_blk_buf = _close_edge(edge, width, delta)
    host = _close_equal(_t(acc, cuda),
                        None if touch is None else _t(touch, cuda),
                        acc.shape[0], width, n_over_buf, n_blk_buf)
    n_over = int(host[-3] if delta else host[-2])
    if edge == "exact_over":
        assert n_over == n_over_buf > 0
    if edge in ("zero_acc", "no_touched"):
        assert n_over == 0
    if delta:
        assert int(host[-4]) == int((touch > 0).sum())
        assert (int(host[-2]) != 0) == (edge == "no_touched")
        if edge == "exact_touched":
            assert int(host[-4]) == n_blk_buf
        if edge == "mid_tile_cut":
            assert int(host[-4]) > n_blk_buf and 0 < n_over < n_over_buf


@pytest.mark.parametrize("overflow", ["raise", "sketch"])
def test_fast_path_cuda_bytes_equal_cpu(cuda, overflow):
    """The --fast-encode loop on the card (K1 feeds, B2 closes, then the
    window encoder, pipelined) writes, pid for pid, the bytes of its
    device="cpu" twin; across new stacks, and with dict+cm an
    invalidation's compaction and a rotation."""
    from parca_agent_tpu_torch.capture.replay import ReplaySource
    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler

    snaps = [generate(SyntheticSpec(n_pids=40, n_unique_stacks=n,
                                    n_rows=n, total_samples=20 * n,
                                    seed=s))
             for s, n in ((1, 2000), (2, 3000), (1, 2000), (3, 2500))]
    got = {}
    for dev in (cuda, "cpu"):
        agg = DictAggregator(
            capacity=1 << (13 if overflow == "sketch" else 14),
            overflow=overflow, rotate_min_age=2, device=dev)
        out = []

        class Writer:
            def write(self, labels, blob):
                out.append((labels["pid"], bytes(blob)))

        p = CPUProfiler(ReplaySource(snaps), agg, profile_writer=Writer())
        for w in range(len(snaps)):
            assert p.run_iteration()
            assert p.pipeline.flush(60)
            if w == 1:
                assert agg.invalidate_pid(int(snaps[0].pids[0]))
        assert not p.run_iteration()
        p.close()
        assert p.pipeline.stats["windows_pipelined"] == len(snaps)
        got[str(dev)] = (out, agg.registry_epoch)
    assert got[str(cuda)] == got["cpu"]
    assert got["cpu"][1] >= 1 and got["cpu"][0]


@pytest.mark.parametrize("overflow", ["raise", "sketch"])
def test_streamed_window_with_carry_cuda_equals_cpu(cuda, overflow):
    """Streamed windows (drains fed during the window, the carry cache on)
    on the card — K1 on each drain that dispatches rows, B2/B3 at each
    close — give the counts, ids, carry counters and pprof bytes of the
    same windows on device="cpu"; the steady windows carry."""
    import dataclasses

    from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
    from parca_agent_tpu_torch.profiler.streaming import (
        StreamingWindowFeeder,
    )

    class NoMaps:
        def executable_mappings(self, pid):
            return []

        def build_ids(self, per_pid):
            return {}

        def get(self, pid, m):
            return None

    base = generate(SyntheticSpec(n_pids=40, n_unique_stacks=3000,
                                  n_rows=3000, total_samples=60_000, seed=5))
    snaps = []
    for w in range(4):
        idx = np.arange(2000 + 250 * w)
        stacks = base.stacks[idx].copy()
        stacks[2000:, 0] += np.uint64(4 * w)  # new stacks each window
        snaps.append(dataclasses.replace(
            base, pids=base.pids[idx], tids=base.tids[idx],
            counts=base.counts[idx], user_len=base.user_len[idx],
            kernel_len=base.kernel_len[idx], stacks=stacks))

    class Source:
        def __init__(self, feeder):
            self._feeder, self._left = feeder, list(snaps)

        def poll(self):
            if not self._left:
                return None
            snap = self._left.pop(0)
            for lo in range(0, len(snap), 400):
                hi = min(lo + 400, len(snap))
                self._feeder.on_drain((
                    snap.pids[lo:hi], snap.tids[lo:hi],
                    snap.user_len[lo:hi], snap.kernel_len[lo:hi],
                    snap.stacks[lo:hi], snap.counts[lo:hi]))
            return snap

    got = {}
    probe.reset_launches()
    close.reset_launches()
    for dev in (cuda, "cpu"):
        agg = DictAggregator(capacity=1 << 13, overflow=overflow,
                             rotate_min_age=2, device=dev, carry=True)
        feeder = StreamingWindowFeeder(agg, NoMaps(), NoMaps())
        out, masses = [], []

        class Writer:
            def write(self, labels, blob):
                out.append((labels["pid"], bytes(blob)))

        p = CPUProfiler(Source(feeder), agg, profile_writer=Writer(),
                        streaming_feeder=feeder,
                        on_window=lambda r: masses.append(r["mass"]))
        while p.run_iteration():
            assert p.pipeline.flush(60)
        p.close()
        assert feeder.stats["windows_streamed"] == len(snaps)
        assert feeder.stats["windows_fallback"] == 0
        assert agg.stats.get("carry_fallbacks", 0) == 0
        assert agg.stats["carry_hits"] > 0
        got[str(dev)] = (out, masses, dict(agg._key_to_id),
                         {k: v for k, v in agg.stats.items()
                          if k.startswith("carry_")})
    assert probe.LAUNCHES["feed_accumulate"] >= len(snaps)
    assert close.LAUNCHES["close_pack"] >= 1
    assert got[str(cuda)] == got["cpu"]
    assert got["cpu"][1] == [s.total_samples() for s in snaps]


# -- the sharded dictionary: B7-feed and B7-close ----------------------------


def _sharded_case(n_shards: int, cap_s: int, layout: str, seed: int):
    """(table int32 [n_shards, cap_s, 4], part uint32 [n_shards, 5, n_pad_s])
    through the aggregator's own placement and partition. layout:
      spread   ~0.6 of every sub-table full; known, h1-only and unknown
               queries spread over the shards, some dead lanes
      one      every query's home is shard 0: the other shards get only
               pad lanes (empty shards), shard 0 every row
      chains   in each shard 20 keys sharing one h1 whose home is 3 slots
               before the sub-table's end (the chain wraps inside it);
               queries stop at steps 7, 8, 9, 15 (hits), 16, 17 (past the
               bound) and walk 20 slots (a miss past the bound)
      dead     every lane dead (count 0)"""
    agg = sharded.ShardedDictAggregator(capacity=n_shards * cap_s,
                                        n_shards=n_shards, device="cpu")
    rng = np.random.default_rng(seed)

    def put(keys):
        for k in map(tuple, keys.tolist()):
            slot = agg._try_insert_slot(k)
            if slot is None:
                continue
            agg._occ[slot] = True
            agg._h1[slot], agg._h2[slot], agg._h3[slot] = k
            agg._ids[slot] = int(agg._occ.sum()) - 1

    keys = rng.integers(0, 2**32, (int(0.6 * n_shards * cap_s), 3),
                        dtype=np.uint64).astype(np.uint32)
    if layout == "chains":
        keys = keys[:0]
        for s in range(n_shards):
            ch = rng.integers(0, 2**32, (20, 3), dtype=np.uint64).astype(
                np.uint32)
            ch[:, 0] = (ch[0, 0] & ~np.uint32(cap_s - 1)) + cap_s - 3
            ch[:, 1] = (ch[:, 1] // n_shards) * n_shards + s
            put(ch)
            keys = np.concatenate([keys, ch])
        stop_at = [7, 8, 9, 15, 16, 17]
        q = np.concatenate([keys.reshape(n_shards, 20, 3)[:, stop_at]
                            .reshape(-1, 3), keys[::20]])
        q[-n_shards:, 2] ^= 1  # same h1 and home, unknown: walks 20
    else:
        put(keys)
        nq = 3 * cap_s
        known = keys[rng.integers(0, len(keys), nq // 2)]
        h1_only = keys[rng.integers(0, len(keys), nq // 4)].copy()
        h1_only[:, 2] ^= 1
        unknown = rng.integers(0, 2**32, (nq - len(known) - len(h1_only), 3),
                               dtype=np.uint64).astype(np.uint32)
        q = np.concatenate([known, h1_only, unknown])
        q = q[rng.permutation(len(q))]
        if layout == "one":
            q[:, 1] = (q[:, 1] // n_shards) * n_shards
    agg._ensure_device()
    n_pad = 1 << max(4, (len(q) - 1).bit_length())
    packed = np.zeros((4, n_pad), np.uint32)
    packed[:3, :len(q)] = q.T
    packed[3, :len(q)] = rng.integers(0 if layout == "spread" else 1, 6,
                                      len(q))
    if layout == "dead":
        packed[3] = 0
    return agg._dev.numpy(), agg._partition_packed(packed)


@pytest.mark.parametrize("n_shards,cap_s,layout", [
    (8, 1 << 10, "spread"), (8, 1 << 12, "one"), (1, 1 << 12, "spread"),
    (2, 1 << 8, "chains"), (8, 1 << 6, "chains"), (4, 1 << 8, "dead")])
@pytest.mark.parametrize("reset", [False, True])
def test_sharded_feed_kernel_equals_plain(cuda, n_shards, cap_s, layout,
                                          reset):
    """B7-feed against sharded_feed_step_plain on the same card tensors:
    found ids, the accumulator, each shard's miss count and ordered miss
    rows, at empty shards, a shard holding every row, chains at the
    probe bound (wrapping inside the sub-table) and all-dead lanes."""
    table, part = _sharded_case(n_shards, cap_s, layout, cap_s + n_shards)
    tab, prt = _t(table, cuda), _t(part, cuda)
    # Ids run past id_cap (dropped, as mode="drop") only in "spread".
    id_cap = n_shards * cap_s // (2 if layout == "spread" else 1)
    acc0 = torch.randint(0, 9, (n_shards, id_cap), dtype=torch.int32,
                         device=cuda)
    before = sharded.LAUNCHES["sharded_feed"]
    outs = []
    for fn in (sharded.sharded_feed_step, sharded.sharded_feed_step_plain):
        acc = acc0.clone()
        outs.append((acc, *fn(tab, acc, prt, reset)))
    torch.cuda.synchronize()
    assert sharded.LAUNCHES["sharded_feed"] == before + 1
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    found = [sharded.sharded_feed_accumulate(tab, acc0.clone(), prt),
             sharded.sharded_feed_accumulate_plain(tab, acc0.clone(), prt)]
    assert torch.equal(*found)
    n_miss = outs[0][1].cpu().numpy()
    if layout == "one":
        assert n_miss[1:].sum() == 0 and n_miss[0] > 0
    if layout == "chains":
        f = found[0].cpu().numpy()
        live = part[:, 3] > 0
        assert ((f >= 0) & live).sum(1).tolist() == [4] * n_shards
    if layout == "dead":
        assert n_miss.sum() == 0 and (found[0] < 0).all()
        assert torch.equal(outs[0][0], acc0 if not reset else acc0 * 0)


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("n_shards,id_cap,n_fetch", [
    (1, 1 << 12, 1 << 11), (2, 1 << 12, 1 << 12), (8, 1 << 20, 1 << 18),
    (8, (1 << 12) + 4, 1 << 12)])
@pytest.mark.parametrize("overrun", [False, True])
def test_close_pack_sharded_kernel_equals_plain(cuda, width, n_shards,
                                                id_cap, n_fetch, overrun):
    """B7-close against close_pack_sharded_plain: every word, with and
    without a sideband overrun and tail mass, a shard sum that wraps
    int32, and a row stride that is not a multiple of 4 ids; one shard
    is B2's buffer."""
    rng = np.random.default_rng(width + n_shards + id_cap)
    # Small counts stay below the sentinel once summed over the shards.
    small = rng.integers(1, max(2, 15 // n_shards), (n_shards, id_cap))
    acc = np.where(rng.random((n_shards, id_cap)) < 0.3, small,
                   0).astype(np.int32)
    n_over_buf = 1 << 8
    n_big = n_over_buf + 50 if overrun else n_over_buf // 2
    big = rng.choice(n_fetch, n_big, replace=False)
    acc[rng.integers(0, n_shards, n_big), big] = rng.integers(
        (1 << width) - 1, 1 << 24, n_big)
    if overrun:
        acc[0, 5] = 2**31 - 1
        acc[-1, 5] = 7 if n_shards > 1 else acc[-1, 5]
        if id_cap > n_fetch:
            acc[:, n_fetch:] = 3
    a = _t(acc, cuda)
    before = close.LAUNCHES["close_pack_sharded"]
    got = close.close_pack_sharded(a, n_fetch, width, n_over_buf)
    torch.cuda.synchronize()
    assert close.LAUNCHES["close_pack_sharded"] == before + 1
    want = close.close_pack_sharded_plain(a, n_fetch, width, n_over_buf)
    assert torch.equal(got, want)
    host = got.cpu().numpy().view(np.uint32)
    assert (int(host[-2]) > n_over_buf) == overrun
    if n_shards == 1:
        assert torch.equal(got, close.close_pack(a[0], n_fetch, width,
                                                 n_over_buf))


def test_sharded_aggregator_cuda_equals_cpu(cuda):
    """ShardedDictAggregator on the card and on the CPU: counts, ids and
    the host mirror after three windows of two feeds; every feed
    launches B7-feed, every close B7-close."""
    snap = generate(SyntheticSpec(n_pids=30, n_unique_stacks=3000,
                                  total_samples=50_000, seed=9))
    dc = sharded.ShardedDictAggregator(capacity=1 << 13, n_shards=8,
                                       overflow="raise", device="cuda")
    dh = sharded.ShardedDictAggregator(capacity=1 << 13, n_shards=8,
                                       overflow="raise", device="cpu")
    sharded.reset_launches()
    before = close.LAUNCHES["close_pack_sharded"]
    for _ in range(3):
        hashes = dh.hash_rows(snap)
        for d in (dc, dh):
            d.feed(snap, hashes, hi=1000)
            d.feed(snap, hashes, lo=1000)
        assert np.array_equal(dc.close_window(), dh.close_window())
    assert sharded.LAUNCHES["sharded_feed"] == 6
    assert close.LAUNCHES["close_pack_sharded"] == before + 3
    assert dc._key_to_id == dh._key_to_id
    assert np.array_equal(dc._ids, dh._ids)
    assert torch.equal(dc._dev.cpu(), dh._dev)
