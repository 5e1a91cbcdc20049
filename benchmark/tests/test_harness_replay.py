"""The replay: determinism by seed, mass conserved over the drains, the
churn's turnover."""

import json

import numpy as np
import pytest

from benchmark import manifest
from benchmark.manifest import HERE
from benchmark.replay import KERNEL_ADDR_START, SLOTS, Replay

# node-192's sizes (its cell waits for a later benchmark, so the file is
# read directly, not through BENCHMARK.json).
NODE = json.loads((HERE / "configs" / "node-192.json").read_text())
CFG = dict(NODE, pids=64, unique_stacks=1024, samples_per_window=6000)
STEADY = dict(manifest.traffic("steady"), pool_windows=2)
LONGTAIL = dict(manifest.traffic("longtail"), pool_windows=3)
# A churning mix (no cell runs one yet): 8 pids replaced a window, each
# with fresh stacks.
CHURN = {"name": "churn", "churn_pids_per_window": 8,
         "stacks_per_new_pid": 16, "pool_windows": 0, "ahead_windows": 3,
         "warm_windows": 1, "check_pids_per_window": 16}
SEED = 2**31 + 977


def _drains(replay, n):
    return [replay.window(w) for w in range(n)]


@pytest.mark.parametrize("mix", [STEADY, CHURN, LONGTAIL],
                         ids=["steady", "churn", "longtail"])
def test_same_seed_same_drains(mix):
    a = _drains(Replay(CFG, mix, SEED), 3)
    b = _drains(Replay(CFG, mix, SEED), 3)
    c = _drains(Replay(CFG, mix, SEED + 1), 3)
    for wa, wb in zip(a, b):
        assert np.array_equal(wa.check_pids, wb.check_pids)
        for da, db in zip(wa.drains, wb.drains):
            for x, y in zip(da, db):
                assert np.array_equal(x, y)
    assert any(len(x[5]) != len(y[5]) or not np.array_equal(x[5], y[5])
               for x, y in zip(a[1].drains, c[1].drains))


@pytest.mark.parametrize("mix", [STEADY, CHURN, LONGTAIL],
                         ids=["steady", "churn", "longtail"])
def test_drains_conserve_each_windows_mass(mix):
    replay = Replay(CFG, mix, SEED)
    for win in _drains(replay, 4):
        assert len(win.drains) == CFG["drains_per_window"]
        assert win.total == CFG["samples_per_window"]
        assert sum(int(d[5].sum()) for d in win.drains) == win.total
        per_row = {}
        for pids, tids, ulen, klen, stacks, counts in win.drains:
            assert (counts > 0).all()
            assert np.array_equal(pids, tids)
            keys = [(int(p), stacks[i, :ulen[i] + klen[i]].tobytes())
                    for i, p in enumerate(pids)]
            assert len(set(keys)) == len(keys)  # a drain's rows distinct
            for k, c in zip(keys, counts.tolist()):
                per_row[k] = per_row.get(k, 0) + c
        # Every live stack has a sample in every window, unless the mix
        # draws them all by weight.
        assert len(per_row) == win.rows
        assert (win.rows == CFG["unique_stacks"]) == mix.get(
            "every_stack_sampled", True)
        assert sum(per_row.values()) == win.total


def test_any_whole_seed():
    for seed in (0, 2**31 - 1, 2**31 + 5, 2**40, -3):
        assert Replay(CFG, STEADY, seed).window(0).total == \
            CFG["samples_per_window"]


def test_longtail_rows_come_and_go():
    replay = Replay(CFG, LONGTAIL, SEED)
    wins = [replay.window(w) for w in range(3)]
    sets = []
    for win in wins:
        rows = set()
        for d in win.drains:
            assert (d[5] > 0).all()
            rows |= {(int(p), bytes(s)) for p, s in zip(d[0], d[4])}
        assert len(rows) == win.rows < CFG["unique_stacks"]
        sets.append(rows)
    assert sets[0] != sets[1] and sets[1] != sets[2]
    assert len(sets[0] & sets[1]) > len(sets[0]) // 2
    cols = wins[0].columns
    assert len(cols[0]) == wins[0].rows and (cols[5] > 0).all()
    assert int(cols[5].sum()) == wins[0].total == CFG["samples_per_window"]


def test_stack_shape():
    replay = Replay(CFG, STEADY, SEED)
    depth = replay.ulen + replay.klen
    assert depth.max() <= CFG["max_depth"] and replay.ulen.min() >= 2
    assert replay.stacks.shape == (CFG["unique_stacks"], SLOTS)
    for i in range(0, CFG["unique_stacks"], 97):
        row = replay.stacks[i]
        u, k = int(replay.ulen[i]), int(replay.klen[i])
        assert (row[:u] < np.uint64(KERNEL_ADDR_START)).all()
        assert (row[u:u + k] >= np.uint64(KERNEL_ADDR_START)).all()
        assert (row[u + k:] == 0).all()
        pid = int(replay.pid_of_slot[replay.pid_slot[i]])
        maps = replay.maps[pid]
        assert all(any(m.start <= int(a) < m.end for m in maps)
                   for a in row[:u])
    kernel_share = float((replay.klen > 0).mean())
    assert abs(kernel_share - CFG["kernel_fraction"]) < 0.06


def test_churn_turnover():
    n = CHURN["churn_pids_per_window"]
    per = CFG["unique_stacks"] // CFG["pids"]
    replay = Replay(CFG, dict(CHURN, stacks_per_new_pid=per), SEED)
    w0 = replay.window(0)
    live0 = set(replay.pid_of_slot.tolist())
    keys0 = {(int(p), s.tobytes()) for d in w0.drains
             for p, s in zip(d[0], d[4])}
    w1 = replay.window(1)
    live1 = set(replay.pid_of_slot.tolist())
    assert len(live0 - live1) == n and len(live1 - live0) == n
    assert set(replay.retired) == live0 - live1
    born = live1 - live0
    assert min(born) > max(live0)          # fresh pid numbers
    assert live1 <= set(replay.maps)       # maps follow the population
    assert set(replay.retired) <= set(replay.maps)  # pids never reused
    keys1 = {(int(p), s.tobytes()) for d in w1.drains
             for p, s in zip(d[0], d[4])}
    fresh = keys1 - keys0
    assert len(fresh) == n * per           # new stacks: 1/8 at node scale
    assert {p for p, _ in fresh} == born
    assert len(set(w1.check_pids.tolist()) & born) >= 1


@pytest.mark.parametrize("mix", [dict(STEADY, pool_windows=3),
                                 dict(CHURN, ahead_windows=3)],
                         ids=["pool", "ahead"])
def test_drawn_at_set_up_or_as_it_goes_alike(mix):
    early = Replay(CFG, mix, SEED)
    early.prepare()
    late = Replay(CFG, dict(mix, ahead_windows=0), SEED)
    for w in range(5):
        a, b = early.window(w), late.window(w)
        assert np.array_equal(a.check_pids, b.check_pids)
        for da, db in zip(a.drains, b.drains):
            for x, y in zip(da, db):
                assert np.array_equal(x, y)
        if w == 0:
            assert a.columns is not None and b.columns is not None


def test_churn_needs_equal_shares():
    with pytest.raises(ValueError):
        Replay(dict(CFG, unique_stacks=1000), CHURN, SEED)


def test_node_drains_stay_under_the_map_cap():
    cfg = NODE
    replay = Replay(cfg, manifest.traffic("steady"), SEED)
    for w in range(2):
        rows = [len(d[0]) for d in replay.window(w).drains]
        assert max(rows) <= cfg["max_rows_per_drain"]
