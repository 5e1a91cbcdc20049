"""The port's batch probe and feed step against the JAX package.

Inputs are made with numpy from a seed and handed to both sides: the
port's plain PyTorch versions (aggregator/probe.py, dict.feed_step) and
parca_agent_tpu's Pallas probe (interpret mode, as its own tests run it on
the CPU), its lax probe loop inside make_feed, and make_feed itself.
Everything compared here is an integer, compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import _PROBES, make_feed
from parca_agent_tpu.aggregator.pallas_probe import make_batch_probe
from parca_agent_tpu_torch.aggregator import probe
from parca_agent_tpu_torch.aggregator.dict import feed_step


def _table_and_queries(seed: int, cap: int, n_query: int):
    """A table filled to ~1/4 by linear probing, with a chain longer than
    the probe bound (forced same home slot), keys that share h1 with a
    stored key but differ in h2 or h3, and queries over stored keys,
    h1-only collisions and unknown keys (which stop on empty slots)."""
    rng = np.random.default_rng(seed)
    n_keys = cap // 4
    keys = rng.integers(0, 2**32, size=(n_keys, 3), dtype=np.uint64)
    chain = _PROBES + 4
    keys[1:1 + chain, 0] = keys[0, 0]  # one home slot, chain past the bound
    table = np.zeros((cap, 4), np.uint32)
    for sid, (a, b, c) in enumerate(keys):
        idx = int(a) & (cap - 1)
        while table[idx, 3]:
            idx = (idx + 1) & (cap - 1)
        table[idx] = (a, b, c, sid + 1)
    h1_only = keys[rng.integers(0, n_keys, n_query // 4)].copy()
    h1_only[:, 1 + (np.arange(len(h1_only)) % 2)] ^= np.uint64(0x5A5A5A5A)
    unknown = rng.integers(0, 2**32, size=(n_query // 4, 3), dtype=np.uint64)
    known = keys[rng.integers(0, n_keys, n_query - 2 * (n_query // 4))]
    q = np.concatenate([keys[:1 + chain], known, h1_only, unknown])[:n_query]
    q = q[rng.permutation(len(q))].astype(np.uint32)
    return table, q[:, 0].copy(), q[:, 1].copy(), q[:, 2].copy()


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 torch tensor of the same bits (the port's
    boundary cast)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


CASES = [(seed, cap) for seed in (0, 1) for cap in (1 << 8, 1 << 10, 1 << 12)]


@pytest.mark.parametrize("seed,cap", CASES)
def test_batch_probe_matches_pallas_interpret(seed, cap):
    table, h1, h2, h3 = _table_and_queries(seed, cap, 2 * cap)
    got = probe.batch_probe(_t(table), _t(h1), _t(h2), _t(h3)).numpy()
    want = np.asarray(make_batch_probe(cap, _PROBES, interpret=True)(
        table, h1, h2, h3))
    assert np.array_equal(got, want)
    # The inputs reach every branch: hits, misses, and a chain tail past
    # the probe bound that a stored key still misses on.
    assert (got >= 0).any() and (got == -1).any()
    stored = {tuple(r[:3]): int(r[3]) - 1 for r in table if r[3]}
    bound_miss = [i for i in range(len(h1))
                  if (h1[i], h2[i], h3[i]) in stored and got[i] == -1]
    assert bound_miss


@pytest.mark.parametrize("seed,cap", CASES)
def test_batch_probe_matches_lax_feed_loop(seed, cap):
    """The lax loop inside make_feed shows its probe result through what
    the feed does with it: every live row's count lands at its found id,
    every live row without one is a miss, in row order."""
    table, h1, h2, h3 = _table_and_queries(seed, cap, 2 * cap)
    n = len(h1)
    found = probe.batch_probe(_t(table), _t(h1), _t(h2), _t(h3)).numpy()
    id_cap = cap // 2
    packed = np.stack([h1, h2, h3, np.ones(n, np.uint32)])
    acc, _touch, n_miss, miss_rows = make_feed(cap, id_cap, n)(
        jnp.asarray(table), jnp.zeros(id_cap, jnp.int32),
        jnp.zeros(1, jnp.int32), jnp.asarray(packed), jnp.uint32(1))
    hit = found >= 0
    assert np.array_equal(np.asarray(acc),
                          np.bincount(found[hit], minlength=id_cap))
    assert int(n_miss) == int((~hit).sum())
    assert np.array_equal(np.asarray(miss_rows)[:int(n_miss)],
                          np.flatnonzero(~hit))


FEED_CASES = [(seed, reset, blk) for seed in (2, 3) for reset in (0, 1)
              for blk in (0, 128)]


@pytest.mark.parametrize("seed,reset,blk", FEED_CASES)
def test_feed_step_matches_make_feed(seed, reset, blk):
    cap = 1 << 10
    id_cap = cap // 2
    n_blocks = id_cap // blk if blk else 0
    table, h1, h2, h3 = _table_and_queries(seed, cap, 700)
    rng = np.random.default_rng(seed + 100)
    n_pad = 1024
    cnt = rng.integers(0, 50, len(h1)).astype(np.uint32)  # 0 = dead row
    packed = np.zeros((4, n_pad), np.uint32)
    packed[0, :len(h1)], packed[1, :len(h1)] = h1, h2
    packed[2, :len(h1)], packed[3, :len(h1)] = h3, cnt
    # The previous window's mass: kept unless this feed resets it.
    acc0 = rng.integers(0, 1000, id_cap).astype(np.int32)
    touch0 = (rng.random(max(n_blocks, 1)) < 0.3).astype(np.int32)

    j_acc, j_touch, j_nm, j_rows = make_feed(cap, id_cap, n_pad, n_blocks,
                                             blk)(
        jnp.asarray(table), jnp.asarray(acc0), jnp.asarray(touch0),
        jnp.asarray(packed), jnp.uint32(reset))

    acc = torch.from_numpy(acc0.copy())
    touch = torch.from_numpy(touch0.copy()) if blk else None
    nm, rows = feed_step(_t(table), acc, touch, blk,
                         torch.from_numpy(packed.view(np.int32)), bool(reset))
    assert np.array_equal(acc.numpy(), np.asarray(j_acc))
    if blk:
        assert np.array_equal(touch.numpy(), np.asarray(j_touch))
    assert int(nm) == int(j_nm) > 0
    assert np.array_equal(rows.numpy(), np.asarray(j_rows))


def test_probe_wrappers_reject_bad_inputs():
    table = torch.zeros((64, 4), dtype=torch.int32)
    lane = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        probe.batch_probe(torch.zeros((48, 4), dtype=torch.int32),
                          lane, lane, lane)
    with pytest.raises(ValueError):
        probe.batch_probe(table, lane.to(torch.int64), lane, lane)
    with pytest.raises(ValueError):
        probe.feed_accumulate(table, torch.zeros(32, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 0,
                              lane, lane, lane, lane)


def test_plain_versions_count_no_launches():
    probe.reset_launches()
    table, h1, h2, h3 = _table_and_queries(5, 1 << 8, 64)
    probe.batch_probe(_t(table), _t(h1), _t(h2), _t(h3))
    probe.feed_accumulate(_t(table), torch.zeros(128, dtype=torch.int32),
                          None, 0, _t(h1), _t(h2), _t(h3),
                          _t(np.ones(len(h1), np.uint32)))
    probe.build_loc_table(_t(h1), _t(h2), _t(h3), _t(h1), 1 << 8,
                          1 << 7)
    assert probe.LAUNCHES == {"batch_probe": 0, "feed_accumulate": 0,
                              "loc_table": 0}
