"""The port's close programs against parca_agent_tpu's, bit for bit.

close_pack / close_pack_delta (parca_agent_tpu_torch/aggregator/dict.py)
must produce the same raw uint32 buffer as make_close / make_close_delta
(parca_agent_tpu/aggregator/dict.py) for the same accumulator, at every
packing width, including a sideband that overruns its buffer, a touched
population larger than the block buffer, mass outside the touched blocks
and mass past the fetched prefix (the guards the host retries on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import make_close, make_close_delta
from parca_agent_tpu_torch.aggregator.dict import close_pack, close_pack_delta

# One intra-op thread a process: the suite runs in several worker
# processes at once, and torch's default of a thread a core in each
# oversubscribes the host, so that timing-bound tests in other workers
# (an encode pipeline busy at a window's close) take another path.
torch.set_num_threads(1)

ID_CAP, N_FETCH, BLK = 4096, 2048, 128


def _acc(seed: int, width: int, n_big: int, tail_mass: bool):
    """An accumulator of small counts with `n_big` counts at or above the
    width's sentinel, zero past N_FETCH unless `tail_mass`."""
    rng = np.random.default_rng(seed)
    acc = np.where(rng.random(ID_CAP) < 0.3,
                   rng.integers(1, 15, ID_CAP), 0).astype(np.int32)
    big = rng.choice(N_FETCH, n_big, replace=False)
    acc[big] = rng.integers((1 << width) - 1, 1 << 20, n_big)
    # The sentinel's edges: one below packs in place, at and above it
    # goes to the sideband.
    edge = rng.choice(np.setdiff1d(np.arange(N_FETCH), big), 3,
                      replace=False)
    acc[edge] = (1 << width) - 2 + np.arange(3)
    if not tail_mass:
        acc[N_FETCH:] = 0
    return acc


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("overrun", [False, True])
def test_close_pack_matches_make_close(width, overrun):
    n_over_buf = 64
    acc = _acc(width, width, 100 if overrun else 40, tail_mass=overrun)
    want = np.asarray(make_close(ID_CAP, N_FETCH, width, n_over_buf)(
        jnp.asarray(acc)))
    got = close_pack(torch.from_numpy(acc), N_FETCH, width,
                     n_over_buf).numpy().view(np.uint32)
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)
    assert (int(got[-2]) > n_over_buf) == overrun  # n_over past the buffer
    assert (int(got[-1]) != 0) == overrun          # tail-mass guard


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("overrun", [False, True])
def test_close_pack_delta_matches_make_close_delta(width, overrun):
    n_over_buf, n_blk_buf = (16 if overrun else 32), 4
    nb_prefix = N_FETCH // BLK
    acc = _acc(width + 10, width, 150 if overrun else 8, tail_mass=overrun)
    rng = np.random.default_rng(width)
    # Touched blocks: more than n_blk_buf when overrunning (the host then
    # grows or falls back), and some massed blocks left untouched so the
    # untouched-mass guard is nonzero.
    n_touch = 7 if overrun else 3
    touch = np.zeros(ID_CAP // BLK, np.int32)
    touch[rng.choice(nb_prefix, n_touch, replace=False)] = 1
    if not overrun:
        # Exact case: every block with mass is touched, the guard is 0.
        blocks = acc[:N_FETCH].reshape(nb_prefix, BLK)
        keep = np.flatnonzero(touch[:nb_prefix])
        mask = np.zeros(nb_prefix, bool)
        mask[keep] = True
        blocks[~mask] = 0
    want = np.asarray(make_close_delta(ID_CAP, N_FETCH, width, n_over_buf,
                                       n_blk_buf, BLK)(
        jnp.asarray(acc), jnp.asarray(touch)))
    got = close_pack_delta(torch.from_numpy(acc), torch.from_numpy(touch),
                           N_FETCH, width, n_over_buf, n_blk_buf,
                           BLK).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert (int(got[-4]) > n_blk_buf) == overrun   # n_touched
    assert (int(got[-3]) > n_over_buf) == overrun  # n_over
    assert (int(got[-2]) != 0) == overrun          # untouched-mass guard
    assert (int(got[-1]) != 0) == overrun          # tail-mass guard


def _edge(edge: str, width: int, delta: bool):
    """(acc, touch, n_over_buf, n_blk_buf) of one buffer edge: exactly
    n_blk_buf touched blocks ("exact_touched"), exactly n_over_buf over
    ids ("exact_over"), no touched block in the prefix ("no_touched",
    flags past it only, mass left in the untouched blocks), an all-zero
    accumulator ("zero_acc")."""
    rng = np.random.default_rng(100 + width)
    nb_prefix, n_blk_buf = N_FETCH // BLK, 6
    acc = _acc(width + 20, width, 30, tail_mass=False)
    touch = np.zeros(ID_CAP // BLK, np.int32)
    touch[nb_prefix + 3] = 1  # past the prefix: counts for nothing
    n_touch = {"exact_touched": n_blk_buf, "no_touched": 0}.get(edge, 4)
    hit = rng.choice(nb_prefix, n_touch, replace=False)
    touch[hit] = 1
    if delta and edge != "no_touched":
        cold = np.ones(nb_prefix, bool)
        cold[hit] = False
        acc[:N_FETCH].reshape(nb_prefix, BLK)[cold] = 0
    if edge == "zero_acc":
        acc[:] = 0
    over = acc[:N_FETCH] >= (1 << width) - 1
    n_over = int(over.sum())
    n_over_buf = n_over if edge == "exact_over" else 64
    assert n_over_buf > 0 and (edge != "exact_over" or n_over > 0)
    return acc, touch, n_over_buf, n_blk_buf


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("edge", ["exact_over", "zero_acc"])
def test_close_pack_edges_match_make_close(width, edge):
    acc, _, n_over_buf, _ = _edge(edge, width, delta=False)
    want = np.asarray(make_close(ID_CAP, N_FETCH, width, n_over_buf)(
        jnp.asarray(acc)))
    got = close_pack(torch.from_numpy(acc), N_FETCH, width,
                     n_over_buf).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    n_over = int(got[-2])
    assert n_over == (n_over_buf if edge == "exact_over" else 0)


@pytest.mark.parametrize("width", [4, 8, 16])
@pytest.mark.parametrize("edge", ["exact_touched", "exact_over",
                                  "no_touched", "zero_acc"])
def test_close_pack_delta_edges_match_make_close_delta(width, edge):
    acc, touch, n_over_buf, n_blk_buf = _edge(edge, width, delta=True)
    want = np.asarray(make_close_delta(ID_CAP, N_FETCH, width, n_over_buf,
                                       n_blk_buf, BLK)(
        jnp.asarray(acc), jnp.asarray(touch)))
    got = close_pack_delta(torch.from_numpy(acc), torch.from_numpy(touch),
                           N_FETCH, width, n_over_buf, n_blk_buf,
                           BLK).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    n_touched, n_over, untouched = (int(x) for x in got[-4:-1])
    assert n_touched == {"exact_touched": n_blk_buf, "no_touched": 0}.get(
        edge, 4)
    if edge == "exact_over":
        assert n_over == n_over_buf
    if edge in ("no_touched", "zero_acc"):
        assert n_over == 0
    assert (untouched != 0) == (edge == "no_touched")
