"""The port's sketches (parca_agent_tpu_torch/ops/sketch.py) against
parca_agent_tpu/ops/sketch.py.

Item hashes and counts are made with numpy from a seed. numpy inputs go
through both packages' numpy paths; CPU tensors go through the port's
torch paths and the same values, as jax arrays, through the JAX package's
jnp paths on the CPU. Everything is an integer (or the estimator's float
from the same registers) and is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parca_agent_tpu.ops import sketch as jsk
from parca_agent_tpu_torch.ops import sketch as psk

# One intra-op thread a process: the suite runs in several worker
# processes at once, and torch's default of a thread a core in each
# oversubscribes the host, so that timing-bound tests in other workers
# (an encode pipeline busy at a window's close) take another path.
torch.set_num_threads(1)

SPECS = [(1, 1 << 4), (4, 1 << 10), (8, 1 << 18)]
PS = [4, 12, 18]


def _stream(seed: int, n: int = 5000):
    """uint32 item hashes with repeats, and int64 counts."""
    rng = np.random.default_rng(seed)
    uniq = rng.integers(0, 1 << 32, n // 3, dtype=np.uint64).astype(np.uint32)
    hashes = uniq[rng.integers(0, len(uniq), n)]
    hashes[:3] = (0, 0xFFFFFFFF, 1 << 31)  # the lanes' edges
    counts = rng.integers(1, 1000, n).astype(np.int64)
    return hashes, counts


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def test_seeds_and_specs_equal_jax():
    assert psk._ROW_SEEDS == jsk._ROW_SEEDS
    assert psk._HLL_SEED == jsk._HLL_SEED
    assert psk._MAX_DEPTH == jsk._MAX_DEPTH
    for d, w in SPECS:
        a, b = psk.CountMinSpec(d, w), jsk.CountMinSpec(d, w)
        assert (a.epsilon, a.delta) == (b.epsilon, b.delta)
    for p in PS:
        a, b = psk.HLLSpec(p), jsk.HLLSpec(p)
        assert (a.m, a.rel_error) == (b.m, b.rel_error)
    for bad in (dict(depth=0), dict(depth=9), dict(width=3)):
        with pytest.raises(ValueError):
            psk.CountMinSpec(**bad)
    for p in (3, 19):
        with pytest.raises(ValueError):
            psk.HLLSpec(p)


@pytest.mark.parametrize("depth,width", SPECS)
def test_count_min_numpy_paths_equal_jax(depth, width):
    h, c = _stream(depth * width)
    ps, js = psk.CountMinSpec(depth, width), jsk.CountMinSpec(depth, width)
    b = psk.cm_buckets(h, ps)
    assert b.dtype == np.int32
    assert np.array_equal(b, jsk.cm_buckets(h, js))
    t = psk.cm_build(h, c, ps)
    assert t.dtype == np.int32 and np.array_equal(t, jsk.cm_build(h, c, js))
    q = psk.cm_query(t, h, ps)
    assert np.array_equal(q, jsk.cm_query(t, h, js))
    t2 = psk.cm_build(h[::2], c[::2], ps)
    assert np.array_equal(psk.cm_merge(t, t2), jsk.cm_merge(t, t2))
    assert np.array_equal(psk.cm_sub(t, t2), jsk.cm_sub(t, t2))
    # cm_add into kept int64 tables, batch by batch.
    kp = np.zeros((depth, width), np.int64)
    kj = np.zeros((depth, width), np.int64)
    for lo in range(0, len(h), 1700):
        psk.cm_add(kp, h[lo:lo + 1700], c[lo:lo + 1700], ps)
        jsk.cm_add(kj, h[lo:lo + 1700], c[lo:lo + 1700], js)
    assert np.array_equal(kp, kj)
    assert np.array_equal(kp, t)  # in-place accumulation == one build
    assert np.all(psk.cm_query(kp, h, ps) >= c)


@pytest.mark.parametrize("depth,width", SPECS)
def test_count_min_torch_paths_equal_jax_jnp(depth, width):
    h, c = _stream(depth + width)
    ps, js = psk.CountMinSpec(depth, width), jsk.CountMinSpec(depth, width)
    b = psk.cm_buckets(_t(h), ps)
    assert b.dtype == torch.int32
    assert np.array_equal(b.numpy(), np.asarray(jsk.cm_buckets(
        jnp.asarray(h), js)))
    c32 = c.astype(np.int32)
    t = psk.cm_build(_t(h), _t(c32), ps)
    jt = np.asarray(jsk.cm_build(jnp.asarray(h), jnp.asarray(c32), js))
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), jt)
    q = psk.cm_query(t, _t(h), ps)
    assert np.array_equal(q.numpy(), np.asarray(jsk.cm_query(
        jnp.asarray(jt), jnp.asarray(h), js)))
    assert torch.equal(psk.cm_merge(t, t), t + t)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("masked", [False, True])
def test_hll_paths_equal_jax(p, masked):
    h, _ = _stream(p + 100 * masked)
    live = (np.arange(len(h)) % 3 != 0) if masked else None
    ps, js = psk.HLLSpec(p), jsk.HLLSpec(p)
    regs = psk.hll_build(h, ps, live)
    assert regs.dtype == np.int32
    assert np.array_equal(regs, jsk.hll_build(h, js, live))
    jr = np.asarray(jsk.hll_build(
        jnp.asarray(h), js, None if live is None else jnp.asarray(live)))
    tr = psk.hll_build(_t(h), ps, None if live is None
                       else torch.from_numpy(live))
    assert tr.dtype == torch.int32 and np.array_equal(tr.numpy(), jr)
    other = psk.hll_build(h[::5], ps)
    merged = psk.hll_merge(regs, other)
    assert np.array_equal(merged, jsk.hll_merge(regs, other))
    assert torch.equal(psk.hll_merge(tr, torch.from_numpy(other)),
                       torch.from_numpy(np.maximum(jr, other)))
    est = psk.hll_estimate(merged, ps)
    assert est == jsk.hll_estimate(merged, js)
    assert psk.hll_estimate(tr, ps) == jsk.hll_estimate(jr, js)
    n_live = len(np.unique(h if live is None else h[live]))
    assert abs(est - n_live) <= 0.5 * n_live  # a sane estimate


@pytest.mark.parametrize("p", PS)
def test_hll_estimate_edges_equal_jax(p):
    """Empty registers (linear counting) and saturated ones (raw)."""
    ps, js = psk.HLLSpec(p), jsk.HLLSpec(p)
    for regs in (np.zeros(ps.m, np.int32), np.full(ps.m, 7, np.int32),
                 np.arange(ps.m, dtype=np.int32) % 5):
        assert psk.hll_estimate(regs, ps) == jsk.hll_estimate(regs, js)
