"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: each test skips on a host without a CUDA device. This file
imports neither jax nor parca_agent_tpu, so it runs on a machine that has
neither; run it there with the repository's conftest left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from parca_agent_tpu_torch.aggregator import probe
from parca_agent_tpu_torch.aggregator.dict import DictAggregator, feed_step
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate

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
