"""The port dictionary's remaining constructor options against
parca_agent_tpu's.

DictAggregator takes ``id_cap``, ``cm_spec``, ``delta_fetch`` and
``coalesce`` with parca_agent_tpu's defaults. Every case feeds the same
seeded windows to the port's dictionary (on the CPU: the kernels' plain
versions) and to parca_agent_tpu's at one option value, as
tests/test_{feed_coalesce,close_overlap,feed_carry,aggregator_cpu}.py
set them: the counts, the id assignment, every packed close buffer
fetched, the sketch and the pprof bytes must be equal. NaiveAggregator,
the dictionary's oracle, is held against parca_agent_tpu's too.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.cpu import NaiveAggregator as JaxNaive
from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.ops.sketch import CountMinSpec as JaxCountMinSpec
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu_torch.aggregator.cpu import NaiveAggregator
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.ops.sketch import CountMinSpec
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder

torch.set_num_threads(1)


class _Kept:
    """Keeps every packed close buffer the dictionary fetched."""

    def _close_pack_collect(self, out_dev):
        host = super()._close_pack_collect(out_dev)
        self.fetched.append(np.array(host, np.uint32))
        return host


class PortDict(_Kept, DictAggregator):
    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)
        self.fetched = []


class JaxKeptDict(_Kept, JaxDict):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fetched = []


def _spec(seed, rows, pids, per_row=3, depth=8):
    return dict(n_pids=pids, n_unique_stacks=rows, n_rows=rows,
                total_samples=rows * per_row, mean_depth=depth, seed=seed)


def _dup(snap, dup=2):
    """Every row `dup` times: a drain the coalesce fold shrinks."""
    idx = np.repeat(np.arange(len(snap)), dup)
    return dataclasses.replace(
        snap, pids=snap.pids[idx],
        tids=np.arange(len(idx), dtype=np.int32),
        counts=snap.counts[idx], user_len=snap.user_len[idx],
        kernel_len=snap.kernel_len[idx], stacks=snap.stacks[idx])


def _snaps(seed, rows, pids, dup=2, **kw):
    """The same window in each package: (port snapshot, JAX snapshot)."""
    spec = _spec(seed, rows, pids, **kw)
    return (_dup(generate(SyntheticSpec(**spec)), dup),
            _dup(jax_generate(JaxSpec(**spec)), dup))


def _digest(blobs) -> str:
    h = hashlib.sha256()
    for pid, blob in sorted(blobs):
        h.update(str(pid).encode())
        h.update(bytes(blob))
    return h.hexdigest()


def _drive(port, jax, windows, drains=3):
    """Feed each (port, JAX) snapshot pair as `drains` chunks a window,
    close, encode; assert counts, ids and pprof bytes equal each window,
    and the fetched close buffers equal at the end."""
    enc, jenc = WindowEncoder(port), JaxEncoder(jax)
    for w, (snap, jsnap) in enumerate(windows):
        bounds = np.linspace(0, len(snap), drains + 1).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            port.feed(snap, lo=int(lo), hi=int(hi))
            jax.feed(jsnap, lo=int(lo), hi=int(hi))
        c = port.close_window(copy=True)
        jc = np.asarray(jax.close_window(copy=True))
        assert np.array_equal(c, jc), w
        assert port._key_to_id == jax._key_to_id, w
        args = (snap.time_ns + w, snap.window_ns, snap.period_ns)
        assert _digest(enc.encode(c, *args)) == \
            _digest(jenc.encode(jc, *args)), w
    assert len(port.fetched) == len(jax.fetched)
    for a, b in zip(port.fetched, jax.fetched):
        assert np.array_equal(a, np.asarray(b, np.uint32))


def test_defaults_are_parca_agent_tpus():
    agg, jax = DictAggregator(device="cpu"), JaxDict()
    assert agg._id_cap == jax._id_cap == agg._cap // 2
    assert agg._coalesce is jax._coalesce is True
    assert agg._blk == jax._blk == 128
    assert (agg._cm_spec.depth, agg._cm_spec.width) == \
        (jax._cm_spec.depth, jax._cm_spec.width)


@pytest.mark.parametrize("capacity", [1 << 12, 1 << 13, 1 << 17])
@pytest.mark.parametrize("coalesce", [False, True])
def test_coalesce_option_matches(capacity, coalesce):
    """coalesce=False dispatches every row; miss order, ids, counts,
    close buffers and pprof bytes stay those of parca_agent_tpu at the
    same option (and of the folded feed)."""
    snap, jsnap = _snaps(seed=capacity % 97, rows=600, pids=7)
    port = PortDict(capacity=capacity, overflow="raise", coalesce=coalesce)
    jax = JaxKeptDict(capacity=capacity, overflow="raise", coalesce=coalesce)
    _drive(port, jax, [(snap, jsnap)] * 3)
    st = port.stats
    if coalesce:
        assert st["coalesce_rows_out"] < st["coalesce_rows_in"]
    else:
        assert "coalesce_rows_in" not in st
    for k in ("coalesce_rows_in", "coalesce_rows_out", "inserts"):
        assert st.get(k, 0) == jax.stats.get(k, 0), k


def test_uncoalesced_feed_equals_the_folded_one():
    snap, _ = _snaps(seed=9, rows=500, pids=5, dup=3)
    a = DictAggregator(capacity=1 << 12, overflow="raise", device="cpu")
    b = DictAggregator(capacity=1 << 12, overflow="raise", device="cpu",
                       coalesce=False)
    for agg in (a, b):
        agg.feed(snap)
    assert np.array_equal(a.close_window(), b.close_window())
    assert a._key_to_id == b._key_to_id


def _hot_subset(snap, frac=8):
    """The window's first 1/frac rows: few touched id blocks, so the
    next close can take the delta path."""
    n = len(snap) // frac
    return dataclasses.replace(
        snap, pids=snap.pids[:n], tids=snap.tids[:n], counts=snap.counts[:n],
        user_len=snap.user_len[:n], kernel_len=snap.kernel_len[:n],
        stacks=snap.stacks[:n])


@pytest.mark.parametrize("delta_fetch", [False, True])
def test_delta_fetch_option_matches(delta_fetch):
    """delta_fetch=False: every close is the full pack, never the delta;
    with True the hot windows close by delta. Both equal parca_agent_tpu
    at the same option, buffer for buffer."""
    snap, jsnap = _snaps(seed=4, rows=4000, pids=40, dup=1)
    hot, jhot = _hot_subset(snap), _hot_subset(jsnap)
    port = PortDict(capacity=1 << 14, overflow="raise",
                    delta_fetch=delta_fetch)
    jax = JaxKeptDict(capacity=1 << 14, overflow="raise",
                      delta_fetch=delta_fetch)
    _drive(port, jax, [(snap, jsnap), (hot, jhot), (hot, jhot),
                       (hot, jhot)])
    deltas = port.stats.get("delta_closes", 0)
    assert deltas == jax.stats.get("delta_closes", 0)
    if delta_fetch:
        assert deltas >= 2 and port._blk == 128
    else:
        assert deltas == 0 and port._blk == 0


@pytest.mark.parametrize("id_cap", [600, 256])
def test_id_cap_off_the_block_grain_rotates_like_parca_agent_tpu(id_cap):
    """An id_cap that is no multiple of 128 (600) turns the delta close
    off; one that is (256) keeps it. With rotate_min_age=1 and more
    stacks than ids, the sketch absorbs and cold ids rotate: counts, ids,
    sketch state and pprof bytes equal parca_agent_tpu's window by
    window."""
    port = PortDict(capacity=1 << 12, id_cap=id_cap, rotate_min_age=1)
    jax = JaxKeptDict(capacity=1 << 12, id_cap=id_cap, rotate_min_age=1)
    assert port._blk == jax._blk == (0 if id_cap % 128 else 128)
    windows = [_snaps(seed=s, rows=400, pids=6, dup=1) for s in (1, 2, 1, 3)]
    _drive(port, jax, windows)
    assert port.sketch_info() == jax.sketch_info()
    assert np.array_equal(port._cm, np.asarray(jax._cm))
    assert port.stats.get("rotations", 0) == \
        jax.stats.get("rotations", 0) >= 1


def test_cm_spec_shapes_the_sketch_and_its_state():
    """A non-default CountMinSpec through overflow="sketch": the table,
    its estimates and export_state/load_state follow the instance's
    spec, never the module default."""
    spec = dict(depth=3, width=1 << 10)
    port = PortDict(capacity=1 << 10, id_cap=256,
                    cm_spec=CountMinSpec(**spec))
    jax = JaxKeptDict(capacity=1 << 10, id_cap=256,
                      cm_spec=JaxCountMinSpec(**spec))
    windows = [_snaps(seed=s, rows=500, pids=5, dup=1) for s in (5, 6)]
    _drive(port, jax, windows)
    assert port._cm.shape == (3, 1 << 10)
    assert np.array_equal(port._cm, np.asarray(jax._cm))
    h1 = port.hash_rows(windows[1][0])[0]
    assert np.array_equal(port.sketch_estimate(h1),
                          np.asarray(jax.sketch_estimate(h1)))
    state = port.export_state()
    again = DictAggregator(capacity=1 << 10, id_cap=256, device="cpu",
                           cm_spec=CountMinSpec(**spec))
    again.load_state(state)
    assert np.array_equal(again._cm, port._cm)
    default = DictAggregator(capacity=1 << 10, id_cap=256, device="cpu")
    with pytest.raises(ValueError, match="count-min table"):
        default.load_state(state)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_naive_aggregator_matches_parca_agent_tpus(seed):
    spec = dict(n_pids=5, n_unique_stacks=120, n_rows=300,
                total_samples=900, mean_depth=10, kernel_fraction=0.25,
                seed=seed)
    got = NaiveAggregator().aggregate(generate(SyntheticSpec(**spec)))
    want = JaxNaive().aggregate(jax_generate(JaxSpec(**spec)))
    assert [p.pid for p in got] == [p.pid for p in want]
    for g, w in zip(got, want):
        for f in ("stack_loc_ids", "stack_depths", "values", "loc_address",
                  "loc_normalized", "loc_mapping_id", "loc_is_kernel"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), f
        assert [dataclasses.astuple(m) for m in g.mappings] == \
            [dataclasses.astuple(m) for m in w.mappings]
        assert (g.period_ns, g.time_ns, g.duration_ns) == \
            (w.period_ns, w.time_ns, w.duration_ns)


def test_naive_aggregator_is_the_dictionarys_oracle():
    """The dictionary's window, built into profiles, holds the naive
    oracle's per-pid stack counts."""
    snap, _ = _snaps(seed=11, rows=300, pids=4, dup=2)
    agg = DictAggregator(capacity=1 << 11, overflow="raise", device="cpu",
                         coalesce=False)
    got = agg.aggregate(snap)
    want = NaiveAggregator().aggregate(snap)
    assert {p.pid: sorted(p.values.tolist()) for p in got} == \
        {p.pid: sorted(p.values.tolist()) for p in want}
