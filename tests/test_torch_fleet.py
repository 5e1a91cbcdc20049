"""The port's fleet merge against parca_agent_tpu's, bit for bit.

parca_agent_tpu's fleet programs run over a mesh of n of the 8 virtual
CPU devices (tests/conftest.py), the port's on the CPU with the node axis
as the leading dimension of one stream (the plain versions of the sketch
build and segment kernels). The same seeded streams go through both at
1, 2 and 8 nodes and an R that is not a power of two, with hashes at and
above 2^31, padding, all-padding streams and a dead node; every output
is compared exactly: the sketches and the total, the exact merges'
arrays and dtypes, the segment pass against the JAX program's own
outputs, the merged profiles (pprof bytes) and snapshot, and the errors.
The host copies (merge_mapping_tables, concat_snapshots,
filter_snapshot_rows, bounded_call) are held to their originals.
"""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.cpu import CPUAggregator as JaxCPU
from parca_agent_tpu.capture import formats as jax_formats
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.capture.synthetic import split_fleet
from parca_agent_tpu.ops import sketch as jax_sketch
from parca_agent_tpu.parallel import fleet as jax_fleet
from parca_agent_tpu.parallel.mesh import fleet_mesh as jax_mesh
from parca_agent_tpu.pprof.builder import build_pprof as jax_pprof
from parca_agent_tpu.utils.bounded import bounded_call as jax_bounded
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture import formats
from parca_agent_tpu_torch.ops import sketch
from parca_agent_tpu_torch.parallel import fleet
from parca_agent_tpu_torch.parallel.mesh import fleet_mesh
from parca_agent_tpu_torch.pprof.builder import build_pprof
from parca_agent_tpu_torch.utils.bounded import bounded_call

# One intra-op thread a process: the suite runs in several worker
# processes at once (see tests/test_torch_sharded.py).
torch.set_num_threads(1)

NODES = [1, 2, 8]
SEEDS = [0, 1, 2]
R = 301  # not a power of two


def _streams(seed: int, n: int, r: int = R, live_frac: float = 0.8):
    """[n, r] streams from a pool shared by the nodes (so groups cross
    nodes), a third of the hashes within 16 of 2^31 and some at
    0xFFFFFFFF, h2 with its top bit set on half the rows; padding rows
    (PAD_HASH, count 0) past live_frac of each node."""
    rng = np.random.default_rng(seed)
    pool1 = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    pool1[::3] = (np.uint32(2**31) - np.uint32(8)
                  + rng.integers(0, 16, len(pool1[::3])).astype(np.uint32))
    pool1[::17] = np.uint32(fleet.PAD_HASH)
    pool2 = rng.integers(0, 4, 512).astype(np.uint32) * np.uint32(0x5000_0001)
    h1 = np.full((n, r), fleet.PAD_HASH, np.uint32)
    h2 = np.full((n, r), fleet.PAD_HASH, np.uint32)
    c = np.zeros((n, r), np.int32)
    k = int(r * live_frac)
    for node in range(n):
        pick = rng.integers(0, len(pool1), k)
        h1[node, :k], h2[node, :k] = pool1[pick], pool2[pick]
        c[node, :k] = rng.integers(1, 100, k).astype(np.int32)
    return h1, h2, c


def _same(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


def _merges(h1, h2, c, n):
    mesh = jax_mesh(n)
    _same(jax_fleet.fleet_merge_sketches(h1, c, mesh=mesh),
          fleet.fleet_merge_sketches(h1, c, device="cpu"))
    _same(jax_fleet.fleet_merge_exact(h1, c, mesh=mesh),
          fleet.fleet_merge_exact(h1, c, device="cpu"))
    _same(jax_fleet.fleet_merge_exact64(h1, h2, c, mesh=mesh),
          fleet.fleet_merge_exact64(h1, h2, c, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", NODES)
def test_merges_equal_jax(seed, n):
    h1, h2, c = _streams(seed, n)
    assert (h1 >= 2**31).any() and (h1 < 2**31).any()
    _merges(h1, h2, c, n)


@pytest.mark.parametrize("n", [2, 8])
def test_merges_with_a_dead_node_equal_jax(n):
    h1, h2, c = _streams(5, n)
    h1[n // 2], h2[n // 2], c[n // 2] = fleet.PAD_HASH, fleet.PAD_HASH, 0
    _merges(h1, h2, c, n)
    # A dead node is the identity of every reduction.
    keep = np.arange(n) != n // 2
    a = fleet.fleet_merge_exact64(h1, h2, c, device="cpu")
    b = fleet.fleet_merge_exact64(h1[keep], h2[keep], c[keep], device="cpu")
    _same(a, b)


@pytest.mark.parametrize("n", NODES)
def test_all_padding_streams_equal_jax(n):
    h = np.full((n, 70), fleet.PAD_HASH, np.uint32)
    c = np.zeros((n, 70), np.int32)
    _merges(h, h, c, n)
    u1, u2, uc = fleet.fleet_merge_exact64(h, h, c, device="cpu")
    assert len(u1) == len(u2) == len(uc) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", NODES)
def test_segment_pass_equals_the_jax_programs(seed, n):
    """The sort + fleet_segment_plain's [:n_groups] against the JAX
    programs' own outputs (reps, sums, n_groups), 32- and 64-bit."""
    h1, h2, c = _streams(seed + 10, n)
    mesh = jax_mesh(n)
    r1, r2, sums, ng = jax_fleet._exact_program64(mesh)(
        jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(c))
    k = int(np.asarray(ng)[0])
    keys = fleet.keys64(torch.from_numpy(h1.view(np.int32)),
                        torch.from_numpy(h2.view(np.int32)))
    hi, lo, s, n_groups = fleet.fleet_segment(
        *fleet.sort_rows(keys, torch.from_numpy(c)), two_lanes=True)
    assert int(n_groups[0]) == k
    assert np.array_equal(hi[:k].numpy().view(np.uint32),
                          np.asarray(r1[0][:k]))
    assert np.array_equal(lo[:k].numpy().view(np.uint32),
                          np.asarray(r2[0][:k]))
    assert np.array_equal(s[:k].numpy(), np.asarray(sums[0][:k]))
    reps, sums, ng = jax_fleet._exact_program(mesh)(jnp.asarray(h1),
                                                     jnp.asarray(c))
    k = int(np.asarray(ng)[0])
    hi, lo, s, n_groups = fleet.fleet_segment(
        *fleet.sort_rows(fleet.keys32(torch.from_numpy(h1.view(np.int32))),
                         torch.from_numpy(c)), two_lanes=False)
    assert hi is None and int(n_groups[0]) == k
    assert np.array_equal(lo[:k].numpy().view(np.uint32),
                          np.asarray(reps[0][:k]))
    assert np.array_equal(s[:k].numpy(), np.asarray(sums[0][:k]))


@pytest.mark.parametrize("depth,width,p", [(1, 1 << 4, 4), (4, 1 << 18, 12),
                                           (8, 1 << 10, 18)])
@pytest.mark.parametrize("live", [None, "counts", "mask"])
def test_sketch_build_plain_equals_jax(depth, width, p, live):
    h1, _, c = _streams(3, 3)
    c[0, ::5] = 0  # dead rows among the live ones
    cm_spec, hll_spec = sketch.CountMinSpec(depth, width), sketch.HLLSpec(p)
    mask = np.random.default_rng(4).random(c.shape) < 0.7
    ht, ct = torch.from_numpy(h1.view(np.int32)), torch.from_numpy(c)
    arg = torch.from_numpy(mask) if live == "mask" else live
    cm, regs, totals = sketch.sketch_build(ht, ct, cm_spec, hll_spec, arg)
    flat_h, flat_c = h1.ravel(), c.ravel()
    want_live = {None: None, "counts": flat_c > 0,
                 "mask": mask.ravel()}[live]
    assert np.array_equal(cm.numpy(), jax_sketch.cm_build(
        flat_h, flat_c, jax_sketch.CountMinSpec(depth, width)))
    jax_regs = jax_sketch.hll_build(jnp.asarray(flat_h),
                                    jax_sketch.HLLSpec(p),
                                    live=None if want_live is None
                                    else jnp.asarray(want_live))
    assert np.array_equal(regs.numpy(), np.asarray(jax_regs))
    assert np.array_equal(totals.numpy(), c.sum(axis=1).astype(np.int32))
    # The one-sketch entries take the same paths.
    assert torch.equal(sketch.cm_build(ht, ct, cm_spec), cm)
    assert torch.equal(sketch.hll_build(
        ht, hll_spec, live=None if want_live is None
        else torch.from_numpy(want_live.reshape(c.shape))), regs)
    assert sketch.LAUNCHES["sketch_build"] == 0  # no kernel on the CPU


def test_sketch_build_rejects_what_it_cannot_take():
    h = torch.zeros((2, 8), dtype=torch.int32)
    spec = sketch.CountMinSpec()
    with pytest.raises(ValueError):
        sketch.sketch_build(h, None, None, None)
    with pytest.raises(ValueError):
        sketch.sketch_build(h, None, spec, None)
    with pytest.raises(ValueError):
        sketch.sketch_build(h, torch.zeros((2, 7), dtype=torch.int32), spec,
                            None)
    with pytest.raises(ValueError):
        sketch.sketch_build(h, None, None, sketch.HLLSpec(), "counts")
    with pytest.raises(ValueError):
        sketch.sketch_build(h.to(torch.int64), h, spec, None)


@pytest.mark.parametrize("bad", ["shape", "ndim", "negative", "overflow"])
def test_check_streams_errors_equal_jax(bad):
    h = np.zeros((2, 4), np.uint32)
    c = np.ones((2, 4), np.int32)
    if bad == "shape":
        c = np.ones((2, 5), np.int32)
    elif bad == "ndim":
        h, c = h[0], c[0]
    elif bad == "negative":
        c[1, 2] = -1
    else:
        c[:] = 2**28
    errors = []
    for fn in (jax_fleet._check_streams, fleet._check_streams):
        with pytest.raises(ValueError) as e:
            fn(h, c)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for merge in (fleet.fleet_merge_sketches, fleet.fleet_merge_exact):
        with pytest.raises(ValueError, match=errors[0][:20]):
            merge(h, c, device="cpu")


def test_the_mesh_is_not_capped_at_the_device_count():
    mesh = fleet_mesh(64, "cpu")
    assert mesh.n_nodes == 64 and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError):
        fleet_mesh(0, "cpu")
    h1, h2, c = _streams(0, 2)
    with pytest.raises(ValueError):
        fleet.fleet_merge_exact64(h1, h2, c, mesh=fleet_mesh(3, "cpu"))
    _same(fleet.fleet_merge_exact64(h1, h2, c, mesh=fleet_mesh(2, "cpu")),
          fleet.fleet_merge_exact64(h1, h2, c, device="cpu"))


# -- profiles and the host copies -------------------------------------------


def _port_table(t):
    return formats.MappingTable(
        pids=t.pids, starts=t.starts, ends=t.ends, offsets=t.offsets,
        objs=t.objs, obj_paths=t.obj_paths, obj_buildids=t.obj_buildids,
        bases=t.bases)


def _port_snap(w):
    return formats.WindowSnapshot(
        pids=w.pids, tids=w.tids, counts=w.counts, user_len=w.user_len,
        kernel_len=w.kernel_len, stacks=w.stacks,
        mappings=_port_table(w.mappings), period_ns=w.period_ns,
        window_ns=w.window_ns, time_ns=w.time_ns)


def _same_table(a, b) -> None:
    for f in ("pids", "starts", "ends", "offsets", "objs", "bases"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.obj_paths == b.obj_paths and a.obj_buildids == b.obj_buildids


def _same_snap(a, b) -> None:
    for f in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.period_ns, a.window_ns, a.time_ns) == (b.period_ns, b.window_ns,
                                                     b.time_ns)
    _same_table(a.mappings, b.mappings)


def _fleet_windows(seed: int, n: int, pids: int = 40, rows: int = 600):
    snap = jax_generate(JaxSpec(n_pids=pids, n_unique_stacks=rows,
                                n_rows=rows, total_samples=20_000,
                                seed=seed))
    ws = split_fleet(snap, n, dup_every=3, seed=seed + 1)
    return ws, [_port_snap(w) for w in ws]


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("assembly", [1, 8])
def test_fleet_merge_profiles_equal_jax(seed, n, assembly):
    jws, pws = _fleet_windows(seed, n)
    want, want_merged = jax_fleet.fleet_merge_profiles(
        jws, mesh=jax_mesh(n), aggregator=JaxCPU(), assembly_nodes=assembly)
    got, merged = fleet.fleet_merge_profiles(
        pws, aggregator=CPUAggregator(), assembly_nodes=assembly,
        device="cpu")
    _same_snap(want_merged, merged)
    assert [p.pid for p in got] == [p.pid for p in want]
    for a, b in zip(want, got):
        assert jax_pprof(a, compress=False) == build_pprof(b, compress=False)
    # The concat oracle (tests/test_fleet.py's), per pid.
    oracle = CPUAggregator().aggregate(formats.concat_snapshots(pws))
    assert [p.pid for p in oracle] == [p.pid for p in got]
    assert [int(p.values.sum()) for p in oracle] == \
        [int(p.values.sum()) for p in got]


def test_fleet_merge_profiles_with_an_empty_node_equal_jax():
    jws, pws = _fleet_windows(9, 3, pids=10, rows=120)
    empty = jax_formats.WindowSnapshot(
        pids=np.zeros(0, np.int32), tids=np.zeros(0, np.int32),
        counts=np.zeros(0, np.int64), user_len=np.zeros(0, np.int32),
        kernel_len=np.zeros(0, np.int32),
        stacks=np.zeros((0, 128), np.uint64),
        mappings=jax_formats.MappingTable.empty())
    want, wm = jax_fleet.fleet_merge_profiles(jws + [empty], mesh=jax_mesh(4))
    got, gm = fleet.fleet_merge_profiles(pws + [_port_snap(empty)],
                                         device="cpu")
    _same_snap(wm, gm)
    assert [jax_pprof(p, compress=False) for p in want] == \
        [build_pprof(p, compress=False) for p in got]


def test_stateful_aggregator_raises_type_error_as_jax():
    jws, pws = _fleet_windows(7, 2)
    with pytest.raises(TypeError) as got:
        fleet.fleet_merge_profiles(pws, aggregator=DictAggregator(
            capacity=1 << 12, device="cpu"), assembly_nodes=2, device="cpu")
    assert "DictAggregator" in str(got.value)
    assert str(got.value).startswith(
        "fleet_merge_profiles with assembly_nodes > 1 requires a stateless")
    with pytest.raises(ValueError):
        fleet.fleet_merge_profiles([], device="cpu")


@pytest.mark.parametrize("seed", [1, 2])
def test_merge_mapping_tables_equals_jax(seed):
    jws, pws = _fleet_windows(seed, 3, pids=12, rows=200)
    other = jax_generate(JaxSpec(n_pids=5, n_unique_stacks=16, n_rows=16,
                                 total_samples=100, seed=seed + 50))
    jt = [w.mappings for w in jws] + [other.mappings,
                                      jax_formats.MappingTable.empty()]
    _same_table(jax_formats.merge_mapping_tables(jt),
                formats.merge_mapping_tables([_port_table(t) for t in jt]))
    _same_table(jax_formats.merge_mapping_tables([]),
                formats.merge_mapping_tables([]))


def test_concat_and_filter_snapshots_equal_jax():
    jws, pws = _fleet_windows(3, 4, pids=12, rows=200)
    _same_snap(jax_formats.concat_snapshots(jws),
               formats.concat_snapshots(pws))
    mask = np.random.default_rng(0).random(len(jws[1])) < 0.5
    _same_snap(jax_formats.filter_snapshot_rows(jws[1], mask),
               formats.filter_snapshot_rows(pws[1], mask))
    for fn in (jax_formats.concat_snapshots, formats.concat_snapshots):
        with pytest.raises(ValueError):
            fn([])


def _outcome(fn, thunk, timeout):
    status, value, done, box = fn(thunk, timeout)
    return status, (type(value).__name__ if status == "err" else value)


def test_bounded_call_equals_jax():
    release = threading.Event()

    def slow():
        release.wait(5)
        raise KeyError("late")

    for thunk, timeout in ((lambda: 42, 5), (lambda: 1 / 0, 5)):
        assert _outcome(jax_bounded, thunk, timeout) == \
            _outcome(bounded_call, thunk, timeout)
    got = [fn(slow, 0.05) for fn in (jax_bounded, bounded_call)]
    assert [g[0] for g in got] == ["hang", "hang"]
    assert not any(g[2].is_set() for g in got)
    release.set()
    for _, _, done, box in got:
        assert done.wait(5) and isinstance(box["err"], KeyError)
    t0 = time.monotonic()
    status, *_ = bounded_call(lambda: time.sleep(10), 0.1)
    assert status == "hang" and time.monotonic() - t0 < 5
