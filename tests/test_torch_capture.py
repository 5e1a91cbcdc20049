"""The port's host layers against parca_agent_tpu's, bit for bit: the
synthetic generator, the row hash, the first-seen fold, the snapshot file
format, and the numpy CPUAggregator that chip_smoke.py holds the card to."""

import io

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.cpu import CPUAggregator as JaxCPU
from parca_agent_tpu.capture import formats as jax_formats
from parca_agent_tpu.capture import synthetic as jax_synthetic
from parca_agent_tpu.ops import hashing as jax_hashing
from parca_agent_tpu.pprof.builder import build_pprof as jax_build_pprof
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.capture import formats
from parca_agent_tpu_torch.capture import synthetic
from parca_agent_tpu_torch.ops import hashing
from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof

torch.set_num_threads(1)

SPECS = [
    dict(n_pids=10, n_unique_stacks=300, seed=1),
    dict(n_pids=50, n_unique_stacks=2000, n_rows=1500, total_samples=50_000,
         kernel_fraction=0.5, seed=7),
    dict(n_pids=3, n_unique_stacks=100, mean_depth=60, n_funcs=16,
         mappings_per_pid=2, seed=42),
]


def _both(spec):
    return (synthetic.generate(synthetic.SyntheticSpec(**spec)),
            jax_synthetic.generate(jax_synthetic.SyntheticSpec(**spec)))


@pytest.mark.parametrize("spec", SPECS)
def test_generate_bit_identical(spec):
    a, b = _both(spec)
    for name in ("pids", "tids", "counts", "user_len", "kernel_len",
                 "stacks"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for name in ("pids", "starts", "ends", "offsets", "objs", "bases"):
        assert np.array_equal(getattr(a.mappings, name),
                              getattr(b.mappings, name)), name
    assert a.mappings.obj_paths == b.mappings.obj_paths
    assert a.mappings.obj_buildids == b.mappings.obj_buildids
    assert (a.period_ns, a.window_ns, a.time_ns) == \
        (b.period_ns, b.window_ns, b.time_ns)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("jax_native", [True, False])
def test_row_hash_bit_identical(spec, jax_native, monkeypatch):
    """Against both of parca_agent_tpu's hash paths: its native kernel and
    its numpy lane matrix (PARCA_NO_NATIVE_HASH=1)."""
    if not jax_native:
        monkeypatch.setenv("PARCA_NO_NATIVE_HASH", "1")
    a, _ = _both(spec)
    got = hashing.row_hash_np(a.stacks, a.pids, a.user_len, a.kernel_len,
                              n_hashes=3)
    want = jax_hashing.row_hash_np(a.stacks, a.pids, a.user_len,
                                   a.kernel_len, n_hashes=3)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and np.array_equal(g, w)


def test_hash_params_and_mix32_identical():
    for n in (1, 3, 4):
        for g, w in zip(hashing.hash_params(n, 128),
                        jax_hashing.hash_params(n, 128)):
            assert np.array_equal(g, w)
    x = np.random.default_rng(0).integers(0, 2**32, 1000,
                                          dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(hashing.mix32(x, 7), jax_hashing.mix32(x, 7))


def test_fold_rows_first_seen_identical():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, (500, 3)).astype(np.uint32)
    void = keys.view(np.dtype((np.void, 12))).ravel()
    w = rng.integers(1, 9, 500)
    got = formats.fold_rows_first_seen(void, w)
    want = jax_formats.fold_rows_first_seen(void, w)
    for g, x in zip(got, want):
        assert np.array_equal(g, x)


def test_snapshot_files_interchange():
    a, _ = _both(SPECS[1])
    buf = io.BytesIO()
    formats.save_snapshot(a, buf)
    blob = buf.getvalue()
    jbuf = io.BytesIO()
    jax_formats.save_snapshot(jax_formats.load_snapshot(io.BytesIO(blob)),
                              jbuf)
    assert jbuf.getvalue() == blob
    back = formats.load_snapshot(io.BytesIO(blob))
    assert np.array_equal(back.stacks, a.stacks)
    assert np.array_equal(back.mappings.bases, a.mappings.bases)


@pytest.mark.parametrize("spec", SPECS[:2])
def test_cpu_aggregator_pprof_identical(spec):
    a, b = _both(spec)
    got = CPUAggregator().aggregate(a)
    want = JaxCPU().aggregate(b)
    assert [build_pprof(p, compress=False) for p in got] == \
        [jax_build_pprof(p, compress=False) for p in want]
    parsed = parse_pprof(build_pprof(got[0]))
    assert sum(v[0] for _, v, _ in parsed.samples) == got[0].total()
