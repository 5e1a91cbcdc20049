"""The port's host C++ layer (parca_agent_tpu_torch/native/vecenc.cc)
against parca_agent_tpu's and against the port's own numpy versions.

The row hash of the port (its native pass, and the numpy lane matrix
asked for with impl="numpy") must give parca_agent_tpu's bits on both of
that package's paths (its native kernel, and its numpy path pinned by
PARCA_NO_NATIVE_HASH=1). The varint passes and the ragged copy must give
the same bytes as parca_agent_tpu's pprof/vec.py, on the cases of
tests/test_vec_native.py, and raise on the same bad callers. The build
itself: the library lands under parca_agent_tpu_torch/build/, a failed
build raises (no numpy fallback), and four processes building at once
leave one loadable library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.ops import hashing as jax_hashing
from parca_agent_tpu.pprof import vec as jax_vec
from parca_agent_tpu_torch import native
from parca_agent_tpu_torch.capture.formats import STACK_SLOTS
from parca_agent_tpu_torch.ops import hashing
from parca_agent_tpu_torch.pprof import vec

# One intra-op thread a process, as the other port test files.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _rows(seed: int, n: int = 600):
    """Snapshot-contract rows: frames live up to user_len + kernel_len,
    zero past it; depths 0 and 127 and pids 0 and 2^31-1 included."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 128, n)
    depth[:3] = (0, 127, 1)
    ulen = (depth * rng.random(n)).astype(np.int32)
    klen = (depth - ulen).astype(np.int32)
    stacks = np.zeros((n, STACK_SLOTS), np.uint64)
    live = np.arange(STACK_SLOTS)[None, :] < depth[:, None]
    stacks[live] = rng.integers(1, 2**64 - 1, int(live.sum()),
                                dtype=np.uint64)
    # A zero frame inside the live prefix contributes nothing either way.
    stacks[5, 0] = 0
    pids = rng.integers(0, 2**31, n).astype(np.int32)
    pids[:3] = (0, 2**31 - 1, 0)
    return stacks, pids, ulen, klen


# -- the row hash -------------------------------------------------------------


@pytest.mark.parametrize("jax_path", ["native", "numpy"])
@pytest.mark.parametrize("n_hashes", [1, 2, 3, 4])
def test_row_hash_equals_jax_on_both_of_its_paths(monkeypatch, n_hashes,
                                                  jax_path):
    stacks, pids, ulen, klen = _rows(n_hashes)
    if jax_path == "numpy":
        monkeypatch.setenv("PARCA_NO_NATIVE_HASH", "1")
    else:
        monkeypatch.delenv("PARCA_NO_NATIVE_HASH", raising=False)
        if not jax_hashing.native_hash_available():
            pytest.skip("parca_agent_tpu's native row hash did not build")
    want = jax_hashing.row_hash_np(stacks, pids, ulen, klen, n_hashes)
    got = hashing.row_hash_np(stacks, pids, ulen, klen, n_hashes)
    assert len(got) == len(want) == n_hashes
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_hashes", [1, 2, 3, 4])
def test_row_hash_native_equals_its_numpy_version(n_hashes):
    stacks, pids, ulen, klen = _rows(10 + n_hashes)
    native_h = hashing.row_hash_np(stacks, pids, ulen, klen, n_hashes)
    plain = hashing.row_hash_np(stacks, pids, ulen, klen, n_hashes,
                                impl="numpy")
    for a, b in zip(native_h, plain):
        np.testing.assert_array_equal(a, b)


def test_row_hash_takes_strided_rows_and_rejects_bad_arguments():
    stacks, pids, ulen, klen = _rows(20)
    sel = np.arange(0, len(pids), 3)
    got = hashing.row_hash_np(stacks[sel], pids[sel], ulen[sel], klen[sel],
                              3)
    want = hashing.row_hash_np(stacks[sel], pids[sel], ulen[sel], klen[sel],
                               3, impl="numpy")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    empty = hashing.row_hash_np(stacks[:0], pids[:0], ulen[:0], klen[:0], 2)
    assert [len(h) for h in empty] == [0, 0]
    with pytest.raises(ValueError):
        hashing.row_hash_np(stacks, pids, ulen, klen, 5)
    with pytest.raises(ValueError):
        hashing.row_hash_np(stacks, pids, ulen, klen, 2, impl="jnp")
    with pytest.raises(ValueError):
        hashing.row_hash_np(stacks, pids[:-1], ulen, klen, 2)
    assert hashing.native_hash_available()


# -- varint passes (the cases of tests/test_vec_native.py) --------------------


def _jax_numpy_only(monkeypatch):
    monkeypatch.setattr(jax_vec, "_native", None)


@pytest.mark.parametrize("maxv", [2, 128, 4000, 1 << 40, None])
def test_varint_passes_equal_jax_and_numpy(monkeypatch, maxv):
    rng = np.random.default_rng(3)
    hi = np.iinfo(np.uint64).max if maxv is None else maxv
    vals = rng.integers(0, hi, 4096, dtype=np.uint64)

    def run(mod, **kw):
        lens = mod.varint_len(vals, **kw)
        pos = np.zeros(len(vals), np.int64)
        np.cumsum(lens[:-1], out=pos[1:])
        out = np.zeros(int(pos[-1] + lens[-1]), np.uint8)
        mod.put_varints(out, pos, vals, lens, **kw)
        pad = np.zeros(len(vals) * 10, np.uint8)
        mod.put_varints_padded(pad, np.arange(len(vals), dtype=np.int64) * 10,
                               vals, 10, **kw)
        stream, offs = mod.encode_varint_stream(vals, **kw)
        return lens, out, pad, stream, offs

    results = [run(vec), run(vec, impl="numpy"), run(jax_vec)]
    _jax_numpy_only(monkeypatch)
    results.append(run(jax_vec))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_bounds_check_raises_both_paths(impl):
    vals = np.array([1, 300], np.uint64)   # lens 1, 2
    pos = np.array([0, 2], np.int64)       # needs 4 bytes; give 3
    out = np.zeros(3, np.uint8)
    with pytest.raises(IndexError):
        vec.put_varints(out, pos, vals, impl=impl)
    with pytest.raises(IndexError):
        vec.put_varints_padded(out, np.array([0], np.int64),
                               np.array([7], np.uint64), 5, impl=impl)
    with pytest.raises(IndexError):
        jax_vec.put_varints(np.zeros(3, np.uint8), pos, vals)


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_negative_position_rejected_both_paths(impl):
    out = np.zeros(8, np.uint8)
    neg = np.array([-1], np.int64)
    five = np.array([5], np.uint64)
    with pytest.raises(IndexError):
        vec.put_varints(out, neg, five, impl=impl)
    with pytest.raises(IndexError):
        vec.put_varints_padded(out, neg, five, 3, impl=impl)
    assert not out.any()


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_readonly_output_rejected_not_corrupted(impl):
    out = np.zeros(8, np.uint8)
    out.flags.writeable = False
    with pytest.raises((ValueError, IndexError)):
        vec.put_varints(out, np.array([0], np.int64),
                        np.array([5], np.uint64), impl=impl)
    with pytest.raises((ValueError, IndexError)):
        vec.put_varints_padded(out, np.array([0], np.int64),
                               np.array([5], np.uint64), 3, impl=impl)
    with pytest.raises((ValueError, IndexError)):
        vec.ragged_gather(np.arange(4, dtype=np.uint8),
                          np.array([0]), np.array([2]), out=out,
                          out_starts=np.array([0]), impl=impl)
    assert not out.any()


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_length_mismatch_rejected_both_paths(impl):
    out = np.zeros(64, np.uint8)
    short_pos = np.array([0, 2], np.int64)
    vals = np.array([1, 2, 3], np.uint64)
    with pytest.raises(IndexError):
        vec.put_varints(out, short_pos, vals, impl=impl)
    with pytest.raises(IndexError):
        vec.put_varints_padded(out, short_pos, vals, 5, impl=impl)
    assert not out.any()


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_padded_width_out_of_range_rejected_both_paths(impl):
    out = np.zeros(64, np.uint8)
    pos = np.array([0], np.int64)
    vals = np.array([7], np.uint64)
    for width in (0, -1, 11):
        with pytest.raises(ValueError):
            vec.put_varints_padded(out, pos, vals, width, impl=impl)
    assert not out.any()


# -- ragged copy --------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
@pytest.mark.parametrize("scatter", [False, True])
def test_ragged_gather_equals_jax_and_numpy(monkeypatch, dtype, scatter):
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 100, 5000).astype(dtype)
    lens = rng.integers(0, 40, 200)
    starts = rng.integers(0, 5000 - 40, 200)
    out_starts = None
    if scatter:
        # Disjoint destinations with gaps, laid out in shuffled order.
        order = rng.permutation(200)
        sizes = lens[order] + rng.integers(0, 5, 200)
        out_starts = np.empty(200, np.int64)
        out_starts[order] = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    results = []
    for fn, kw in ((vec.ragged_gather, {}),
                   (vec.ragged_gather, {"impl": "numpy"}),
                   (jax_vec.ragged_gather, {})):
        out = None
        if scatter:
            out = np.zeros(int((out_starts + lens).max()) + 7, dtype)
        results.append(fn(flat, starts, lens, out=out,
                          out_starts=out_starts, **kw))
    _jax_numpy_only(monkeypatch)
    out = (np.zeros(int((out_starts + lens).max()) + 7, dtype) if scatter
           else None)
    results.append(jax_vec.ragged_gather(flat, starts, lens, out=out,
                                         out_starts=out_starts))
    for got, offs in results[1:]:
        np.testing.assert_array_equal(results[0][0], got)
        np.testing.assert_array_equal(results[0][1], offs)


def test_ragged_gather_bounds_and_dtypes():
    flat = np.arange(10, dtype=np.int32)
    with pytest.raises(IndexError):
        vec.ragged_gather(flat, np.array([8]), np.array([4]))
    with pytest.raises(IndexError):
        vec.ragged_gather(flat, np.array([0]), np.array([4]),
                          out=np.zeros(3, np.int32), out_starts=np.array([0]))
    # A source of another dtype is taken in the output's, as numpy's
    # assignment casts it.
    out = np.zeros(6, np.int64)
    vec.ragged_gather(flat, np.array([2, 7]), np.array([2, 3]), out=out,
                      out_starts=np.array([0, 3]))
    np.testing.assert_array_equal(out, [2, 3, 0, 7, 8, 9])


# -- the build ----------------------------------------------------------------


def test_built_library_lies_under_the_package_build_dir():
    path = native.ensure_built("vecenc")
    assert path.parent == REPO / "parca_agent_tpu_torch" / "build"
    assert path.name.startswith("libvecenc-") and path.suffix == ".so"
    assert path.exists()
    assert Path(native.load("vecenc")._name) == path


def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A source the compiler refuses: every native entry raises with the
    compiler's output, and nothing runs the numpy versions instead."""
    (tmp_path / "vecenc.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    stacks, pids, ulen, klen = _rows(1, 8)
    with pytest.raises(RuntimeError, match="native build of vecenc.cc"):
        hashing.row_hash_np(stacks, pids, ulen, klen, 3)
    with pytest.raises(RuntimeError, match="error"):
        vec.varint_len(np.arange(4, dtype=np.uint64))
    with pytest.raises(RuntimeError):
        vec.put_varints(np.zeros(8, np.uint8), np.arange(4),
                        np.arange(4, dtype=np.uint64))
    with pytest.raises(RuntimeError):
        hashing.native_hash_available()
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="cannot run"):
        vec.varint_len(np.arange(4, dtype=np.uint64))


def test_four_processes_building_at_once_leave_one_library(tmp_path):
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from parca_agent_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "print(native.ensure_built(sys.argv[2]))\n")
    build = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(build), "vecenc"], env=_env(),
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert len(set(outs)) == 1
    libs = sorted(build.glob("*.so"))
    assert [str(p) for p in libs] == outs[:1]
    assert not list(build.glob("*.tmp"))
    lib = ctypes.CDLL(outs[0])
    lens = np.empty(3, np.int32)
    vals = np.array([0, 128, 2**63], np.uint64)
    lib.pa_varint_lens.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
    lib.pa_varint_lens(vals.ctypes.data, 3, lens.ctypes.data)
    assert lens.tolist() == [1, 2, 10]
