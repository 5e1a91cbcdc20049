"""The port's live capture (capture/live.py, native/sampler.cc) against
parca_agent_tpu's.

Seeded v1, v1d, v1h and v2 drain records decode to the same columns
through both packages' libraries; the sampler's pa_stack_hash equals
row_hash_np on the decoded rows (and parca_agent_tpu's pa_stack_hash);
records_to_snapshot and CommFilterSource give the same windows as the
original's. The live cases (the sampler smoke, the lossless drain
overflow, the CLI's streamed perf run) are gated on perf_event_open
permission as tests/test_live_capture.py gates them: where the kernel
refuses it they skip with the errno.
"""

from __future__ import annotations

import errno
import json
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.capture import live as jax_live
from parca_agent_tpu.capture.formats import MappingTable as JaxTable
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu_torch.capture import live
from parca_agent_tpu_torch.capture.formats import STACK_SLOTS, MappingTable
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.ops.hashing import hash_params, row_hash_np
from parca_agent_tpu_torch.pprof.builder import parse_pprof

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _records(seed: int, n: int = 300):
    """Seeded (pid, tid, kernel frames, user frames, count, hashes)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nk = int(rng.integers(0, 8))
        nu = int(rng.integers(0, 120 - nk))
        if i == 0:
            nk, nu = 0, 0
        if i == 1:
            nk, nu = 20, 107  # the depth cap, 127 frames
        pid = int(rng.integers(0, 2**32)) if i % 50 == 7 else \
            int(rng.integers(1, 1 << 22))
        out.append((pid, int(rng.integers(1, 1 << 22)),
                    rng.integers(1, 2**64 - 1, nk, dtype=np.uint64),
                    rng.integers(1, 2**64 - 1, nu, dtype=np.uint64),
                    int(rng.integers(1, 1000)),
                    rng.integers(0, 2**32, 3, dtype=np.uint64)))
    return out


def _pack(kind: str, recs) -> bytes:
    parts = []
    for pid, tid, kf, uf, count, h in recs:
        head = [pid, tid, len(kf), len(uf)]
        if kind == "v1d":
            head += [count, 0]
        elif kind == "v1h":
            head += [count, *h.tolist()]
        parts.append(struct.pack(f"<{len(head)}I", *head))
        parts.append(np.concatenate([kf, uf]).astype("<u8").tobytes())
    return b"".join(parts)


@pytest.mark.parametrize("tail", [b"", b"\x05\x00\x00\x00", b"\x01" * 40],
                         ids=["whole", "short_tail", "corrupt_tail"])
@pytest.mark.parametrize("kind", ["v1", "v1d", "v1h"])
def test_columnar_decoders_equal_jax(kind, tail):
    lib, jlib = live.load_native(), jax_live.load_native()
    fn = {"v1": "decode_records_columnar",
          "v1d": "decode_records_columnar_v1d",
          "v1h": "decode_records_columnar_v1h"}[kind]
    recs = _records(3)
    buf = _pack(kind, recs) + tail
    got = getattr(live, fn)(lib, buf, len(buf))
    want = getattr(jax_live, fn)(jlib, buf, len(buf))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    pids, tids, ulen, klen, stacks = got[:5]
    assert len(pids) == len(recs)
    for i, (pid, tid, kf, uf, count, h) in enumerate(recs):
        assert (int(pids[i]) & 0xFFFFFFFF, int(tids[i])) == (pid, tid)
        assert (ulen[i], klen[i]) == (len(uf), len(kf))
        np.testing.assert_array_equal(stacks[i, :len(uf)], uf)
        np.testing.assert_array_equal(
            stacks[i, len(uf):len(uf) + len(kf)], kf)
        assert not stacks[i, len(uf) + len(kf):].any()
        if kind != "v1":
            assert got[5][i] == count
        if kind == "v1h":
            assert [int(c[i]) for c in got[6:9]] == h.tolist()
    # The pure-Python v1 decoder reads the same records.
    if kind == "v1":
        py = live.decode_records(buf)
        jpy = jax_live.decode_records(buf)
        assert len(py) == len(jpy) == len(recs)
        for a, b in zip(py, jpy):
            assert a[:2] == b[:2]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])


def _pack_v2(pid, tid, kframes, uframes, rip, rsp, rbp, stack: bytes):
    dyn = len(stack)
    out = struct.pack("<IIII", pid, tid, len(kframes), len(uframes))
    out += struct.pack("<QQQII", rip, rsp, rbp, dyn, 0)
    out += np.asarray(list(kframes) + list(uframes), "<u8").tobytes()
    return out + stack + b"\x00" * ((-dyn) % 8)


def test_v2_decoder_equals_jax():
    buf = (_pack_v2(7, 8, [0xFFFF800000000010], [0x401000], 0x401000,
                    0x7FFF0000, 0x7FFF0040, b"\xAA" * 19)
           + _pack_v2(9, 9, [], [], 0x55000, 0x1000, 0, b"")
           + b"\x01" * 50)
    got, want = live.decode_records_v2(buf), jax_live.decode_records_v2(buf)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[4:7] == w[4:7]
        for k in (2, 3, 7):
            np.testing.assert_array_equal(g[k], w[k])


def test_stack_hash_equals_row_hash_and_jax():
    """pa_stack_hash (the helper the v1h drain stamps each record with)
    over split (kernel, user) frames equals row_hash_np over the decoded
    snapshot row, and parca_agent_tpu's pa_stack_hash."""
    import ctypes

    lib, jlib = live.load_native(), jax_live.load_native()
    coefs, biases = hash_params(3, STACK_SLOTS)
    recs = _records(9, 200)
    buf = _pack("v1", recs)
    pids, _tids, ulen, klen, stacks = live.decode_records_columnar(
        lib, buf, len(buf))
    want = row_hash_np(stacks, pids, ulen, klen, 3)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for i, (pid, _tid, kf, uf, _c, _h) in enumerate(recs):
        kf = np.ascontiguousarray(kf, np.uint64)
        uf = np.ascontiguousarray(uf, np.uint64)
        out = np.zeros(3, np.uint32)
        assert lib.pa_stack_hash(
            kf.ctypes.data, len(kf), uf.ctypes.data, len(uf), pid,
            coefs.ctypes.data, coefs.shape[1], biases.ctypes.data, 3,
            STACK_SLOTS, out.ctypes.data) == 0
        jout = np.zeros(3, np.uint32)
        assert jlib.pa_stack_hash(
            kf.ctypes.data_as(u64p), len(kf), uf.ctypes.data_as(u64p),
            len(uf), pid, coefs.ctypes.data_as(u32p), coefs.shape[1],
            biases.ctypes.data_as(u32p), 3, STACK_SLOTS,
            jout.ctypes.data_as(u32p)) == 0
        assert out.tolist() == [int(h[i]) for h in want] == jout.tolist()
    # Bad arguments are refused, not read past.
    z = np.zeros(130, np.uint64)
    assert lib.pa_stack_hash(z.ctypes.data, 100, z.ctypes.data, 30, 1,
                             coefs.ctypes.data, coefs.shape[1],
                             biases.ctypes.data, 3, STACK_SLOTS,
                             z.ctypes.data) == -1


def _py_records(recs):
    return [(pid, tid, kf, uf) for pid, tid, kf, uf, _c, _h in recs]


@pytest.mark.parametrize("seed", [0, 1])
def test_records_to_snapshot_equals_jax(seed):
    recs = _py_records(_records(seed, 200))
    # Repeats of a record and unattributable ones (pid -1).
    recs += recs[:40] + [(0xFFFFFFFF, 0xFFFFFFFF,
                          np.array([0xFFFF800000000010], np.uint64),
                          np.zeros(0, np.uint64))] * 3
    snap = live.records_to_snapshot(recs, MappingTable.empty(), 10**7,
                                    10**10)
    jsnap = jax_live.records_to_snapshot(recs, JaxTable.empty(), 10**7,
                                         10**10)
    assert len(snap) == len(jsnap) == 200 - sum(
        1 for r in recs[:200] if r[0] >= 2**31)
    for f in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        np.testing.assert_array_equal(getattr(snap, f), getattr(jsnap, f))
    snap.validate_padding()
    assert len(live.records_to_snapshot([], MappingTable.empty(), 1, 1)) == 0


def test_v1d_weighted_snapshot_equals_jax():
    lib, jlib = live.load_native(), jax_live.load_native()
    recs = _records(4, 100)
    buf = _pack("v1d", recs + recs[:30])
    cols = live.decode_records_columnar_v1d(lib, buf, len(buf))
    jcols = jax_live.decode_records_columnar_v1d(jlib, buf, len(buf))
    snap = live.columns_to_snapshot(*cols[:5], MappingTable.empty(), 10**7,
                                    10**10, weights=cols[5])
    jsnap = jax_live.columns_to_snapshot(*jcols[:5], JaxTable.empty(),
                                         10**7, 10**10, weights=jcols[5])
    for f in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        np.testing.assert_array_equal(getattr(snap, f), getattr(jsnap, f))
    assert snap.total_samples() == int(cols[5][cols[0] >= 0].sum())


# -- CommFilterSource (the cases of tests/test_live_capture.py) ---------------


class _Once:
    def __init__(self, snap):
        self._left = [snap]

    def poll(self):
        return self._left.pop() if self._left else None

    def close(self):
        pass


class _Repeat:
    def __init__(self, snap):
        self._snap = snap

    def poll(self):
        return self._snap

    def close(self):
        pass


def _both(**kw):
    return generate(SyntheticSpec(**kw)), jax_generate(JaxSpec(**kw))


def _same_rows(a, b):
    for f in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_comm_filter_keeps_matching_pids():
    snap, jsnap = _both(n_pids=6, n_unique_stacks=120, n_rows=120,
                        total_samples=480, seed=3)
    comms = {int(p): ("keepme" if i % 2 else "other")
             for i, p in enumerate(np.unique(snap.pids))}
    src = live.CommFilterSource(_Once(snap), ["keep"],
                                read_comm=lambda pid: comms.get(pid, ""))
    jsrc = jax_live.CommFilterSource(_Once(jsnap), ["keep"],
                                     read_comm=lambda pid: comms.get(pid, ""))
    got, jgot = src.poll(), jsrc.poll()
    _same_rows(got, jgot)
    kept = {p for p, c in comms.items() if c == "keepme"}
    assert set(np.unique(got.pids).tolist()) == kept
    for p in kept:
        assert (got.counts[got.pids == p].sum()
                == snap.counts[snap.pids == p].sum())
    assert src.poll() is None and jsrc.poll() is None


def test_comm_filter_passthrough_when_all_match():
    snap, jsnap = _both(n_pids=3, n_unique_stacks=30, n_rows=30,
                        total_samples=90, seed=4)
    src = live.CommFilterSource(_Once(snap), [".*"],
                                read_comm=lambda pid: "anything")
    jsrc = jax_live.CommFilterSource(_Once(jsnap), [".*"],
                                     read_comm=lambda pid: "anything")
    assert src.poll() is snap
    assert jsrc.poll() is jsnap


def test_comm_filter_verdict_is_a_lease_not_a_fact():
    snap, jsnap = _both(n_pids=2, n_unique_stacks=40, n_rows=40,
                        total_samples=120, seed=5)
    pids = sorted(int(p) for p in np.unique(snap.pids))
    comms = {pids[0]: "keepme", pids[1]: "other"}
    now = {"t": 100.0}
    srcs = [mod.CommFilterSource(_Repeat(s), ["keep"],
                                 read_comm=lambda pid: comms[pid],
                                 cache_ttl_s=30.0, clock=lambda: now["t"])
            for mod, s in ((live, snap), (jax_live, jsnap))]

    def poll():
        got = [s.poll() for s in srcs]
        _same_rows(*got)
        return set(np.unique(got[0].pids).tolist())

    assert poll() == {pids[0]}
    # The kernel reuses pids[1] for a matching process. Within the TTL
    # the stale verdict holds; past it, the re-read flips the verdict.
    comms[pids[1]] = "keepme2"
    assert poll() == {pids[0]}
    now["t"] += 31.0
    assert poll() == {pids[0], pids[1]}


def test_dwarf_mode_is_not_ported():
    """DWARF mode is ported since this test was written: capture_stack=
    True makes a sampler with its unwind table cache and a hashless
    drain, or the kernel refuses the perf events (SamplerUnavailable);
    it never raises NotImplementedError."""
    try:
        s = live.PerfEventSampler(capture_stack=True)
    except live.SamplerUnavailable as e:
        assert e.errno != 0
        return
    try:
        assert s.capture_stack and s._tables is not None
        assert not s.hash_carry
    finally:
        s.close()


# -- live capture (gated on perf_event_open permission) -----------------------


def _perf_or_skip(**kw):
    try:
        return live.PerfEventSampler(**kw)
    except live.SamplerUnavailable as e:
        pytest.skip(f"perf_event not permitted here (errno {e.errno}, "
                    f"{errno.errorcode.get(e.errno, '?')}): {e}")


@pytest.mark.live
def test_live_sampler_smoke():
    """Real sampling: burn CPU for a window and expect this process's
    samples, with the carried hashes equal to row_hash_np's."""
    sampler = _perf_or_skip(frequency_hz=99, window_s=1.0)
    drains = []
    sampler.on_drain = drains.append
    stop = threading.Event()

    def burn():
        x = 0
        while not stop.is_set():
            x += 1
        return x

    t = threading.Thread(target=burn, daemon=True)
    t.start()
    try:
        snap = sampler.poll()
    finally:
        stop.set()
        t.join(10)
        sampler.close()
    assert not t.is_alive()
    assert sampler.n_cpus >= 1 and sampler.hash_carry
    assert snap.total_samples() > 0
    assert os.getpid() in set(int(p) for p in snap.pids)
    snap.validate_padding()
    assert drains and all(len(c) == 9 for c in drains)
    for pids, _t, ulen, klen, stacks, counts, h1, h2, h3 in drains:
        want = row_hash_np(stacks, pids, ulen, klen, 3)
        for got, w in zip((h1, h2, h3), want):
            np.testing.assert_array_equal(got, w)
    fed = sum(int(c[5][c[0] >= 0].sum()) for c in drains)
    assert fed == snap.total_samples()
    assert sampler.lost_samples >= 0 and sampler.dedup_hits >= 0


@pytest.mark.live
def test_drain_overflow_is_lossless():
    """A drain buffer too small for the backlog returns what fits, keeps
    the rest in the rings, and gives it back on later drains."""
    import ctypes

    sampler = _perf_or_skip(frequency_hz=1997, window_s=1.0)
    try:
        proc = subprocess.Popen([str(FIXTURES / "fixture_pie_nofp"), "spin",
                                 "1"], stdout=subprocess.DEVNULL)
        time.sleep(1.1)
        proc.wait(timeout=10)
        sampler._lib.pa_sampler_stop(sampler._handle)  # freeze the corpus
        tiny = 4096
        chunks = []
        for _ in range(10_000):
            buf = (ctypes.c_uint8 * tiny)()
            n = sampler._lib.pa_sampler_drain(sampler._handle,
                                              ctypes.addressof(buf), tiny)
            assert n >= 0
            if n == 0:
                break
            chunks.append(bytes(buf[:n]))
        total = b"".join(chunks)
        if len(total) <= tiny:
            pytest.skip("not enough samples to overflow the tiny buffer")
        assert sampler.truncated_drains >= 1
        recs = live.decode_records(total)
        assert sum(16 + 8 * (len(r[2]) + len(r[3])) for r in recs) \
            == len(total)
    finally:
        sampler.close()


@pytest.mark.live
def test_cli_streams_perf_windows(tmp_path):
    """--capture perf --aggregator dict --fast-encode --streaming-window
    on the CPU: every window streams (drains fed during the window), the
    hash carry is on, and the stored profiles parse with mass, the
    burner's pid among them."""
    _perf_or_skip(frequency_hz=99, window_s=0.1).close()
    burn = subprocess.Popen(
        [sys.executable, "-c", "while True:\n sum(i*i for i in range(4000))"],
        env=_env())
    store = tmp_path / "store"
    try:
        r = subprocess.run(
            [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
             "--http-address", "127.0.0.1:0",
             "--capture", "perf", "--aggregator", "dict", "--fast-encode",
             "--streaming-window", "--windows", "3",
             "--profiling-duration", "2", "--local-store-directory",
             str(store)],
            env=_env(), cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
    finally:
        burn.kill()
        burn.wait()
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    windows = [ln for ln in lines if "window" in ln]
    assert len(windows) == 3
    assert all(ln["capture"] == "perf" for ln in windows)
    assert all(ln["mass"] == ln["samples"] for ln in windows)
    cap = lines[-1]["capture"]
    assert cap["source"] == "perf" and cap["hash_carry"]
    assert cap["streaming"]["windows_streamed"] >= 1
    assert cap["streaming"]["drains_fed"] >= 1
    files = sorted(store.glob("*.pb.gz"))
    mass = sum(v[0] for f in files
               for _, v, _ in parse_pprof(f.read_bytes()).samples)
    assert mass > 0
    assert any(f.name.startswith(f"pid={burn.pid}.") for f in files)
