"""The port's batched DWARF walker (unwind/walker.py), sharded tables and
DWARF capture mode (capture/live.py: unwind_records, UnwindTableCache,
PerfEventSampler(capture_stack=True)) against parca_agent_tpu's.

Seeded synthetic tables and stack images, made with numpy, cover the
walker's rules (CFA from RSP, from RBP and by the two PLT expressions;
RBP undefined, at an offset, or in a register, tracked or not) and its
ends (the stack's bottom, a pc no row covers, a rule it cannot run, a
read past the captured slice, the frame cap): both packages must return
the same frames, depths and WalkStats, on the merged table and on the
sharded one. unwind_records must give the same records under the kernel
frames' depth budget, over mixed FP stacks and with trust_fp_frames.
The table cache builds, evicts and fails open. The live case samples
the frame-pointer-less fixture in DWARF mode and recovers
leaf->middle->outer->main; it skips without perf_event permission.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.capture import live as jax_live
from parca_agent_tpu.unwind import table as jax_table
from parca_agent_tpu.unwind import walker as jax_walker
from parca_agent_tpu_torch.capture import live
from parca_agent_tpu_torch.capture.formats import MAX_STACK_DEPTH
from parca_agent_tpu_torch.dwarf.frame import REG_RBP, REG_RSP
from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.process.maps import (
    ProcMapping,
    build_mapping_table,
)
from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
from parca_agent_tpu_torch.unwind import table
from parca_agent_tpu_torch.unwind import walker
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import FakeFS

torch.set_num_threads(1)

FIXDIR = Path(__file__).resolve().parent / "fixtures"
FN = 0x1000          # each synthetic function's pc span
FN0 = 0x10000        # the first function's pc


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.install(None)


def _rule(rng):
    """One row's (cfa_type, rbp_type, cfa_off, rbp_off), weighted toward
    the rules compilers emit."""
    k = int(rng.integers(0, 10))
    if k <= 3:
        off = 8 * int(rng.integers(1, 9))
        if rng.random() < 0.5:
            return table.CFA_TYPE_RSP, table.RBP_TYPE_UNDEFINED, off, 0
        return table.CFA_TYPE_RSP, table.RBP_TYPE_OFFSET, off, -16
    if k <= 5:
        return table.CFA_TYPE_RBP, table.RBP_TYPE_OFFSET, 16, -16
    if k == 6:
        return (table.CFA_TYPE_EXPRESSION, table.RBP_TYPE_UNDEFINED,
                int(rng.choice([table.CFA_EXPR_PLT1, table.CFA_EXPR_PLT2])),
                0)
    if k == 7:
        return (table.CFA_TYPE_RSP, table.RBP_TYPE_REGISTER,
                8 * int(rng.integers(1, 5)),
                int(rng.choice([REG_RSP, REG_RBP, 12])))
    if k == 8:
        return table.CFA_TYPE_EXPRESSION, table.RBP_TYPE_UNDEFINED, 0, 0
    return table.CFA_TYPE_END_OF_FDE, table.RBP_TYPE_UNDEFINED, 0, 0


def _world(seed: int, n_fn: int = 40, n: int = 300):
    """A seeded table of ``n_fn`` functions (two rows each, a gap of
    uncovered pcs after every fourth) and ``n`` samples: registers and
    stack slices whose words are mostly return addresses into the
    functions, saved frame pointers and zeros."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_fn):
        base = FN0 + i * FN
        rows.append((base,) + _rule(rng))
        rows.append((base + 0x40,) + _rule(rng))
        if i % 4 == 3:
            rows.append((base + 0x800, table.CFA_TYPE_END_OF_FDE,
                         table.RBP_TYPE_UNDEFINED, 0, 0))
    t = np.zeros(len(rows), table.ROW_DTYPE)
    for k, r in enumerate(rows):
        t[k] = r + (0,)
    t = table.sort_rows(t)
    dmax = 1024
    stacks = np.zeros((n, dmax), np.uint8)
    rip = np.zeros(n, np.uint64)
    rsp = np.zeros(n, np.uint64)
    rbp = np.zeros(n, np.uint64)
    dyn = np.zeros(n, np.int64)
    for s in range(n):
        sp = 0x7FFF00000000 + s * 0x100000
        d = int(rng.choice([0, 16, 64, 256, 512, 1024]))
        words = np.zeros(dmax // 8, np.uint64)
        for w in range(d // 8):
            u = rng.random()
            if u < 0.55:
                words[w] = FN0 + int(rng.integers(0, n_fn)) * FN \
                    + int(rng.integers(0, 0x7F0))
            elif u < 0.8:
                words[w] = sp + 8 * int(rng.integers(0, dmax // 8))
            elif u < 0.9:
                words[w] = 0
            else:
                words[w] = int(rng.integers(0, 1 << 62))
        stacks[s] = words.view(np.uint8)
        rip[s] = FN0 + int(rng.integers(-1, n_fn + 1)) * FN \
            + int(rng.integers(0, 0x7F0))
        rsp[s] = sp
        rbp[s] = 0 if rng.random() < 0.2 else \
            sp + 8 * int(rng.integers(0, dmax // 8))
        dyn[s] = d
    return t, rip, rsp, rbp, stacks, dyn


def _same_walk(a, b) -> None:
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])
    assert dataclasses.asdict(a[2]) == dataclasses.asdict(b[2])


@pytest.mark.parametrize("seed", range(8))
def test_walk_batch_matches_parca_agent_tpus(seed):
    t, rip, rsp, rbp, stacks, dyn = _world(seed)
    args = (rip, rsp, rbp, stacks, dyn)
    got = walker.walk_batch(t, *args)
    _same_walk(got, jax_walker.walk_batch(t, *args))
    _same_walk(walker.walk_batch(table.ShardedTable.from_table(t), *args),
               jax_walker.walk_batch(jax_table.ShardedTable.from_table(t),
                                     *args))
    _same_walk(walker.walk_batch(t, *args, max_frames=5),
               jax_walker.walk_batch(t, *args, max_frames=5))
    assert got[2].total == len(rip) and got[1].max() >= 3


def test_synthetic_worlds_reach_every_end_of_a_walk():
    """Across the seeds of the comparison above, every outcome the
    walker counts occurs, so the equality covers each."""
    total = walker.WalkStats()
    for seed in range(8):
        t, rip, rsp, rbp, stacks, dyn = _world(seed)
        total.add(walker.walk_batch(t, rip, rsp, rbp, stacks, dyn)[2])
    assert total.success > 0 and total.truncated > 0
    assert total.pc_not_covered > 0 and total.unsupported > 0


def test_sharded_lookup_beyond_the_shard_cap_matches():
    n = table.MAX_ROWS_PER_SHARD * table.MAX_SHARDS + 50_000
    t = np.zeros(n, table.ROW_DTYPE)
    t["pc"] = (np.arange(n, dtype=np.uint64) + 1) * 16
    t["cfa_type"] = table.CFA_TYPE_RSP
    t["cfa_off"] = 8
    st = table.ShardedTable.from_table(t)
    jst = jax_table.ShardedTable.from_table(t)
    assert len(st.shards) == len(jst.shards) == 4 and len(st) == n
    pcs = np.random.default_rng(7).integers(0, (n + 2) * 16, 20_000).astype(
        np.uint64)
    idx = st.lookup(pcs)
    assert np.array_equal(idx, jst.lookup(pcs))
    assert np.array_equal(idx, table.lookup_rows(t, pcs))
    assert np.array_equal(table.lookup_rows(t, pcs),
                          jax_table.lookup_rows(t, pcs))
    ok = idx >= 0
    assert np.array_equal(st.rows(idx[ok]), jst.rows(idx[ok]))
    assert st.lookup([np.uint64(n * 16 + 8)])[0] == n - 1


class _Stub:
    """A table cache that holds one table for every pid."""

    def __init__(self, t, match=lambda pid: True):
        self._t = t
        self._match = match

    def matches(self, pid):
        return self._match(pid)

    def table_for(self, pid):
        return self._t


def _records_v2(seed: int, n: int = 200):
    """Seeded v2 records over a synthetic world: kernel frames, FP chains
    of 0..6 frames, and a sample without registers now and then."""
    t, rip, rsp, rbp, stacks, dyn = _world(seed, n=n)
    rng = np.random.default_rng(seed + 100)
    recs = []
    for s in range(n):
        kf = (np.uint64(0xFFFF800000000000)
              + rng.integers(0, 1 << 20, int(rng.integers(0, 20))).astype(
                  np.uint64))
        uf = (FN0 + rng.integers(0, 1 << 16, int(rng.integers(0, 7)))).astype(
            np.uint64)
        ip = 0 if rng.random() < 0.05 else int(rip[s])
        recs.append((int(rng.integers(1, 6)), s, kf, uf, ip, int(rsp[s]),
                     int(rbp[s]), stacks[s, :dyn[s]].copy()))
    return t, recs


def _same_records(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:2] == y[:2]
        assert np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])


@pytest.mark.parametrize("trust", [None, 2, 5])
def test_unwind_records_matches_parca_agent_tpus(trust):
    t, recs = _records_v2(3)
    for match in (lambda pid: True, lambda pid: pid % 2 == 1):
        st, jst = walker.WalkStats(), jax_walker.WalkStats()
        out = live.unwind_records(recs, _Stub(t, match),
                                  trust_fp_frames=trust, stats=st)
        jout = jax_live.unwind_records(recs, _Stub(t, match),
                                       trust_fp_frames=trust, stats=jst)
        _same_records(out, jout)
        assert dataclasses.asdict(st) == dataclasses.asdict(jst)
        assert st.total > 0
        assert any(len(o[3]) > len(r[3]) for o, r in zip(out, recs))


def test_unwind_records_keeps_the_kernel_frames_depth_budget():
    """A walk that would run to the frame cap is cut to the depth the
    record's kernel frames leave, so the record fits a snapshot row."""
    t = np.zeros(1, table.ROW_DTYPE)
    t[0] = (0x1000, table.CFA_TYPE_RSP, table.RBP_TYPE_UNDEFINED, 8, 0, 0)
    dump = np.frombuffer(struct.pack("<Q", 0x1100) * (MAX_STACK_DEPTH + 8),
                         np.uint8).copy()
    kf = np.arange(5, dtype=np.uint64) + np.uint64(0xFFFF800000000000)
    rec = (9, 9, kf, np.zeros(0, np.uint64), 0x1100, 0, 1, dump)
    out = live.unwind_records([rec], _Stub(t))
    _same_records(out, jax_live.unwind_records([rec], _Stub(t)))
    assert len(out[0][3]) == MAX_STACK_DEPTH - len(kf)
    snap = live.records_to_snapshot(out, build_mapping_table({}), int(1e7),
                                    int(1e10))
    assert snap.user_len[0] + snap.kernel_len[0] == MAX_STACK_DEPTH


def test_unwind_records_walks_mixed_fp_stacks():
    """An FP chain of two frames cut short by a frameless caller is walked
    and the longer walked chain wins; trust_fp_frames=2 skips it."""
    rsp0 = 0x7FFF0000
    t = np.zeros(3, table.ROW_DTYPE)
    t[0] = (0x1000, table.CFA_TYPE_RSP, table.RBP_TYPE_UNDEFINED, 8, 0, 0)
    t[1] = (0x2000, table.CFA_TYPE_RSP, table.RBP_TYPE_OFFSET, 24, -16, 0)
    t[2] = (0x3000, table.CFA_TYPE_RSP, table.RBP_TYPE_UNDEFINED, 8, 0, 0)
    mem = np.zeros(64, np.uint8)
    for off, val in ((0, 0x2211), (24, 0x3311), (16, 0x7FFFAA00), (32, 0)):
        mem[off:off + 8] = np.frombuffer(struct.pack("<Q", val), np.uint8)
    rec = (7, 7, np.zeros(0, np.uint64),
           np.array([0x1100, 0x2211], np.uint64), 0x1100, rsp0, 1, mem)
    for trust, want in ((None, 3), (2, 2)):
        out = live.unwind_records([rec], _Stub(t), trust_fp_frames=trust)
        _same_records(out, jax_live.unwind_records([rec], _Stub(t),
                                                   trust_fp_frames=trust))
        assert len(out[0][3]) == want


def _maps_of(path: str):
    class Maps:
        def executable_mappings(self, pid):
            if pid == 99:
                raise OSError("gone")
            return [ProcMapping(0x1000, 0x5000, "r-xp", 0x1000, "08:01", 7,
                                path)]

        def evict(self, pid):
            pass

    return Maps()


def _cache_fs():
    elf = (FIXDIR / "fixture_pie").read_bytes()
    return FakeFS({"/proc/1/comm": b"live\n", "/proc/1/root/bin/app": elf,
                   "/proc/2/comm": b"dying\n", "/proc/2/root/bin/app": elf})


def test_table_cache_builds_evicts_and_matches_by_comm():
    fs = _cache_fs()
    cache = live.UnwindTableCache(_maps_of("/bin/app"), refresh_s=0.0,
                                  fs=fs, comm_regex="^li")
    try:
        assert cache.matches(1) and not cache.matches(2)
        assert cache.build_now(99) is None  # maps gone
        t1, t2 = cache.build_now(1), cache.build_now(2)
        assert len(t1) == len(t2) > 10
        del fs.files["/proc/2/comm"]        # pid 2 exits
        cache._last_evict = 0.0
        cache._evict_dead()
        assert set(cache._tables) == {1} and cache.stats["evicted"] == 1
        cache.evict(1)                      # a recycled pid
        assert cache._tables == {}
        # table_for queues a build on the worker and never blocks.
        assert cache.table_for(1) is None
        deadline = time.monotonic() + 10
        while cache.table_for(1) is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(cache.table_for(1)) == len(t1)
    finally:
        cache.close()


@pytest.mark.parametrize("kind", ["poison", "error"])
def test_table_cache_unwind_build_fault_fails_open(kind):
    """The ``unwind.build`` site in the background builder: a poisoned
    build charges the pid (no table, counted in the registry), any
    other error costs that build only, and the worker lives on."""
    q = QuarantineRegistry(max_strikes=5)
    cache = live.UnwindTableCache(_maps_of("/bin/app"), refresh_s=0.0,
                                  fs=_cache_fs())
    cache.quarantine = q
    faults.install(faults.FaultInjector.from_spec(
        f"unwind.build:{kind}:count=1", seed=1))
    try:
        assert cache.table_for(1) is None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                cache.stats["builds"] + cache.stats["build_errors"] == 0:
            time.sleep(0.02)
        if kind == "poison":
            # Charged, and the pid's table built empty.
            assert q.stats["errors_total"] == 1
            assert cache.stats["builds"] == 1
            assert len(cache._tables[1]) == 0
        else:
            assert cache.stats["build_errors"] == 1
        # The next build of the pid (the fault spent) has its table.
        assert len(cache.build_now(1)) > 10
        assert cache._worker.is_alive()
    finally:
        cache.close()


def test_sampler_dwarf_mode_reaches_the_table_cache():
    """capture_stack=True no longer raises: the sampler carries a table
    cache and walk counters, and its quarantine reaches the cache."""
    try:
        s = live.PerfEventSampler(frequency_hz=99, window_s=0.2,
                                  capture_stack=True,
                                  dwarf_comm_regex="fixture",
                                  trust_fp_frames=4)
    except live.SamplerUnavailable as e:
        pytest.skip(f"perf_event not permitted here: {e}")
    try:
        assert s.capture_stack and not s.hash_carry
        q = QuarantineRegistry()
        s.quarantine = q
        assert s._tables.quarantine is q
        assert s._trust_fp_frames == 4
        snap = s.poll()
        assert snap.counts.sum() >= 0
        assert s.walk_stats.total >= 0
    finally:
        s.close()


@pytest.mark.live
def test_live_dwarf_capture_recovers_the_frameless_chain():
    """Sample the -fomit-frame-pointer fixture in DWARF mode: walked
    records run leaf -> middle -> outer -> main through its functions."""
    fix = FIXDIR / "fixture_pie_nofp"
    try:
        sampler = live.PerfEventSampler(frequency_hz=997, window_s=2.0,
                                        capture_stack=True)
    except live.SamplerUnavailable as e:
        pytest.skip(f"perf_event not permitted here: {e}")
    proc = None
    try:
        proc = subprocess.Popen([str(fix), "spin", "5"],
                                stdout=subprocess.DEVNULL)
        time.sleep(0.3)
        tables = live.UnwindTableCache(sampler._maps)
        table_ = tables.build_now(proc.pid)
        maps = sampler._maps.executable_mappings(proc.pid)
        v2 = []
        deadline = time.monotonic() + 3.6
        while True:
            time.sleep(0.6)
            v2 += [r for r in sampler._drain_v2() if r[0] == proc.pid]
            if len(v2) >= 40 or time.monotonic() >= deadline:
                break
        proc.wait(timeout=10)
        if len(v2) < 8:
            pytest.skip(f"only {len(v2)} fixture samples under host load; "
                        "too few to judge the walker")
        assert table_ is not None and len(table_)
        stats = walker.WalkStats()
        recs = live.unwind_records(v2, tables, stats=stats)
        merged = np.concatenate(table_.shards)
        _same_records(recs, jax_live.unwind_records(v2, _Stub(merged)))
        ef = ElfFile(fix.read_bytes())
        syms = [(s.value, s.value + s.size, s.name) for s in ef.symbols()
                if s.name in ("leaf", "middle", "outer", "main")]
        exe = [m for m in maps if m.path.endswith("fixture_pie_nofp")]
        base = min(m.start - m.offset for m in exe)

        def names(frames):
            out = []
            for a in frames:
                rel = int(a) - base
                out += [n for lo, hi, n in syms if lo <= rel < hi]
            return out

        chains = [names(r[3]) for r in recs]
        want = ["leaf", "middle", "outer", "main"]
        assert any(c[:4] == want for c in chains), chains[:10]
        assert max(len(r[3]) for r in recs) >= 4
        assert stats.success > 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        sampler.close()


@pytest.mark.live
@pytest.mark.parametrize("fast", [False, True])
def test_cli_dwarf_mode_walks_and_runs_one_shot(capsys, caplog, fast):
    """--capture perf --dwarf-unwinding beside the frameless fixture:
    the runtime line carries the walk counters under the original's
    /metrics names. With --fast-encode --streaming-window the CLI warns
    and runs one-shot (no window is streamed); without --fast-encode the
    windows are symbolized."""
    from parca_agent_tpu_torch import cli

    proc = subprocess.Popen([str(FIXDIR / "fixture_pie_nofp"), "spin", "6"],
                            stdout=subprocess.DEVNULL)
    try:
        flags = ["--fast-encode", "--streaming-window"] if fast else []
        code = cli.run(["--device", "cpu", "--http-address", "127.0.0.1:0",
                        "--capture", "perf",
                        "--dwarf-unwinding", "--dwarf-unwinding-comm-regex",
                        "fixture", "--dwarf-trust-fp-frames", "0",
                        "--aggregator", "dict", "--aggregator-capacity",
                        "65536", "--windows", "2", "--profiling-duration",
                        "1.5", *flags])
    finally:
        proc.kill()
        proc.wait()
    out = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.out.splitlines()
             if ln.startswith("{")]
    capture = next(ln["capture"] for ln in lines if "capture" in ln
                   and isinstance(ln["capture"], dict))
    if capture["source"] != "perf":
        pytest.skip("perf_event not permitted here")
    assert code == 0 and capture["dwarf"] is True
    assert capture["hash_carry"] is False
    wins = [ln for ln in lines if "window" in ln]
    assert len(wins) == 2 and not any(w.get("streamed") for w in wins)
    assert all(("symbolize_ms" in w) != fast for w in wins)
    if fast:
        assert "running one-shot" in out.err
    walks = next(ln["runtime"] for ln in lines if "runtime" in ln).get(
        "dwarf_walk")
    if walks is None:
        pytest.skip("no sample of the fixture was walked under host load")
    assert walks["parca_agent_dwarf_walk_total"] > 0
    assert 0 <= walks["parca_agent_dwarf_walk_success_ratio"] <= 1
