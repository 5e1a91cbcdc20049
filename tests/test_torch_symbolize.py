"""The port's symbolization (symbolize/) against parca_agent_tpu's.

Seeded kallsyms and perf-map texts, made with numpy, go through both
packages' parsers and caches over the same FakeFS contents; the same
window goes through each package's CPUAggregator and then its
Symbolizer, and the functions, the location lines and the build_pprof
bytes must be equal. The chaos sites ``symbolize.kernel`` and
``perfmap.parse`` fail open alike. Last, the CLI without --fast-encode
names the kernel frames of its windows from a kallsyms, as
parca_agent_tpu's aggregator and symbolizer name them on the same
windows.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.cpu import CPUAggregator as JaxCPU
from parca_agent_tpu.capture import formats as jax_formats
from parca_agent_tpu.capture.synthetic import SyntheticSpec as JaxSpec
from parca_agent_tpu.capture.synthetic import generate as jax_generate
from parca_agent_tpu.pprof.builder import build_pprof as jax_build_pprof
from parca_agent_tpu.runtime.quarantine import (
    QuarantineRegistry as JaxQuarantine,
)
from parca_agent_tpu.symbolize import ksym as jax_ksym
from parca_agent_tpu.symbolize import perfmap as jax_perfmap
from parca_agent_tpu.symbolize.symbolizer import Symbolizer as JaxSymbolizer
from parca_agent_tpu.utils import faults as jax_faults
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS
from parca_agent_tpu_torch import cli
from parca_agent_tpu_torch import symbolize as port_symbolize
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.capture import formats
from parca_agent_tpu_torch.pprof.builder import build_pprof, parse_pprof
from parca_agent_tpu_torch.profiler.cpu import CPUProfiler
from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
from parca_agent_tpu_torch.symbolize import ksym, perfmap
from parca_agent_tpu_torch.symbolize.symbolizer import Symbolizer
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import FakeFS

torch.set_num_threads(1)

K0 = jax_formats.KERNEL_ADDR_START


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.install(None)
    jax_faults.install(None)


def _arm(spec: str, seed: int = 42) -> None:
    """The same fault rule in both packages' injectors."""
    faults.install(faults.FaultInjector.from_spec(spec, seed=seed))
    jax_faults.install(jax_faults.FaultInjector.from_spec(spec, seed=seed))


def _kallsyms(seed: int, n: int = 400, span: int = 1 << 22) -> bytes:
    """Seeded kallsyms text in shuffled order: text and data symbols,
    module suffixes, and malformed lines the parser must skip."""
    rng = np.random.default_rng(seed)
    addrs = K0 + np.sort(rng.choice(span, n, replace=False)).astype(
        np.uint64) * np.uint64(16)
    types = rng.choice(list("TtWwDdBbRr"), n)
    lines = []
    for i, (a, t) in enumerate(zip(addrs.tolist(), types)):
        mod = f" [mod{i % 5}]" if i % 7 == 0 else ""
        lines.append(f"{a:016x} {t} ksym_{seed}_{i}{mod}".encode())
    lines += [b"zzzz T bad_hex", b"ffff", b"", b"1" * 40 + b" T too_big"]
    order = rng.permutation(len(lines))
    return b"\n".join(lines[i] for i in order) + b"\n"


def _perf_map_text(seed: int, n: int = 120, base: int = 0x7F0000000000
                   ) -> bytes:
    """Seeded perf map: `start size name` lines, names with spaces,
    overlaps, and malformed lines (tolerated and counted)."""
    rng = np.random.default_rng(seed)
    starts = base + np.sort(rng.choice(1 << 10, n, replace=False)) * 64
    sizes = rng.integers(1, 200, n)
    lines = [f"{s:x} {z:x} jit::fn_{seed}_{i} (tier {i % 3})".encode()
             for i, (s, z) in enumerate(zip(starts.tolist(), sizes.tolist()))]
    lines += [b"xyz 10 bad", b"10 -5 negative", b"only two", b"   "]
    order = rng.permutation(len(lines))
    return b"\n".join(lines[i] for i in order) + b"\n"


def test_parse_kallsyms_matches_parca_agent_tpus():
    for seed in range(4):
        text = _kallsyms(seed)
        a, n = ksym.parse_kallsyms(text)
        ja, jn = jax_ksym.parse_kallsyms(text)
        assert a.dtype == ja.dtype == np.uint64
        assert np.array_equal(a, ja) and n == jn
        assert len(n) > 100


def test_ksym_resolve_matches_and_reloads_on_hash_change():
    text = _kallsyms(11)
    clock = [0.0]
    fs, jfs = FakeFS({"/proc/kallsyms": text}), JaxFS({"/proc/kallsyms": text})
    c = ksym.KsymCache(fs=fs, ttl_s=10.0, clock=lambda: clock[0])
    jc = jax_ksym.KsymCache(fs=jfs, ttl_s=10.0, clock=lambda: clock[0])
    rng = np.random.default_rng(11)
    q = (K0 + rng.integers(0, 1 << 27, 3000).astype(np.uint64)).tolist()
    q += [K0 - 1, 0, K0]  # below the first symbol
    assert c.resolve(q) == jc.resolve(q)
    assert c.resolve(q[:500]) == jc.resolve(q[:500])  # the LRU's answers
    assert (c.hits, c.misses) == (jc.hits, jc.misses) and c.hits >= 500
    other = _kallsyms(12)
    fs.put("/proc/kallsyms", other)
    jfs.put("/proc/kallsyms", other)
    assert c.resolve(q) == jc.resolve(q)  # inside the ttl: stale table
    clock[0] = 11.0
    got = c.resolve(q)
    assert got == jc.resolve(q)
    assert any(name and name.startswith("ksym_12_") for name in got)


def test_parse_perf_map_and_lookup_match_parca_agent_tpus():
    for seed in range(4):
        text = _perf_map_text(seed)
        m, jm = perfmap.parse_perf_map(text), jax_perfmap.parse_perf_map(text)
        assert np.array_equal(m.starts, jm.starts)
        assert np.array_equal(m.ends, jm.ends)
        assert m.names == jm.names and m.skipped_lines == jm.skipped_lines
        assert m.skipped_lines == 4
        rng = np.random.default_rng(seed)
        q = 0x7F0000000000 + rng.integers(0, 64 << 10, 2000).astype(np.uint64)
        assert m.lookup_many(q) == jm.lookup_many(q)
        for a in m.starts[:20].tolist():
            assert _lookup(m, a) == _lookup(jm, a)
        assert any(_lookup(m, a) for a in m.starts[:20].tolist())


def _lookup(m, addr: int):
    """PerfMap.lookup's answer, None when it raises NoSymbolFound."""
    try:
        return m.lookup(addr)
    except LookupError:
        return None


@pytest.mark.parametrize("status,want", [
    (b"Name:\tnode\nNSpid:\t42\t7\n", 7),
    (b"Name:\tnode\nNSpid:\t42\n", 42),
    (b"Name:\tnode\nNSpid:\t42\tjunk\n", 42),
    (b"Name:\tnode\n", 42),
])
def test_namespaced_pid_matches_parca_agent_tpus(status, want):
    files = {"/proc/42/status": status}
    assert perfmap.namespaced_pid(FakeFS(files), 42) == want
    assert jax_perfmap.namespaced_pid(JaxFS(files), 42) == want
    assert perfmap.perf_map_path(FakeFS(files), 42) == \
        jax_perfmap.perf_map_path(JaxFS(files), 42)


def test_perf_map_cache_matches_through_rewrites_evict_and_churn():
    text = _perf_map_text(3)
    files = {"/proc/9/status": b"NSpid:\t9\t4\n",
             "/proc/9/root/tmp/perf-4.map": text}
    fs, jfs = FakeFS(dict(files)), JaxFS(dict(files))
    c = perfmap.PerfMapCache(fs=fs, churn_budget=3)
    jc = jax_perfmap.PerfMapCache(fs=jfs, churn_budget=3)
    q = np.array([int(perfmap.parse_perf_map(text).starts[i])
                  for i in range(0, 100, 7)], np.uint64)
    assert c.map_for_pid(9).lookup_many(q) == jc.map_for_pid(9).lookup_many(q)
    for cache in (c, jc):  # unchanged: the cached map
        assert cache.map_for_pid(9) is cache.map_for_pid(9)
    c.evict(9)
    jc.evict(9)
    assert c.map_for_pid(9).names == jc.map_for_pid(9).names
    outcomes = []
    for k in range(5):  # new content every read: the churn budget trips
        body = _perf_map_text(100 + k)
        fs.put("/proc/9/root/tmp/perf-4.map", body)
        jfs.put("/proc/9/root/tmp/perf-4.map", body)
        got = []
        for cache in (c, jc):
            try:
                got.append(cache.map_for_pid(9).names[:3])
            except Exception as e:  # noqa: BLE001 - the outcome compared
                got.append(type(e).__name__)
        assert got[0] == got[1]
        outcomes.append(got[0])
    assert "PerfMapError" in outcomes
    assert c.stats == jc.stats and c.stats["churn_trips_total"] >= 1
    with pytest.raises(FileNotFoundError):
        c.map_for_pid(10)


# -- the symbolizer over the same profiles -----------------------------------


def _window(seed: int, n_pids: int = 8, rows: int = 300):
    """A seeded window and the files its names come from. Each pid maps
    an executable; odd pids also have an anonymous mapping holding JIT
    code and a perf map; every row's user frames mix mapped, anonymous
    and unmapped addresses, and a third of the rows carry kernel
    frames."""
    rng = np.random.default_rng(seed)
    pids = np.arange(100, 100 + n_pids, dtype=np.int32)
    t_pid, t_start, t_end, t_objs = [], [], [], []
    paths = ["/bin/app", ""]
    files = {"/proc/kallsyms": _kallsyms(seed, span=1 << 16)}
    for p in pids.tolist():
        t_pid.append(p), t_start.append(0x400000), t_end.append(0x500000)
        t_objs.append(0)
        if p % 2:
            t_pid.append(p), t_start.append(0x7F0000000000)
            t_end.append(0x7F0000400000), t_objs.append(1)
            files[f"/proc/{p}/status"] = f"NSpid:\t{p}\t{p - 90}\n".encode()
            files[f"/proc/{p}/root/tmp/perf-{p - 90}.map"] = \
                _perf_map_text(seed + p)
    table = dict(
        pids=np.array(t_pid, np.int32), starts=np.array(t_start, np.uint64),
        ends=np.array(t_end, np.uint64),
        offsets=np.zeros(len(t_pid), np.uint64),
        objs=np.array(t_objs, np.int32), obj_paths=tuple(paths),
        obj_buildids=("ab" * 20, ""))
    stacks = np.zeros((rows, formats.STACK_SLOTS), np.uint64)
    ulen = rng.integers(1, 12, rows).astype(np.int32)
    klen = np.where(rng.random(rows) < 0.33,
                    rng.integers(1, 6, rows), 0).astype(np.int32)
    for r in range(rows):
        kind = rng.integers(0, 3, ulen[r])
        u = np.where(kind == 0, 0x400000 + rng.integers(0, 1 << 16, ulen[r]),
                     np.where(kind == 1,
                              0x7F0000000000 + rng.integers(0, 64 << 10,
                                                            ulen[r]),
                              0x1000 + rng.integers(0, 1 << 12, ulen[r])))
        stacks[r, :ulen[r]] = u.astype(np.uint64)
        stacks[r, ulen[r]:ulen[r] + klen[r]] = K0 + rng.integers(
            0, 1 << 20, klen[r]).astype(np.uint64)
    cols = dict(pids=rng.choice(pids, rows).astype(np.int32),
                tids=np.arange(rows, dtype=np.int32),
                counts=rng.integers(1, 50, rows).astype(np.int64),
                user_len=ulen, kernel_len=klen, stacks=stacks)
    snap = formats.WindowSnapshot(mappings=formats.MappingTable(**table),
                                  **cols)
    jsnap = jax_formats.WindowSnapshot(
        mappings=jax_formats.MappingTable(**table), **cols)
    return snap, jsnap, files


def _symbolized(seed: int, quarantined=()):
    snap, jsnap, files = _window(seed)
    profiles = CPUAggregator().aggregate(snap)
    jprofiles = JaxCPU().aggregate(jsnap)
    q, jq = QuarantineRegistry(max_strikes=1), JaxQuarantine(max_strikes=1)
    for pid in quarantined:  # two strikes past max_strikes=1: tripped
        for reg in (q, jq, q, jq):
            reg.record_error(pid, "perfmap.parse", ValueError("x"))
    s = Symbolizer(ksym=ksym.KsymCache(fs=FakeFS(dict(files))),
                   perf=perfmap.PerfMapCache(fs=FakeFS(dict(files))),
                   quarantine=q)
    js = JaxSymbolizer(ksym=jax_ksym.KsymCache(fs=JaxFS(dict(files))),
                       perf=jax_perfmap.PerfMapCache(fs=JaxFS(dict(files))),
                       quarantine=jq)
    s.symbolize(profiles)
    js.symbolize(jprofiles)
    return profiles, jprofiles, s, js


def _mtime_masked(blob: bytes) -> bytes:
    """gzip bytes with the header's mtime (bytes 4-8) zeroed: both
    builders stamp the wall clock's second there, so two builds differ
    when a second boundary falls between them."""
    assert blob[:2] == b"\x1f\x8b"
    return blob[:4] + bytes(4) + blob[8:]


def _same_profiles(profiles, jprofiles) -> None:
    assert [p.pid for p in profiles] == [p.pid for p in jprofiles]
    for p, jp in zip(profiles, jprofiles):
        assert p.functions == jp.functions
        assert p.loc_lines == jp.loc_lines
        assert _mtime_masked(build_pprof(p)) == \
            _mtime_masked(jax_build_pprof(jp))
        assert build_pprof(p, compress=False) == \
            jax_build_pprof(jp, compress=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_symbolizer_matches_parca_agent_tpus_bytes(seed):
    profiles, jprofiles, s, js = _symbolized(seed)
    _same_profiles(profiles, jprofiles)
    names = {f[0] for p in profiles for f in p.functions}
    assert any(n.startswith("ksym_") for n in names)  # kernel frames
    assert any(n.startswith("jit::") for n in names)  # JIT frames
    assert s.last_errors.keys() == js.last_errors.keys() == set()
    # The pprof carries the names: parse one back.
    p = next(p for p in profiles if p.functions)
    got = parse_pprof(build_pprof(p))
    assert {f["name"] for f in got.functions.values()} == \
        {f[0] for f in p.functions}


def test_symbolizer_skips_laddered_pids_alike():
    profiles, jprofiles, _, _ = _symbolized(4, quarantined=(101, 104))
    _same_profiles(profiles, jprofiles)
    by_pid = {p.pid: p for p in profiles}
    assert by_pid[101].functions == [] and by_pid[101].loc_lines is None
    assert by_pid[103].functions


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["symbolize.kernel", "perfmap.parse"])
def test_symbolize_chaos_sites_fail_open_alike(site):
    """An injected error at either site costs the window those names,
    never the window: both packages ship the same profiles."""
    _arm(f"{site}:error")
    profiles, jprofiles, s, js = _symbolized(5)
    _same_profiles(profiles, jprofiles)
    names = {f[0] for p in profiles for f in p.functions}
    kernel = any(n.startswith("ksym_") for n in names)
    jit = any(n.startswith("jit::") for n in names)
    assert (kernel, jit) == ((False, True) if site == "symbolize.kernel"
                             else (True, False))
    assert s.last_errors.keys() == js.last_errors.keys() != set()


def test_loop_stewards_the_collector_and_restores_it():
    """manage_gc: the first window runs under the default collector, the
    later ones with it frozen and disabled; run() restores it."""
    import gc

    from parca_agent_tpu_torch.profiler.cpu import AggregateLoop

    snaps = [_window(s)[0] for s in (7, 8, 9)]
    seen = []
    loop = AggregateLoop(_source(snaps), CPUAggregator(),
                         symbolizer=Symbolizer(), manage_gc=True,
                         on_window=lambda r: seen.append(gc.isenabled()),
                         device_timeout_s=None, duration_s=0.0)
    assert gc.isenabled()
    loop.run()
    assert seen == [True, False, False]
    assert gc.isenabled() and gc.get_freeze_count() == 0


def _source(snaps):
    """A capture source over a list of windows."""
    queue = list(snaps)

    class Source:
        def poll(self):
            return queue.pop(0) if queue else None

    return Source()


def test_fast_encode_loop_refuses_a_symbolizer():
    from parca_agent_tpu_torch.aggregator.dict import DictAggregator

    with pytest.raises(ValueError, match="unsymbolized"):
        CPUProfiler(None, DictAggregator(capacity=1 << 10, device="cpu"),
                    symbolizer=Symbolizer(), encode_pipeline=False)


# -- the CLI without --fast-encode --------------------------------------------


def _port_snap(w):
    """parca_agent_tpu's window as the port's WindowSnapshot."""
    def fields(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}

    return formats.WindowSnapshot(**{
        **fields(w), "mappings": formats.MappingTable(**fields(w.mappings))})


def test_cli_without_fast_encode_names_kernel_frames(tmp_path, monkeypatch,
                                                     capsys):
    """The scalar path's profiles carry kernel names from the kallsyms
    (a FakeFS behind the CLI's KsymCache), equal to those
    parca_agent_tpu's aggregator and symbolizer give the same windows."""
    spec = dict(n_pids=20, n_unique_stacks=600, total_samples=20_000)
    text = _kallsyms(21, n=2000, span=1 << 22)

    def port_ksym(*a, **kw):
        return ksym.KsymCache(fs=FakeFS({"/proc/kallsyms": text}))

    monkeypatch.setattr(port_symbolize, "KsymCache", port_ksym)
    windows = [_port_snap(jax_generate(JaxSpec(seed=s, **spec)))
               for s in (1, 2)]
    queue = list(windows)

    class Source:
        def poll(self):
            return queue.pop(0) if queue else None

    monkeypatch.setattr(cli, "SyntheticSource", lambda n: Source())
    store = tmp_path / "store"
    code = cli.run(["--device", "cpu", "--http-address", "127.0.0.1:0",
                    "--capture", "synthetic",
                    "--aggregator", "cpu", "--windows", "2",
                    "--profiling-duration", "0.05",
                    "--local-store-directory", str(store)])
    assert code == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    wins = [ln for ln in lines if "window" in ln]
    assert len(wins) == 2 and all("symbolize_ms" in w for w in wins)
    runtime = next(ln["runtime"] for ln in lines if "runtime" in ln)
    assert "symbolize" in runtime["trace"]["stage_percentiles"]
    assert runtime["process_identity"]["checks_total"] >= 0

    # parca_agent_tpu on the same windows: kernel names per pid, as sets
    # of (normalized address, name) over every window.
    jsym = JaxSymbolizer(ksym=jax_ksym.KsymCache(
        fs=JaxFS({"/proc/kallsyms": text})))
    want: dict[int, set] = {}
    for s in (1, 2):
        profs = JaxCPU().aggregate(jax_generate(JaxSpec(seed=s, **spec)))
        jsym.symbolize(profs)
        for p in profs:
            for i, lines_ in enumerate(p.loc_lines or []):
                for fid, _ in lines_:
                    want.setdefault(p.pid, set()).add(
                        (int(p.loc_normalized[i]), p.functions[fid - 1][0]))
    got: dict[int, set] = {}
    for f in store.glob("*.pb.gz"):
        prof = parse_pprof(f.read_bytes())
        pid = int(f.name.split("=")[1].split(".")[0])
        for loc in prof.locations.values():
            for fid, _ in loc["lines"]:
                got.setdefault(pid, set()).add(
                    (loc["address"], prof.functions[fid]["name"]))
    assert got == want
    assert sum(len(v) for v in got.values()) > 100
