"""The port's host view of processes (process/maps.py, process/objectfile.py,
elf/, utils/vfs.py) and its procfs capture source against
parca_agent_tpu's.

The maps parser, the per-pid map cache, the object-file cache on the
repo's ELF fixtures (build ids, bases, TTL expiry) and the mapping
table's bases are held against the original, as tests/test_process.py
sets them. ProcfsSampler on a FakeFS with a fake clock gives the same
snapshots through both packages, and those snapshots give the same
counts, ids and pprof bytes through each package's DictAggregator and
window encoder. Last, the port's CLI samples the real machine with
--capture procfs, and --capture perf degrades to procfs only when
perf_event_open is refused for lack of permission.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.aggregator.dict import DictAggregator as JaxDict
from parca_agent_tpu.capture.procfs import ProcfsSampler as JaxProcfs
from parca_agent_tpu.capture.procfs import read_cpu_ticks as jax_ticks
from parca_agent_tpu.pprof.window_encoder import WindowEncoder as JaxEncoder
from parca_agent_tpu.process import maps as jax_maps
from parca_agent_tpu.process.objectfile import ObjectFileCache as JaxObjs
from parca_agent_tpu.utils import vfs as jax_vfs
from parca_agent_tpu_torch.aggregator.dict import DictAggregator
from parca_agent_tpu_torch.capture.procfs import ProcfsSampler, read_cpu_ticks
from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.pprof.builder import parse_pprof
from parca_agent_tpu_torch.pprof.window_encoder import WindowEncoder
from parca_agent_tpu_torch.process import maps
from parca_agent_tpu_torch.process.objectfile import ObjectFileCache
from parca_agent_tpu_torch.utils import vfs
from parca_agent_tpu_torch.utils.poison import PoisonInput

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"

MAPS = (
    b"00400000-00452000 r-xp 00000000 08:02 1234 /usr/bin/app\n"
    b"00651000-00652000 rw-p 00051000 08:02 1234 /usr/bin/app\n"
    b"7f3c00000000-7f3c00200000 r-xp 00000000 08:02 999 /usr/lib/libc.so.6\n"
    b"7ffc12345000-7ffc12366000 rw-p 00000000 00:00 0 [stack]\n"
    b"7f3c00300000-7f3c00301000 r-xp 00000000 00:00 0 \n"
    b"ffffffffff600000-ffffffffff601000 --xp 00000000 00:00 0 [vsyscall]\n"
)
# Lines a hostile or broken maps file may hold: short, unparsable, an
# address past 64 bits, a path with spaces.
HOSTILE = (
    b"garbage\n"
    b"zz-10 r-xp 0 08:02 1 /x\n"
    b"1ffffffffffffffff-20000000000000000 r-xp 00000000 08:02 5 /big\n"
    b"90000000-90001000 r-xp 00001000 08:02 6 /srv/my app/lib.so\n"
)


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


# -- maps -----------------------------------------------------------------------


@pytest.mark.parametrize("data", [MAPS, MAPS + HOSTILE, b""])
def test_parse_proc_maps_equals_jax(data):
    got = maps.parse_proc_maps(data)
    want = jax_maps.parse_proc_maps(data)
    assert [dataclass_tuple(m) for m in got] == \
        [dataclass_tuple(m) for m in want]
    assert [(m.executable, m.file_backed) for m in got] == \
        [(m.executable, m.file_backed) for m in want]


def dataclass_tuple(m):
    return (m.start, m.end, m.perms, m.offset, m.dev, m.inode, m.path)


def test_parse_proc_maps_fields():
    got = maps.parse_proc_maps(MAPS)
    assert len(got) == 6
    app = got[0]
    assert (app.start, app.end, app.offset) == (0x400000, 0x452000, 0)
    assert app.perms == "r-xp" and app.executable and app.file_backed
    assert got[3].path == "[stack]" and not got[3].file_backed
    assert got[4].path == "" and not got[4].file_backed  # anon exec
    assert got[5].path == "[vsyscall]" and not got[5].file_backed


def test_map_cache_invalidation():
    fs = vfs.FakeFS({"/proc/7/maps": MAPS})
    c = maps.ProcessMapCache(fs=fs)
    a = c.mappings_for_pid(7)
    assert c.mappings_for_pid(7) is a
    fs.put("/proc/7/maps",
           MAPS + b"90000000-90001000 r-xp 00000000 08:02 2 /x\n")
    b = c.mappings_for_pid(7)
    assert b is not a and len(b) == len(a) + 1
    assert [m.path for m in c.executable_mappings(7)] == [
        "/usr/bin/app", "/usr/lib/libc.so.6", "/x"]
    c.evict(7)
    assert c.mappings_for_pid(7) is not b
    with pytest.raises(OSError):
        c.mappings_for_pid(8)
    with pytest.raises(OSError):
        maps.ProcessMapCache(fs=vfs.ErrorFS(PermissionError("no"))) \
            .mappings_for_pid(7)


def test_map_cache_rejects_a_maps_bomb():
    line = b"1000-2000 r-xp 00000000 08:02 1 /x\n"
    fs = vfs.FakeFS({"/proc/7/maps": line * (maps._MAX_ROWS + 1)})
    with pytest.raises(maps.MapsError) as e:
        maps.ProcessMapCache(fs=fs).mappings_for_pid(7)
    assert isinstance(e.value, PoisonInput) and e.value.site == "maps.parse"


def test_build_mapping_table_dedups_objects_as_jax():
    per = {7: maps.parse_proc_maps(MAPS), 9: maps.parse_proc_maps(MAPS)}
    jper = {7: jax_maps.parse_proc_maps(MAPS),
            9: jax_maps.parse_proc_maps(MAPS)}
    ids = {"/usr/lib/libc.so.6": "cafe"}
    table = maps.build_mapping_table(per, build_ids=ids)
    jtable = jax_maps.build_mapping_table(jper, build_ids=ids)
    assert list(table.pids) == [7, 7, 9, 9]
    _same_table(table, jtable)
    assert table.obj_buildids[table.obj_paths.index(
        "/usr/lib/libc.so.6")] == "cafe"


def _same_table(table, jtable):
    for f in ("pids", "starts", "ends", "offsets", "objs", "bases"):
        np.testing.assert_array_equal(getattr(table, f), getattr(jtable, f))
    assert table.obj_paths == jtable.obj_paths
    assert table.obj_buildids == jtable.obj_buildids


# -- object files ------------------------------------------------------------


def _pie_line(data: bytes, bias: int = 0x7F0000000000) -> bytes:
    seg = ElfFile(data).exec_load_segment()
    offset = (seg.offset // 4096) * 4096
    return (f"{bias + offset:x}-{bias + offset + seg.filesz:x} r-xp "
            f"{offset:08x} 08:02 42 /app/p\n").encode()


@pytest.mark.parametrize("name", ["fixture_pie", "fixture_pie_nofp",
                                  "fixture_nopie", "fixture_plt"])
def test_objectfile_cache_equals_jax(name):
    data = _fixture(name)
    files = {"/proc/5/maps": _pie_line(data),
             "/proc/5/root/app/p": data}
    got = []
    for fsmod, mapsmod, cache_cls in ((vfs, maps, ObjectFileCache),
                                      (jax_vfs, jax_maps, JaxObjs)):
        fs = fsmod.FakeFS(files)
        m = mapsmod.ProcessMapCache(fs=fs).executable_mappings(5)
        cache = cache_cls(fs=fs)
        obj = cache.get(5, m[0])
        assert obj is not None and obj.build_id
        assert cache.get(5, m[0]) is obj and cache.hits == 1
        runtime = obj.base() + obj.exec_segment.vaddr + 0x10
        got.append((obj.build_id, obj.e_type, obj.base(),
                    obj.normalize(runtime), cache.build_ids({5: m})))
    assert got[0] == got[1]
    assert got[0][3] == ElfFile(data).exec_load_segment().vaddr + 0x10


def test_objectfile_unreadable_and_shared_files():
    data = _fixture("fixture_pie")
    fs = vfs.FakeFS({f"/proc/{p}/root/app/p": data for p in (5, 6, 7)})
    cache = ObjectFileCache(fs=fs)
    seg = ElfFile(data).exec_load_segment()
    pm = maps.ProcMapping(0x7F0000001000, 0x7F0000001000 + seg.filesz,
                          "r-xp", 0x1000, "08:02", 42, "/app/p")
    objs = [cache.get(pid, pm) for pid in (5, 6, 7)]
    assert all(o is not None for o in objs)
    assert len(cache._elves) == 1  # one parse for every pid
    assert len({o.build_id for o in objs}) == 1
    gone = maps.ProcMapping(0x1000, 0x2000, "r-xp", 0, "08:02", 77, "/gone")
    assert cache.get(5, gone) is None
    # A corrupt ELF degrades to "cannot normalize", never raises.
    fs.put("/proc/8/root/app/p", b"\x7fELF" + b"\x00" * 10)
    assert cache.get(8, pm) is None


def test_objectfile_ttl_expiry():
    clock = [0.0]
    line = b"1000-2000 r-xp 00000000 08:02 42 /app/p\n"
    fs = vfs.FakeFS({"/proc/5/maps": line,
                     "/proc/5/root/app/p": _fixture("fixture_pie")})
    m = maps.parse_proc_maps(line)[0]
    cache = ObjectFileCache(fs=fs, ttl_s=10.0, clock=lambda: clock[0])
    a = cache.get(5, m)
    clock[0] = 9.0
    assert cache.get(5, m) is a
    clock[0] = 11.0
    b = cache.get(5, m)
    assert a is not None and b is not None and b is not a
    assert (cache.hits, cache.misses) == (1, 2)


def test_mapping_table_bases_equal_jax():
    """A non-PIE fixture whose exec segment has p_vaddr != p_offset
    normalizes to its link address (base 0), a PIE to its load bias, an
    unreadable object and a table without an object cache to start -
    offset: as parca_agent_tpu's table."""
    nopie, pie = _fixture("fixture_nopie"), _fixture("fixture_pie")
    seg = ElfFile(nopie).exec_load_segment()
    assert seg.vaddr != seg.offset
    files = {"/proc/123/root/bin/nopie": nopie, "/proc/124/root/app/p": pie}
    rows = {123: (seg.vaddr, seg.vaddr + seg.filesz, seg.offset,
                  "/bin/nopie"),
            124: (0x7F0000001000, 0x7F0000002000, 0x1000, "/app/p"),
            125: (0x7F0000001000, 0x7F0000002000, 0x1000, "/lib/x.so")}
    tables = []
    for fsmod, mapsmod, cache_cls in ((vfs, maps, ObjectFileCache),
                                      (jax_vfs, jax_maps, JaxObjs)):
        per = {pid: [mapsmod.ProcMapping(s, e, "r-xp", o, "fd:00", 42, p)]
               for pid, (s, e, o, p) in rows.items()}
        cache = cache_cls(fs=fsmod.FakeFS(files))
        tables.append((mapsmod.build_mapping_table(
            per, cache.build_ids(per), objcache=cache),
            mapsmod.build_mapping_table(per)))
    for got, want in zip(*tables):
        _same_table(got, want)
    with_cache, without = tables[0]
    assert [int(b) for b in with_cache.bases] == [
        0, 0x7F0000001000 - 0x1000, 0x7F0000001000 - 0x1000]
    assert [int(b) for b in without.bases] == [
        seg.vaddr - seg.offset, 0x7F0000000000, 0x7F0000000000]


# -- the procfs sampler ---------------------------------------------------------


def _stat(pid: int, comm: str, ticks: int) -> bytes:
    utime, stime = ticks - ticks // 3, ticks // 3
    return (f"{pid} ({comm}) S 1 1 1 0 -1 4194560 0 0 0 0 {utime} {stime} "
            "0 0 20 0 1 0 100 0 0").encode()


class World:
    """A scripted /proc in one package's FakeFS: a few processes (a PIE,
    a non-PIE, one whose binary is unreadable, one whose comm holds
    parentheses and spaces, one born mid-run, one that exits) whose CPU
    ticks move by a seeded schedule at every sleep of the sampler."""

    def __init__(self, vfsmod, seed: int):
        self.rng = np.random.default_rng(seed)
        pie, nopie = _fixture("fixture_pie"), _fixture("fixture_nopie")
        nseg = ElfFile(nopie).exec_load_segment()
        self.fs = vfsmod.FakeFS({
            "/proc/self": b"",
            "/proc/100/root/app/p": pie,
            "/proc/200/root/bin/nopie": nopie,
            "/proc/400/root/app/p": pie,
            "/proc/500/root/app/p": pie,
        })
        self.maps = {
            100: _pie_line(pie),
            200: (f"{nseg.vaddr:x}-{nseg.vaddr + nseg.filesz:x} r-xp "
                  f"{nseg.offset:08x} fd:00 7 /bin/nopie\n").encode(),
            300: b"7f0000001000-7f0000002000 r-xp 00001000 08:02 9 "
                 b"/gone/bin\n",
            400: _pie_line(pie, 0x7E0000000000),
            500: _pie_line(pie, 0x7D0000000000),
        }
        self.comm = {100: "app", 200: "no pie", 300: "gone",
                     400: "a) b (c", 500: "late"}
        self.ticks = {100: 50, 200: 10, 300: 5, 400: 0}
        self.step_no = 0
        self._write()

    def _write(self):
        for pid, t in self.ticks.items():
            self.fs.put(f"/proc/{pid}/stat", _stat(pid, self.comm[pid], t))
            self.fs.put(f"/proc/{pid}/maps", self.maps[pid])

    def step(self):
        self.step_no += 1
        for pid in self.ticks:
            self.ticks[pid] += int(self.rng.integers(0, 30))
        if self.step_no == 2:
            self.ticks[500] = 7  # born mid-window
        if self.step_no == 5:
            # pid 300 exits: its files go.
            del self.ticks[300]
            for f in ("stat", "maps"):
                self.fs.files.pop(f"/proc/300/{f}")
        self._write()


def _sampler(cls, vfsmod, seed, world=None):
    world = world or World(vfsmod, seed)
    clock = [1000.0]

    def sleep(dt):
        clock[0] += dt
        world.step()

    return cls(fs=world.fs, frequency_hz=97, window_s=2.0, poll_hz=2.0,
               clock=lambda: clock[0], sleep=sleep)


def _same_snapshot(a, b):
    for f in ("pids", "tids", "counts", "user_len", "kernel_len", "stacks"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.period_ns, a.window_ns) == (b.period_ns, b.window_ns)
    _same_table(a.mappings, b.mappings)


def test_read_cpu_ticks_equals_jax():
    fs, jfs = vfs.FakeFS(), jax_vfs.FakeFS()
    cases = {1: _stat(1, "a) b (c", 30), 2: b"2 (x) S 1", 3: b"garbage",
             4: _stat(4, "sp ace", 0), 5: b"5 (x) S " + b"z " * 20}
    for pid, data in cases.items():
        fs.put(f"/proc/{pid}/stat", data)
        jfs.put(f"/proc/{pid}/stat", data)
    for pid in (*cases, 9):
        assert read_cpu_ticks(fs, pid) == jax_ticks(jfs, pid)
    assert read_cpu_ticks(fs, 1) == 30


@pytest.mark.parametrize("seed", [0, 1])
def test_procfs_sampler_snapshots_and_pprof_equal_jax(seed):
    """Three windows of the scripted /proc through both packages' samplers:
    equal snapshots; through each package's DictAggregator and window
    encoder, equal counts, ids and pprof bytes."""
    samplers = (_sampler(ProcfsSampler, vfs, seed),
                _sampler(JaxProcfs, jax_vfs, seed))
    agg = DictAggregator(capacity=1 << 10, device="cpu")
    jagg = JaxDict(capacity=1 << 10)
    enc, jenc = WindowEncoder(agg), JaxEncoder(jagg)
    seen = set()
    for w in range(3):
        snap, jsnap = (s.poll() for s in samplers)
        _same_snapshot(snap, jsnap)
        assert len(snap) > 0 and snap.total_samples() > 0
        seen |= set(snap.pids.tolist())
        c = np.asarray(agg.window_counts(snap))
        jc = np.asarray(jagg.window_counts(jsnap))
        # Counts by stack id: equal ids too.
        np.testing.assert_array_equal(c, jc)
        args = (snap.time_ns, snap.window_ns, snap.period_ns)
        out, jout = enc.encode(c.copy(), *args), jenc.encode(jc.copy(), *args)
        assert [p for p, _ in out] == [p for p, _ in jout]
        for (pid, b), (_, jb) in zip(out, jout):
            assert bytes(b) == bytes(jb), (w, pid)
            prof = parse_pprof(bytes(b))
            assert sum(v[0] for _, v, _ in prof.samples) == \
                int(snap.counts[snap.pids == pid].sum())
    assert {100, 200, 400, 500} <= seen
    # The non-PIE's frame is its ELF entry at its link address.
    nopie = ElfFile(_fixture("fixture_nopie"))
    row = np.flatnonzero(snap.pids == 200)[0]
    assert int(snap.stacks[row, 0]) == nopie.entry


def test_procfs_sampler_survives_poison_maps():
    """A pid whose maps file is a bomb degrades to no row; the window
    goes on for the others."""
    world = World(vfs, 3)
    line = b"1000-2000 r-xp 00000000 08:02 1 /x\n"
    world.maps[100] = line * (maps._MAX_ROWS + 1)
    snap = _sampler(ProcfsSampler, vfs, 3, world).poll()
    assert 100 not in set(snap.pids.tolist())
    assert 200 in set(snap.pids.tolist())


# -- the CLI on the real machine ---------------------------------------------


def test_cli_procfs_writes_profiles_with_mass(tmp_path):
    store = tmp_path / "store"
    burn = subprocess.Popen(
        [sys.executable, "-c", "while True:\n sum(i*i for i in range(4000))"],
        env=_env())
    try:
        r = subprocess.run(
            [sys.executable, "-m", "parca_agent_tpu_torch", "--device", "cpu",
             "--http-address", "127.0.0.1:0",
             "--capture", "procfs", "--aggregator", "dict", "--fast-encode",
             "--windows", "2", "--profiling-duration", "1",
             "--local-store-directory", str(store)],
            env=_env(), cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
    finally:
        burn.kill()
        burn.wait()
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    windows = [ln for ln in lines if "window" in ln]
    assert len(windows) == 2
    assert all(ln["capture"] == "procfs" for ln in windows)
    assert lines[-1] == {"capture": {"requested": "procfs",
                                     "source": "procfs"}}
    files = sorted(store.glob("*.pb.gz"))
    assert len(files) == sum(ln["profiles"] for ln in windows)
    mass = sum(v[0] for f in files
               for _, v, _ in parse_pprof(f.read_bytes()).samples)
    assert mass > 0 and mass == sum(ln["mass"] for ln in windows)
    assert any(f.name.startswith(f"pid={burn.pid}.") for f in files)


_REFUSE = (
    "import sys\n"
    "from parca_agent_tpu_torch import cli\n"
    "from parca_agent_tpu_torch.capture import live\n"
    "def refuse(self, *a, **k):\n"
    "    raise live.SamplerUnavailable('perf_event_open failed',\n"
    "                                  errno=int(sys.argv[1]))\n"
    "live.PerfEventSampler.__init__ = refuse\n"
    "sys.exit(cli.run(sys.argv[2:]))\n")


@pytest.mark.parametrize("err", [13, 1, 19])
def test_cli_perf_degrades_to_procfs_only_when_refused(tmp_path, err):
    """EACCES (13) or EPERM (1): the run goes on with procfs, logs the
    errno, and its lines name procfs; any other errno (ENODEV, 19)
    stops the run."""
    r = subprocess.run(
        [sys.executable, "-c", _REFUSE, str(err), "--device", "cpu",
         "--http-address", "127.0.0.1:0",
         "--capture", "perf", "--aggregator", "dict", "--fast-encode",
         "--windows", "1", "--profiling-duration", "0.5",
         "--local-store-directory", str(tmp_path / "store")],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    if err == 19:
        assert r.returncode != 0
        assert "perf_event_open failed" in r.stderr
        assert not (tmp_path / "store").exists()
        return
    assert r.returncode == 0, r.stderr
    assert f"errno={err}" in r.stderr and "falling back to procfs" in r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["capture"] == "procfs"
    assert lines[-1] == {"capture": {"requested": "perf",
                                     "source": "procfs"}}
