"""The port's ELF writer and debuginfo (elf/writer.py, debuginfo/)
against parca_agent_tpu's.

A binary built with gcc here, the checked-in fixtures (read only) and
seeded corruptions of them go through both packages: filter_elf,
compose_elf, extract_debuginfo and ElfWriter must give the same bytes
(or the same error), the Finder the same paths over the same FakeFS,
and the DebuginfoManager the same uploads and counters with a fake
client. Last, the port's window loop hands each window's object files to
the manager, as parca_agent_tpu's profiler does.
"""

from __future__ import annotations

import dataclasses
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.debuginfo import extract as jax_extract
from parca_agent_tpu.debuginfo import find as jax_find
from parca_agent_tpu.debuginfo import manager as jax_manager
from parca_agent_tpu.elf import reader as jax_reader
from parca_agent_tpu.elf import writer as jax_writer
from parca_agent_tpu.elf.buildid import gnu_build_id as jax_gnu_build_id
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
from parca_agent_tpu_torch.capture.synthetic import SyntheticSpec, generate
from parca_agent_tpu_torch.debuginfo import extract, find, manager
from parca_agent_tpu_torch.elf import reader, writer
from parca_agent_tpu_torch.elf.buildid import gnu_build_id
from parca_agent_tpu_torch.profiler.cpu import AggregateLoop, window_objects
from parca_agent_tpu_torch.utils.vfs import FakeFS

torch.set_num_threads(1)

FIXDIR = Path(__file__).resolve().parent / "fixtures"
FIXTURES = ("fixture_nopie", "fixture_pie", "fixture_pie_nofp",
            "fixture_plt")


@pytest.fixture(scope="module")
def binary(tmp_path_factory) -> bytes:
    if shutil.which("gcc") is None:
        pytest.skip("gcc is not installed")
    d = tmp_path_factory.mktemp("dbg")
    src = d / "p.c"
    src.write_text(
        "int global_counter = 7;\n"
        "__attribute__((noinline)) int work(int x) "
        "{ return x * 2 + global_counter; }\n"
        "int main(void) { return work(5); }\n")
    out = d / "p"
    subprocess.run(["gcc", "-g", "-O0", "-Wl,--build-id=sha1", str(src),
                    "-o", str(out)], check=True, capture_output=True)
    return out.read_bytes()


def _inputs(binary):
    return [binary] + [(FIXDIR / n).read_bytes() for n in FIXTURES]


def _outcome(fn, *a):
    try:
        return fn(*a)
    except Exception as e:  # noqa: BLE001 - the outcome compared
        return type(e).__name__


def _keep_debug(s) -> bool:
    return s.name.startswith(".debug_") or s.name in (".symtab", ".strtab")


def test_filter_and_extract_bytes_match(binary):
    for data in _inputs(binary):
        out = extract.extract_debuginfo(data)
        assert out == jax_extract.extract_debuginfo(data)
        assert writer.filter_elf(data, _keep_debug) == \
            jax_writer.filter_elf(data, _keep_debug)
        ef = reader.ElfFile(out)  # a valid ELF that kept the notes
        assert ef.section(".note.gnu.build-id") is not None \
            or reader.ElfFile(data).section(".note.gnu.build-id") is None
        assert len(out) < len(data)
    assert extract.KEEP_SECTIONS == jax_extract.KEEP_SECTIONS


def test_compose_bytes_match(binary):
    def runtime(s):
        return not s.name.startswith(".debug_")

    def debug(s):
        return s.name.startswith(".debug_") or s.name == ".symtab"

    for data in _inputs(binary):
        dbg = extract.extract_debuginfo(data)
        parts = [(data, runtime), (dbg, debug)]
        assert writer.compose_elf(parts) == jax_writer.compose_elf(parts)
        assert writer.compose_elf(parts[::-1]) == \
            jax_writer.compose_elf(parts[::-1])


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_inputs_give_the_same_outcome(seed, binary):
    rng = np.random.default_rng(seed)
    data = _inputs(binary)[seed % 5]
    for _ in range(30):
        buf = bytearray(data)
        if rng.random() < 0.5:
            buf = buf[:int(rng.integers(16, len(buf)))]
        else:
            for pos in rng.integers(0, min(len(buf), 4096), 6):
                buf[int(pos)] = int(rng.integers(0, 256))
        buf = bytes(buf)
        assert _outcome(extract.extract_debuginfo, buf) == \
            _outcome(jax_extract.extract_debuginfo, buf)


def test_writer_serializes_alike():
    payload = b"prog.debug\x00\x00" + struct.pack("<I", 0xDEADBEEF)
    outs = []
    for rd, wr in ((reader, writer), (jax_reader, jax_writer)):
        w = wr.ElfWriter(2, 0x3E)
        w.add_section(rd.Section(".gnu_debuglink", 1, 0, 0, 0, len(payload),
                                 0, 0, 4, 0), payload)
        w.add_section(rd.Section(".note.x", 7, 2, 0x400, 0, 8, 0, 0, 4, 0),
                      b"\x01" * 8)
        w.add_segment(rd.Segment(1, 5, 0, 0x400000, 0x400000, 0x1000,
                                 0x1000, 0x1000))
        outs.append(w.serialize())
    assert outs[0] == outs[1]
    ef = reader.ElfFile(outs[0])
    assert find.debuglink(ef) == jax_find.debuglink(
        jax_reader.ElfFile(outs[0])) == ("prog.debug", 0xDEADBEEF)


def _debuglinked(binary, name="prog.debug"):
    dbg = extract.extract_debuginfo(binary)
    link = name.encode() + b"\x00\x00" + struct.pack("<I", zlib.crc32(dbg))
    w = writer.ElfWriter(2, 0x3E)
    w.add_section(reader.Section(".gnu_debuglink", 1, 0, 0, 0, len(link), 0,
                                 0, 4, 0), link)
    return w.serialize(), dbg


def test_finder_results_match(binary):
    bid = gnu_build_id(reader.ElfFile(binary))
    assert bid == jax_gnu_build_id(jax_reader.ElfFile(binary))
    host, dbg = _debuglinked(binary)
    worlds = [
        {f"/proc/9/root/usr/lib/debug/.build-id/{bid[:2]}/{bid[2:]}.debug":
            b"x", "/proc/9/root/app/prog": binary},
        {"/proc/9/root/app/prog": host,
         "/proc/9/root/app/prog.debug": b"wrong-crc",
         "/proc/9/root/app/.debug/prog.debug": dbg},
        {"/proc/9/root/app/prog": host,
         "/proc/9/root/usr/lib/debug/app/prog.debug": dbg},
        {"/proc/9/root/app/prog": binary,
         "/proc/9/root/usr/lib/debug/app/prog.debug": b"y"},
        {"/proc/9/root/app/prog": b"not an elf"},
        {},
    ]
    found = []
    for files in worlds:
        got = find.Finder(fs=FakeFS(dict(files))).find(9, "/app/prog")
        assert got == jax_find.Finder(fs=JaxFS(dict(files))).find(
            9, "/app/prog")
        found.append(got)
    assert found[0].endswith(f"{bid[2:]}.debug")
    assert found[1] == "/proc/9/root/app/.debug/prog.debug"
    assert found[4] is None and found[5] is None


class _Client:
    def __init__(self, existing=()):
        self.existing = set(existing)
        self.uploads = []

    def exists(self, build_id, hash_):
        return build_id in self.existing

    def upload(self, build_id, hash_, data):
        self.uploads.append((build_id, hash_, len(data)))
        self.existing.add(build_id)


@pytest.mark.parametrize("strip", [True, False])
@pytest.mark.parametrize("present", [False, True])
def test_manager_matches_parca_agent_tpus(binary, strip, present):
    bid = gnu_build_id(reader.ElfFile(binary))
    host, dbg = _debuglinked(binary)
    files = {"/proc/9/root/app/prog": binary,
             "/proc/10/root/app/other": host,
             "/proc/10/root/app/.debug/prog.debug": dbg,
             "/proc/11/root/app/junk": b"\x7fELF" + b"\x00" * 40}
    objs = [(9, "/app/prog", bid), (10, "/app/other", "cd" * 20),
            (11, "/app/junk", "ef" * 20), (12, "/gone", "01" * 20),
            (9, "/app/prog", "")]
    now = {"t": 1000.0}
    results = []
    for mod, fs in ((manager, FakeFS(dict(files))),
                    (jax_manager, JaxFS(dict(files)))):
        client = _Client(existing=[bid] if present else ())
        mgr = mod.DebuginfoManager(client=client, fs=fs, strip=strip,
                                   exists_ttl_s=60.0,
                                   clock=lambda: now["t"])
        mgr.ensure_uploaded(objs)
        mgr.ensure_uploaded(objs)  # the next window: deduplicated
        mgr.drain()
        now["t"] += 61.0           # past the lease: asked again
        mgr.ensure_uploaded(objs)
        mgr.close()
        now["t"] = 1000.0
        results.append((sorted(client.uploads),
                        dataclasses.asdict(mgr.stats)))
    assert results[0] == results[1]
    assert results[0][1]["errors"] >= 2


def test_noop_client_alike():
    for mod in (manager, jax_manager):
        c = mod.NoopClient()
        assert c.exists("x", "y") is True
        c.upload("x", "y", b"data")


class _Recorder:
    def __init__(self):
        self.calls = []

    def ensure_uploaded(self, objs):
        self.calls.append(list(objs))


def test_window_loop_hands_each_windows_objects_to_the_manager():
    snaps = [generate(SyntheticSpec(n_pids=6, n_unique_stacks=200,
                                    total_samples=2000, seed=s))
             for s in (1, 2)]
    queue = list(snaps)

    class Source:
        def poll(self):
            return queue.pop(0) if queue else None

    rec = _Recorder()
    loop = AggregateLoop(Source(), CPUAggregator(), debuginfo=rec,
                         device_timeout_s=None, duration_s=0.01)
    while loop.run_iteration():
        pass
    assert len(rec.calls) == 2
    for snap, call in zip(snaps, rec.calls):
        mt = snap.mappings
        want = []
        for i, path in enumerate(mt.obj_paths):
            rows = (mt.objs == i).nonzero()[0]
            if len(rows) and path:
                want.append((int(mt.pids[rows[0]]), path,
                             mt.obj_buildids[i]))
        assert call == want == window_objects(snap) and want
