"""The port's .eh_frame parser, CFA interpreter and unwind tables
(dwarf/, unwind/table.py, elf/executable.py) against parca_agent_tpu's.

The checked-in fixtures under tests/fixtures/ (read only), the host's
libc, and seeded corruptions of the fixtures' .eh_frame go through both
packages: the FDEs, every row execute_fde yields, the compact tables
and the outcome of a corrupt section must be equal, and each fixture's
table must print as its golden dump under tests/fixtures/golden/. The
per-process builder over a FakeFS (the ASLR bias, the quarantine charge
of a poisoned object, the ``unwind.build`` chaos site) must agree too.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from parca_agent_tpu.dwarf import frame as jax_frame
from parca_agent_tpu.elf.executable import is_aslr_eligible as jax_aslr
from parca_agent_tpu.elf.reader import ElfFile as JaxElf
from parca_agent_tpu.process.maps import ProcMapping as JaxMapping
from parca_agent_tpu.runtime.quarantine import (
    QuarantineRegistry as JaxQuarantine,
)
from parca_agent_tpu.tools.eh_frame import format_table
from parca_agent_tpu.unwind import table as jax_table
from parca_agent_tpu.utils import faults as jax_faults
from parca_agent_tpu.utils.vfs import FakeFS as JaxFS
from parca_agent_tpu_torch.dwarf import frame
from parca_agent_tpu_torch.tools.eh_frame import (
    format_table as port_format_table,
)
from parca_agent_tpu_torch.elf.executable import is_aslr_eligible
from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.process.maps import ProcMapping
from parca_agent_tpu_torch.runtime.quarantine import QuarantineRegistry
from parca_agent_tpu_torch.unwind import table
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import FakeFS

torch.set_num_threads(1)

FIXDIR = Path(__file__).resolve().parent / "fixtures"
FIXTURES = ("fixture_nopie", "fixture_pie", "fixture_pie_nofp",
            "fixture_plt")
LIBC = ("/usr/lib/x86_64-linux-gnu/libc.so.6",
        "/lib/x86_64-linux-gnu/libc.so.6", "/usr/lib64/libc.so.6")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.install(None)
    jax_faults.install(None)


def _eh(data: bytes):
    ef = ElfFile(data)
    sec = ef.section(".eh_frame")
    return ef.section_data(sec), sec.addr


def _libc() -> bytes:
    for p in LIBC:
        try:
            return Path(p).read_bytes()
        except OSError:
            continue
    pytest.skip("no libc.so.6 on this host")


def _astuple(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("name", FIXTURES + ("libc",))
def test_fdes_and_rows_match_parca_agent_tpus(name):
    data = _libc() if name == "libc" else (FIXDIR / name).read_bytes()
    eh, addr = _eh(data)
    fdes = frame.parse_eh_frame(eh, addr)
    jfdes = jax_frame.parse_eh_frame(eh, addr)
    assert len(fdes) == len(jfdes) >= 5
    n_rows = 0
    for f, jf in zip(fdes, jfdes):
        assert _astuple(f) == _astuple(jf)
        assert f.pc_end == jf.pc_end
        outs = []
        for mod, fde in ((frame, f), (jax_frame, jf)):
            try:
                outs.append([_astuple(r) for r in mod.execute_fde(fde)])
            except Exception as e:  # noqa: BLE001 - the outcome compared
                outs.append(type(e).__name__)
        assert outs[0] == outs[1]
        n_rows += len(outs[0]) if isinstance(outs[0], list) else 0
    assert n_rows > len(fdes)


@pytest.mark.parametrize("name", FIXTURES + ("libc",))
def test_compact_tables_match_and_print_as_golden(name):
    data = _libc() if name == "libc" else (FIXDIR / name).read_bytes()
    eh, addr = _eh(data)
    for bias in (0, 0x555555554000):
        t = table.build_compact_table(eh, addr, bias)
        jt = jax_table.build_compact_table(eh, addr, bias)
        assert t.dtype == jt.dtype and np.array_equal(t, jt)
    if name != "libc":
        t = table.build_compact_table(eh, addr)
        got = f"{len(t)} rows\n" + format_table(t) + "\n"
        assert got == (FIXDIR / "golden" / f"{name}.table.txt").read_text()
        # The port's tools/eh_frame prints the original's text.
        assert port_format_table(t) == format_table(t)
        assert port_format_table(jt) == format_table(jt)
    else:
        assert len(t) > 10_000


def test_plt_expressions_are_identified_alike():
    eh, addr = _eh((FIXDIR / "fixture_plt").read_bytes())
    kinds = []
    for f in frame.parse_eh_frame(eh, addr):
        for r in frame.execute_fde(f):
            if r.cfa.expr:
                kinds.append(table.identify_expression(r.cfa.expr))
                assert kinds[-1] == jax_table.identify_expression(r.cfa.expr)
    assert table.CFA_EXPR_PLT1 in kinds
    rng = np.random.default_rng(0)
    for _ in range(200):
        expr = rng.integers(0, 256, int(rng.integers(0, 12)),
                            dtype=np.uint8).tobytes()
        assert table.identify_expression(expr) == \
            jax_table.identify_expression(expr)


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_eh_frame_outcomes_match(seed):
    """Seeded byte flips, truncations and length bombs of a fixture's
    section: the same rows or the same error in both packages."""
    name = FIXTURES[seed % len(FIXTURES)]
    eh, addr = _eh((FIXDIR / name).read_bytes())
    rng = np.random.default_rng(seed)
    for _ in range(25):
        buf = bytearray(eh)
        kind = int(rng.integers(0, 3))
        if kind == 0:
            for pos in rng.integers(0, len(buf), int(rng.integers(1, 8))):
                buf[int(pos)] = int(rng.integers(0, 256))
        elif kind == 1:
            buf = buf[:int(rng.integers(1, len(buf)))]
        else:
            pos = int(rng.integers(0, len(buf) - 4)) & ~3
            buf[pos:pos + 4] = b"\xf0\xff\xff\x7f"
        outs = []
        for mod in (table, jax_table):
            try:
                outs.append(mod.build_compact_table(bytes(buf), addr)
                            .tobytes())
            except Exception as e:  # noqa: BLE001 - the outcome compared
                outs.append(type(e).__name__)
        assert outs[0] == outs[1]


def test_leb128_and_sort_rows_match():
    rng = np.random.default_rng(3)
    blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    for pos in range(0, 4000, 37):
        for fn in ("uleb128", "sleb128"):
            outs = []
            for mod in (frame, jax_frame):
                try:
                    outs.append(getattr(mod, fn)(blob, pos))
                except Exception as e:  # noqa: BLE001 - outcome compared
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
    rows = np.zeros(5000, table.ROW_DTYPE)
    for f in table.ROW_DTYPE.names:
        rows[f] = rng.integers(0, 50, 5000).astype(rows[f].dtype)
    assert np.array_equal(table.sort_rows(rows), jax_table.sort_rows(rows))
    shards = table.shard_table(rows)
    jshards = jax_table.shard_table(rows)
    assert len(shards) == len(jshards)
    assert all(np.array_equal(a, b) for a, b in zip(shards, jshards))


@pytest.mark.parametrize("name", FIXTURES)
def test_aslr_eligibility_matches(name):
    data = (FIXDIR / name).read_bytes()
    assert is_aslr_eligible(data) == jax_aslr(data)
    assert is_aslr_eligible(ElfFile(data)) == jax_aslr(JaxElf(data))
    assert is_aslr_eligible(data) == (name != "fixture_nopie")


def _proc_world(broken: bool = False):
    """Two pids mapping the fixtures (and, when ``broken``, a pid whose
    object is not an ELF)."""
    files, maps = {}, {}
    base = {"fixture_pie": 0x555555554000, "fixture_pie_nofp": 0x5555AA000000,
            "fixture_nopie": 0x400000, "fixture_plt": 0x7F0000000000}
    for pid, names in ((11, ("fixture_pie", "fixture_plt")),
                       (12, ("fixture_nopie", "fixture_pie_nofp"))):
        maps[pid] = []
        for n in names:
            data = (FIXDIR / n).read_bytes()
            files[f"/proc/{pid}/root/opt/{n}"] = data
            ef = ElfFile(data)
            seg = ef.exec_load_segment()
            start = (base[n] if n != "fixture_nopie" else 0) + seg.vaddr \
                - seg.vaddr % 4096
            maps[pid].append(dict(
                start=start, end=start + 0x10000, perms="r-xp",
                offset=seg.offset - seg.offset % 4096, dev="08:01",
                inode=1, path=f"/opt/{n}"))
    if broken:
        files["/proc/13/root/opt/junk"] = b"\x7fELF" + b"\x00" * 60
        maps[13] = [dict(start=0x400000, end=0x410000, perms="r-xp",
                         offset=0, dev="08:01", inode=2, path="/opt/junk")]
    return files, maps


@pytest.mark.chaos
@pytest.mark.parametrize("fault", [None, "unwind.build:poison"])
def test_table_builder_matches_over_a_fake_proc(fault):
    files, maps = _proc_world(broken=True)
    q, jq = QuarantineRegistry(max_strikes=1), JaxQuarantine(max_strikes=1)
    b = table.UnwindTableBuilder(fs=FakeFS(dict(files)), quarantine=q)
    jb = jax_table.UnwindTableBuilder(fs=JaxFS(dict(files)), quarantine=jq)
    if fault:
        faults.install(faults.FaultInjector.from_spec(fault, seed=1))
        jax_faults.install(jax_faults.FaultInjector.from_spec(fault, seed=1))
    for pid in sorted(maps):
        t = b.table_for_pid(pid, [ProcMapping(**m) for m in maps[pid]])
        jt = jb.table_for_pid(pid, [JaxMapping(**m) for m in maps[pid]])
        assert np.array_equal(t, jt)
        if fault or pid == 13:
            assert len(t) == 0
        else:
            assert len(t) > 30
    assert q.stats == jq.stats
    assert q.stats["errors_total"] == (4 + 1 if fault else 1)
    # A laddered pid skips the build entirely, in both.
    for reg in (q, jq):
        reg.record_error(11, "unwind.build", ValueError("x"))
        reg.record_error(11, "unwind.build", ValueError("x"))
    faults.install(None)
    jax_faults.install(None)
    assert len(b.table_for_pid(11, [ProcMapping(**m) for m in maps[11]])) \
        == len(jb.table_for_pid(11, [JaxMapping(**m) for m in maps[11]])) \
        == 0
