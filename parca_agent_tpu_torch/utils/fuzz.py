"""Seeded mutation-fuzz harness over the ingest parsers.

The port's copy of parca_agent_tpu/utils/fuzz.py, over the port's own
parsers: ELF (elf/reader.py, its corpus built by the port's
elf/writer.py), ``.eh_frame`` (unwind/table.py), perf maps
(symbolize/perfmap.py), ``/proc/<pid>/maps`` (process/maps.py),
kallsyms (symbolize/ksym.py) and the cgroup pair
(metadata/providers.parse_cgroup_path into
runtime/admission.tenant_from_cgroup). Host code only: nothing here
touches torch or the card.

The containment contract (docs/robustness.md "ingest containment") is
that NO byte sequence an untrusted host process can hand the agent —
through an ELF, a perf map, a maps file, a kallsyms snapshot, a cgroup
file, or an .eh_frame section — makes a parser raise anything outside
the PoisonInput taxonomy (utils/poison.py). This harness enforces it
the only way that scales: start from a small valid corpus, apply
seeded byte-level mutations (bit flips, truncations, splices,
length-field bombs), feed every mutant to the parser, and flag any
escaping non-PoisonInput exception.

Deterministic by construction — one ``random.Random(seed)`` drives every
draw — so the same seed gives the same mutant stream, bit for bit, as
the original's (tests/test_torch_ingest_poison.py pins it).

Usage:

    from parca_agent_tpu_torch.utils.fuzz import PARSERS, fuzz_parser
    report = fuzz_parser("elf", n=500, seed=42)
    assert not report["escapes"], report["escapes"]
"""

from __future__ import annotations

import random
import struct

from parca_agent_tpu_torch.utils.poison import PoisonInput

# -- corpus -------------------------------------------------------------------


def _sample_elf() -> bytes:
    """A small valid ELF64 with the sections the readers exercise: text,
    GNU build-id note, symtab/strtab, eh_frame."""
    from parca_agent_tpu_torch.elf.reader import (
        ET_DYN,
        PF_R,
        PF_X,
        PT_LOAD,
        SHT_NOTE,
        SHT_SYMTAB,
        Section,
        Segment,
    )
    from parca_agent_tpu_torch.elf.writer import SHT_STRTAB, ElfWriter

    def sec(name, typ, *, flags=0, addr=0, link=0, entsize=0, align=1):
        return Section(name, typ, flags, addr, 0, 0, link, 0, align, entsize)

    w = ElfWriter(ET_DYN, 62)  # EM_X86_64
    text = bytes(range(64)) * 4
    w.add_section(sec(".text", 1, flags=6, addr=0x1000, align=16), text)
    note = struct.pack("<III", 4, 20, 3) + b"GNU\x00" + bytes(20)
    w.add_section(sec(".note.gnu.build-id", SHT_NOTE, align=4), note)
    strtab = b"\x00main\x00hot\x00"
    syms = b"\x00" * 24
    for name_off, value in ((1, 0x1000), (6, 0x1040)):
        syms += struct.pack("<IBBHQQ", name_off, 0x12, 0, 1, value, 0x40)
    w.add_section(sec(".symtab", SHT_SYMTAB, link=2, entsize=24, align=8),
                  syms)
    w.add_section(sec(".strtab", SHT_STRTAB), strtab)
    w.add_section(sec(".eh_frame", 1, flags=2, addr=0x2000, align=8),
                  _sample_eh_frame())
    w.add_segment(Segment(PT_LOAD, PF_R | PF_X, 0, 0x1000, 0x1000,
                          len(text), len(text), 0x1000))
    return w.serialize()


def _sample_eh_frame() -> bytes:
    """One CIE + one FDE, hand-assembled: def_cfa(rsp, 8), RA at CFA-8 —
    the canonical x86_64 prologue row."""

    def entry(body: bytes) -> bytes:
        pad = (-len(body)) % 4
        return struct.pack("<I", len(body) + pad) + body + b"\x00" * pad

    cie_body = (
        struct.pack("<I", 0)      # CIE id
        + b"\x01"                 # version 1
        + b"zR\x00"               # augmentation
        + b"\x01"                 # code_align = 1
        + b"\x78"                 # data_align = -8 (sleb)
        + b"\x10"                 # ra reg = 16
        + b"\x01\x04"             # aug len 1, fde_enc = udata8
        + b"\x0c\x07\x08"         # def_cfa rsp+8
        + b"\x90\x01"             # offset r16 @ cfa-8
    )
    cie = entry(cie_body)
    fde_body = (
        struct.pack("<I", len(cie) + 4)   # back-offset to the CIE
        + struct.pack("<Q", 0x2100)       # pc_begin
        + struct.pack("<Q", 0x40)         # pc_range
        + b"\x00"                         # aug len 0
        + b"\x44"                         # advance_loc 4
        + b"\x0e\x10"                     # def_cfa_offset 16
    )
    return cie + entry(fde_body) + struct.pack("<I", 0)


_PERF_MAP = b"".join(
    b"%x %x jit_method_%d with spaces\n" % (0x7f00_0000_0000 + i * 0x100,
                                            0x80, i)
    for i in range(64)
)

_MAPS = b"".join(
    b"%x-%x r-xp %x fd:01 %d /usr/lib/libfoo%d.so\n"
    % (0x5000_0000 + i * 0x10000, 0x5000_8000 + i * 0x10000,
       0x1000 * i, 100 + i, i)
    for i in range(32)
) + b"7ffc0000-7ffd0000 rw-p 00000000 00:00 0 [stack]\n"

_CGROUP = b"".join(
    b"%d:%s:/kubepods/burstable/pod12345678-dead-beef-0000-%012d/%016x\n"
    % (12 - i, ctrl, i, 0xABC0 + i)
    for i, ctrl in enumerate((b"cpu,cpuacct", b"memory", b"pids",
                              b"blkio", b"devices", b"freezer"))
) + b"0::/system.slice/app-workload.service\n"

_KALLSYMS = b"".join(
    b"%016x %c func_%d\n" % (0xffffffff81000000 + i * 0x40,
                             b"tT"[i % 2], i)
    for i in range(64)
) + b"0000000000000000 b bss_sym\n"


def _drive_elf(data: bytes) -> None:
    from parca_agent_tpu_torch.elf.buildid import build_id
    from parca_agent_tpu_torch.elf.reader import ElfFile

    ef = ElfFile(data)
    ef.segments
    ef.sections
    ef.exec_load_segment()
    ef.notes()
    ef.symbols()
    build_id(ef)


def _drive_eh_frame(data: bytes) -> None:
    from parca_agent_tpu_torch.unwind.table import build_compact_table

    build_compact_table(data, section_addr=0x2000)


def _drive_perfmap(data: bytes) -> None:
    from parca_agent_tpu_torch.symbolize.perfmap import parse_perf_map

    parse_perf_map(data)


def _drive_maps(data: bytes) -> None:
    from parca_agent_tpu_torch.process.maps import parse_proc_maps

    parse_proc_maps(data)


def _drive_kallsyms(data: bytes) -> None:
    from parca_agent_tpu_torch.symbolize.ksym import parse_kallsyms

    parse_kallsyms(data)


def _drive_cgroup(data: bytes) -> None:
    from parca_agent_tpu_torch.metadata.providers import parse_cgroup_path
    from parca_agent_tpu_torch.runtime.admission import tenant_from_cgroup

    tenant_from_cgroup(parse_cgroup_path(data))


# parser name -> (corpus thunk, driver). Thunks, not bytes: the ELF
# corpus needs the writer, and import-time work here would tax every
# agent start for a test-only path.
PARSERS: dict = {
    "elf": (_sample_elf, _drive_elf),
    "eh_frame": (_sample_eh_frame, _drive_eh_frame),
    "perfmap": (lambda: _PERF_MAP, _drive_perfmap),
    "maps": (lambda: _MAPS, _drive_maps),
    "kallsyms": (lambda: _KALLSYMS, _drive_kallsyms),
    "cgroup": (lambda: _CGROUP, _drive_cgroup),
}


# -- mutation engine ----------------------------------------------------------


def mutate(rng: random.Random, data: bytes) -> bytes:
    """1-4 seeded byte-level mutations; always returns a new buffer."""
    buf = bytearray(data)
    for _ in range(rng.randint(1, 4)):
        if not buf:
            buf = bytearray(rng.randbytes(rng.randint(1, 64)))
            continue
        op = rng.randrange(7)
        i = rng.randrange(len(buf))
        if op == 0:        # bit flip
            buf[i] ^= 1 << rng.randrange(8)
        elif op == 1:      # byte overwrite
            buf[i] = rng.randrange(256)
        elif op == 2:      # truncate
            del buf[i:]
        elif op == 3:      # delete a slice
            del buf[i: i + rng.randint(1, 32)]
        elif op == 4:      # duplicate a slice in place
            chunk = bytes(buf[i: i + rng.randint(1, 32)])
            buf[i:i] = chunk
        elif op == 5:      # insert random bytes
            buf[i:i] = rng.randbytes(rng.randint(1, 32))
        else:              # length-field bomb: saturate 4 or 8 bytes
            width = rng.choice((4, 8))
            buf[i: i + width] = b"\xff" * width
    return bytes(buf)


def fuzz_parser(name: str, n: int = 500, seed: int = 42) -> dict:
    """Run ``n`` seeded mutants of ``name``'s corpus through its driver.

    Returns ``{"parser", "mutations", "benign", "contained", "escapes"}``
    where escapes lists (repr'd, capped) every exception OUTSIDE the
    PoisonInput taxonomy — the containment bar is ``escapes == []``.
    """
    corpus_thunk, driver = PARSERS[name]
    corpus = corpus_thunk()
    driver(corpus)  # the unmutated corpus must parse cleanly
    rng = random.Random(seed)
    benign = contained = 0
    escapes: list[str] = []
    for i in range(n):
        data = mutate(rng, corpus)
        try:
            driver(data)
            benign += 1
        except PoisonInput:
            contained += 1
        except Exception as e:  # noqa: BLE001 - the escape being hunted
            if len(escapes) < 20:
                escapes.append(f"mutant {i}: {e!r}")
    return {"parser": name, "mutations": n, "benign": benign,
            "contained": contained, "escapes": escapes}


def fuzz_all(n: int = 500, seed: int = 42) -> dict:
    """Every registered parser; the chaos suite asserts each escapes
    list is empty."""
    return {name: fuzz_parser(name, n=n, seed=seed) for name in PARSERS}
