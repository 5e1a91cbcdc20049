"""ELF serializer: write a new ELF64 from chosen sections.

Role of the reference's from-scratch pkg/elfwriter (elfwriter.go:64-790 +
filtering_elfwriter.go): compose a valid ELF image containing a filtered
subset of an input file's sections — the mechanism behind debuginfo
extraction ("strip to only what symbolization needs", extract.go:46-123).

Layout produced: ELF header | program headers | section bodies | .shstrtab
| section header table. Only PT_LOAD program headers are copied from the
source, verbatim (vaddr/offset/filesz as originally linked, reference
elfwriter.go:64-790 writeSegments role): the extracted file is not
loadable, but elfexec-style base computation (elf/base.py compute_base,
pprof GetBase) reads the executable PT_LOAD's vaddr and offset from the
DEBUG file when the runtime binary is gone, so those values must survive
extraction unchanged. Other segment types are dropped — their file
offsets would point at unrelated bytes in the filtered image (a copied
PT_NOTE would make section-less note fallbacks parse garbage); kept note
CONTENT still travels via its sections.

The port's copy of parca_agent_tpu's elf/writer.py.
"""

from __future__ import annotations

import dataclasses
import struct

from parca_agent_tpu_torch.elf.reader import (
    PT_LOAD,
    ElfFile,
    Section,
    Segment,
    SHT_NOBITS,
)

SHT_NULL = 0
SHT_STRTAB = 3


class ElfWriter:
    """Collect (section, data) pairs + verbatim segments, then serialize."""

    def __init__(self, e_type: int, e_machine: int, entry: int = 0,
                 endian: str = "<"):
        self.e_type = e_type
        self.e_machine = e_machine
        self.entry = entry
        self.end = endian
        self._sections: list[tuple[Section, bytes]] = []
        self._segments: list[Segment] = []

    def add_section(self, sec: Section, data: bytes) -> None:
        self._sections.append((sec, data))

    def add_segment(self, seg: Segment) -> None:
        """Record a program header to emit as-is (original offsets/vaddrs;
        see module docstring for why they are not remapped)."""
        self._segments.append(seg)

    def serialize(self) -> bytes:
        ehsize, shentsize, phentsize = 64, 64, 56
        # Section name string table; index 0 is the empty name.
        names = bytearray(b"\x00")
        name_off = {}
        for sec, _ in self._sections:
            name_off[sec.name] = len(names)
            names += sec.name.encode() + b"\x00"
        shstr_name_off = len(names)
        names += b".shstrtab\x00"

        # Body layout after the ELF header and program header table,
        # honoring alignment.
        phoff = ehsize if self._segments else 0
        bodies: list[tuple[int, bytes]] = []
        pos = ehsize + len(self._segments) * phentsize
        laid: list[tuple[Section, int, int]] = []  # (sec, offset, size)
        for sec, data in self._sections:
            align = max(1, sec.addralign)
            if sec.type != SHT_NOBITS:
                pos = (pos + align - 1) // align * align
                bodies.append((pos, bytes(data)))
                laid.append((sec, pos, len(data)))
                pos += len(data)
            else:
                laid.append((sec, pos, sec.size))
        shstr_off = pos
        bodies.append((pos, bytes(names)))
        pos += len(names)
        shoff = (pos + 7) // 8 * 8

        n_secs = len(self._sections) + 2  # + null + shstrtab
        shstrndx = n_secs - 1

        out = bytearray(shoff + n_secs * shentsize)
        ident = b"\x7fELF" + bytes([2, 1 if self.end == "<" else 2, 1]) + b"\x00" * 9
        out[0:16] = ident
        struct.pack_into(self.end + "HHIQQQIHHHHHH", out, 16,
                         self.e_type, self.e_machine, 1, self.entry,
                         phoff, shoff, 0, ehsize,
                         phentsize if self._segments else 0,
                         len(self._segments), shentsize, n_secs,
                         shstrndx)
        for i, seg in enumerate(self._segments):
            struct.pack_into(self.end + "IIQQQQQQ", out,
                             phoff + i * phentsize, seg.type, seg.flags,
                             seg.offset, seg.vaddr, seg.paddr, seg.filesz,
                             seg.memsz, seg.align)
        for off, data in bodies:
            out[off: off + len(data)] = data

        def put_sh(i, name, typ, flags, addr, off, size, link, info,
                   align, entsize):
            struct.pack_into(self.end + "IIQQQQIIQQ", out,
                             shoff + i * shentsize, name, typ, flags, addr,
                             off, size, link, info, align, entsize)

        put_sh(0, 0, SHT_NULL, 0, 0, 0, 0, 0, 0, 0, 0)
        # Callers (filter_elf) hand in sections whose link indices already
        # point into THIS writer's table order; they are written verbatim.
        for new_i, (sec, off, size) in enumerate(laid, start=1):
            put_sh(new_i, name_off[sec.name], sec.type, sec.flags, sec.addr,
                   off, size, sec.link, sec.info,
                   max(1, sec.addralign), sec.entsize)
        put_sh(shstrndx, shstr_name_off, SHT_STRTAB, 0, 0, shstr_off,
               len(names), 0, 0, 1, 0)
        return bytes(out)


def compose_elf(parts: list[tuple[bytes, "callable"]]) -> bytes:
    """Compose ONE ELF from sections of several source files (the
    reference's AggregatingWriter role, aggregating_elfwriter.go:27-76).

    The FIRST part is the primary: it contributes the file identity
    (header fields, PT_LOAD program headers) as well as its
    predicate-matched sections. Each later (data, keep) part contributes
    its matching sections; same-named sections from later parts are
    skipped (first wins), so e.g. a separate debug file's .debug_* can
    be merged under the runtime binary's .note.gnu.build-id without
    duplicating tables. Linked sections (.symtab -> .strtab) are pulled
    per-part and link indices remapped into the combined table; when the
    dedup drops a later part's link target, the link resolves by NAME to
    the earlier part's section — callers composing same-named tables
    from DIFFERENT builds must ensure the winning table is the right one
    (same caller contract as the reference's AggregatingWriter).
    """
    w: ElfWriter | None = None
    seen: dict[str, int] = {}  # name -> combined table index (1-based)
    for data, keep in parts:
        ef = ElfFile(data)
        if w is None:
            w = ElfWriter(ef.e_type, ef.e_machine, ef.entry, ef.end)
            for seg in ef.segments:
                if seg.type == PT_LOAD:
                    w.add_segment(seg)
        chosen = _select_sections(ef, keep)
        # Drop names an earlier part already contributed (first wins).
        kept = [i for i in chosen if ef.sections[i].name not in seen]
        base = len(w._sections)
        new_index = {old: base + new
                     for new, old in enumerate(kept, start=1)}
        for i in kept:
            sec = ef.sections[i]
            # A link target dropped by the dedup resolves BY NAME to the
            # earlier part's section (e.g. part 2's .symtab links part
            # 1's .strtab) so no surviving section dangles at link=0.
            link = new_index.get(sec.link, 0)
            if link == 0 and sec.link:
                link = seen.get(ef.sections[sec.link].name, 0)
            seen[sec.name] = new_index[i]
            w.add_section(dataclasses.replace(sec, link=link), ef.section_data(sec))
    if w is None:
        raise ValueError("compose_elf needs at least one part")
    return w.serialize()


def _select_sections(ef: ElfFile, keep) -> list[int]:
    """Predicate-matched section indices plus their link closure
    (shared by filter_elf and compose_elf)."""
    secs = ef.sections
    chosen: list[int] = []
    for i, sec in enumerate(secs):
        if i == 0 or sec.type == SHT_NULL:
            continue
        if sec.name == ".shstrtab":
            continue  # writer regenerates it
        if keep(sec):
            chosen.append(i)
    pulled = True
    while pulled:
        pulled = False
        for i in list(chosen):
            link = secs[i].link
            if link and link != 0 and link not in chosen \
                    and secs[link].name != ".shstrtab":
                chosen.append(link)
                pulled = True
    chosen.sort()
    return chosen


def filter_elf(data: bytes, keep) -> bytes:
    """Copy an ELF keeping predicate-matched sections (the FilteringWriter
    role, filtering_elfwriter.go:26-196). Sections a kept section `link`s to
    (e.g. .symtab -> .strtab) are pulled in automatically and link indices
    remapped."""
    ef = ElfFile(data)
    secs = ef.sections
    chosen = _select_sections(ef, keep)

    w = ElfWriter(ef.e_type, ef.e_machine, ef.entry, ef.end)
    # Only PT_LOAD survives: that is all base computation reads, and any
    # other segment type (PT_NOTE especially) carries a file offset that
    # now points at unrelated bytes in the filtered image — a reader's
    # section-less note fallback would parse garbage from it. Kept note
    # CONTENT still travels via its sections.
    for seg in ef.segments:
        if seg.type == PT_LOAD:
            w.add_segment(seg)
    new_index = {old: new for new, old in enumerate(chosen, start=1)}
    for i in chosen:
        sec = secs[i]
        new_link = new_index.get(sec.link, 0)
        w.add_section(dataclasses.replace(sec, link=new_link),
                      ef.section_data(sec))
    return w.serialize()
