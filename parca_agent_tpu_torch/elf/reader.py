"""ELF64 reader over in-memory bytes.

The subset the agent needs (role of the reference's pkg/elfreader +
debug/elf usage): identification, file header, program headers, section
headers + names, note iteration, and symbol tables. Little- and big-endian
ELF64 are supported; ELF32 is rejected (the capture targets are x86_64 /
aarch64 processes, matching the reference's scope in bpf/cpu/cpu.bpf.c).

Poison hardening (docs/robustness.md "ingest containment"): the bytes come
from arbitrary host processes via /proc/<pid>/root, so every read is
bounds-checked and every table capped; anything malformed raises ElfError,
which is a PoisonInput — callers attribute it to the owning pid instead of
failing the window. `faults.inject("elf.read")` is the chaos site.
"""

from __future__ import annotations

import dataclasses
import struct

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.poison import PoisonInput

ET_REL = 1
ET_EXEC = 2
ET_DYN = 3
ET_CORE = 4

PT_LOAD = 1
PT_NOTE = 4

SHT_NOTE = 7
SHT_NOBITS = 8
SHT_SYMTAB = 2
SHT_DYNSYM = 11

PF_X = 1
PF_W = 2
PF_R = 4

SHF_COMPRESSED = 0x800


class ElfError(PoisonInput):
    site = "elf.read"


# Symbol entries are 24 bytes; a smaller sh_entsize would make the read
# loop walk overlapping garbage.
_SYM_ENTSIZE_MIN = 24


@dataclasses.dataclass(frozen=True)
class Segment:
    type: int
    flags: int
    offset: int
    vaddr: int
    paddr: int
    filesz: int
    memsz: int
    align: int


@dataclasses.dataclass(frozen=True)
class Section:
    name: str
    type: int
    flags: int
    addr: int
    offset: int
    size: int
    link: int
    info: int
    addralign: int
    entsize: int


@dataclasses.dataclass(frozen=True)
class Note:
    name: str
    type: int
    desc: bytes


@dataclasses.dataclass(frozen=True)
class Symbol:
    name: str
    value: int
    size: int
    info: int
    shndx: int

    @property
    def type(self) -> int:
        return self.info & 0xF


class ElfFile:
    """Parsed ELF64 image over a bytes buffer."""

    def __init__(self, data: bytes):
        faults.inject("elf.read")
        if len(data) < 64 or data[:4] != b"\x7fELF":
            raise ElfError("not an ELF file")
        ei_class = data[4]
        ei_data = data[5]
        if ei_class != 2:
            raise ElfError("only ELF64 is supported")
        if ei_data == 1:
            self.end = "<"
        elif ei_data == 2:
            self.end = ">"
        else:
            raise ElfError("bad EI_DATA")
        self.data = data
        (self.e_type, self.e_machine, _ver, self.entry, self.phoff,
         self.shoff, _flags, _ehsize, self.phentsize, self.phnum,
         self.shentsize, self.shnum, self.shstrndx) = struct.unpack_from(
            self.end + "HHIQQQIHHHHHH", data, 16
        )
        self._sections: list[Section] | None = None

    # -- program headers ----------------------------------------------------

    @property
    def segments(self) -> list[Segment]:
        out = []
        for i in range(self.phnum):
            off = self.phoff + i * self.phentsize
            if off + 56 > len(self.data):
                raise ElfError("program header out of bounds")
            (p_type, p_flags, p_offset, p_vaddr, p_paddr, p_filesz,
             p_memsz, p_align) = struct.unpack_from(
                self.end + "IIQQQQQQ", self.data, off
            )
            out.append(Segment(p_type, p_flags, p_offset, p_vaddr, p_paddr,
                               p_filesz, p_memsz, p_align))
        return out

    def load_segments(self) -> list[Segment]:
        return [s for s in self.segments if s.type == PT_LOAD]

    def exec_load_segment(self) -> Segment | None:
        """First executable PT_LOAD (the reference picks the program header
        covering the sampled address; the x-bit one is the text segment)."""
        for s in self.load_segments():
            if s.flags & PF_X:
                return s
        return None

    # -- section headers ----------------------------------------------------

    @property
    def sections(self) -> list[Section]:
        if self._sections is not None:
            return self._sections
        raw = []
        for i in range(self.shnum):
            off = self.shoff + i * self.shentsize
            if off + 64 > len(self.data):
                raise ElfError("section header out of bounds")
            (sh_name, sh_type, sh_flags, sh_addr, sh_offset, sh_size,
             sh_link, sh_info, sh_addralign, sh_entsize) = struct.unpack_from(
                self.end + "IIQQQQIIQQ", self.data, off
            )
            raw.append((sh_name, Section("", sh_type, sh_flags, sh_addr,
                                         sh_offset, sh_size, sh_link, sh_info,
                                         sh_addralign, sh_entsize)))
        names = b""
        if 0 < self.shstrndx < len(raw):
            st = raw[self.shstrndx][1]
            names = self.data[st.offset: st.offset + st.size]
        out = []
        for sh_name, sec in raw:
            end = names.find(b"\x00", sh_name)
            nm = names[sh_name:end].decode(errors="replace") if 0 <= sh_name < len(names) else ""
            out.append(dataclasses.replace(sec, name=nm))
        self._sections = out
        return out

    def section(self, name: str) -> Section | None:
        for s in self.sections:
            if s.name == name:
                return s
        return None

    def section_data(self, sec: Section) -> bytes:
        if sec.type == SHT_NOBITS:
            return b""
        if sec.offset + sec.size > len(self.data):
            raise ElfError(f"section {sec.name!r} out of bounds")
        return self.data[sec.offset: sec.offset + sec.size]

    # -- notes --------------------------------------------------------------

    def notes(self) -> list[Note]:
        """All notes from SHT_NOTE sections, falling back to PT_NOTE
        segments when the section table is stripped."""
        blobs = [self.section_data(s) for s in self.sections if s.type == SHT_NOTE]
        if not blobs:
            blobs = [
                self.data[seg.offset: seg.offset + seg.filesz]
                for seg in self.segments
                if seg.type == PT_NOTE
            ]
        out = []
        for blob in blobs:
            out.extend(parse_notes(blob, self.end))
        return out

    # -- symbols ------------------------------------------------------------

    def symbols(self, section_name: str = ".symtab") -> list[Symbol]:
        sec = self.section(section_name)
        if sec is None or sec.entsize == 0:
            return []
        if sec.entsize < _SYM_ENTSIZE_MIN:
            raise ElfError(
                f"symbol entsize {int(sec.entsize)} below entry size")
        strsec = self.sections[sec.link] if sec.link < len(self.sections) else None
        strs = self.section_data(strsec) if strsec else b""
        data = self.section_data(sec)
        out = []
        for off in range(0, len(data) - 23, int(sec.entsize)):
            st_name, st_info, _other, st_shndx, st_value, st_size = \
                struct.unpack_from(self.end + "IBBHQQ", data, off)
            end = strs.find(b"\x00", st_name)
            nm = strs[st_name:end].decode(errors="replace") if 0 <= st_name < len(strs) else ""
            out.append(Symbol(nm, st_value, st_size, st_info, st_shndx))
        return out


def parse_notes(blob: bytes, end: str = "<") -> list[Note]:
    """Iterate 4-byte-aligned note records: namesz descsz type name desc."""
    out = []
    pos = 0
    while pos + 12 <= len(blob):
        namesz, descsz, ntype = struct.unpack_from(end + "III", blob, pos)
        pos += 12
        if namesz > len(blob) - pos:
            break  # truncated record: name overruns the blob
        name = blob[pos: pos + namesz].rstrip(b"\x00").decode(errors="replace")
        pos += (namesz + 3) & ~3
        if descsz > max(len(blob) - pos, 0):
            break  # truncated record: desc overruns the blob
        desc = blob[pos: pos + descsz]
        pos += (descsz + 3) & ~3
        out.append(Note(name, ntype, desc))
    return out
