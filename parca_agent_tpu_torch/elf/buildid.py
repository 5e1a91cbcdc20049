"""Build-id extraction (role of reference pkg/buildid/buildid.go:36-122).

Precedence mirrors the reference:
  1. Go build id   — .note.go.buildid note (name "Go", type 4), the id the
                     Go toolchain stamps (reference fastGoBuildID), else
                     the legacy text-segment magic scan (reference
                     internal/go/buildid readRaw: pre-1.x toolchains and
                     `go tool link -B none` binaries carry only the
                     `\\xff Go build ID: "..."\\xff` marker at the start
                     of text);
  2. GNU build id  — .note.gnu.build-id note (name "GNU", type 3), hex;
  3. fallback      — hash of .text contents, so stripped/noteless binaries
                     still get a stable identity.
"""

from __future__ import annotations

import hashlib

from parca_agent_tpu_torch.elf.reader import ElfFile

NT_GNU_BUILD_ID = 3
NT_GO_BUILD_ID = 4

# Legacy in-text marker (internal/go/buildid/buildid.go:240-242): the id
# is the quoted string between goBuildPrefix and goBuildEnd, stamped
# within the first 32 kB of the text segment (readSize).
_GO_MAGIC = b'\xff Go build ID: "'
_GO_END = b'"\n \xff'
_GO_SCAN_LIMIT = 32 * 1024

# Poison cap: real ids are <=83 chars (Go) / 40 hex chars (GNU sha1). A
# note desc claiming kilobytes is malformed input, not an identity —
# treat the candidate as absent and fall through the precedence chain
# (docs/robustness.md "ingest containment").
_MAX_ID_LEN = 256


def go_build_id(ef: ElfFile) -> str | None:
    sec = ef.section(".note.go.buildid")
    if sec is not None:
        from parca_agent_tpu_torch.elf.reader import parse_notes

        for note in parse_notes(ef.section_data(sec), ef.end):
            if note.name == "Go" and note.type == NT_GO_BUILD_ID \
                    and note.desc and len(note.desc) <= _MAX_ID_LEN:
                return note.desc.rstrip(b"\x00").decode(errors="replace")
    return None


def legacy_go_build_id(ef: ElfFile) -> str | None:
    """Scan the head of the text segment for the legacy quoted marker
    (internal/go/buildid readRaw semantics: the id is everything between
    goBuildPrefix and the goBuildEnd terminator, no length cap). Only the
    first 32 kB are examined (the toolchain stamps the marker at text
    start and its own reader reads exactly that much), sliced without
    materializing the whole section."""
    sec = ef.section(".text")
    if sec is None:
        return None
    end = min(sec.offset + min(sec.size, _GO_SCAN_LIMIT), len(ef.data))
    data = ef.data[sec.offset:end]
    i = data.find(_GO_MAGIC)
    if i < 0:
        return None
    start = i + len(_GO_MAGIC)
    j = data.find(_GO_END, start)
    if j < 0:
        return None
    raw = data[start:j]
    if not raw or b"\x00" in raw or len(raw) > _MAX_ID_LEN:
        return None
    return raw.decode(errors="replace")


def gnu_build_id(ef: ElfFile) -> str | None:
    for note in ef.notes():
        if note.name == "GNU" and note.type == NT_GNU_BUILD_ID \
                and note.desc and len(note.desc) <= _MAX_ID_LEN:
            return note.desc.hex()
    return None


def text_hash_id(ef: ElfFile) -> str | None:
    sec = ef.section(".text")
    if sec is None:
        return None
    data = ef.section_data(sec)
    if not data:
        return None
    return hashlib.blake2b(data, digest_size=20).hexdigest()


def build_id(data_or_elf) -> str | None:
    """Best-available build id for an ELF image (bytes or ElfFile)."""
    ef = data_or_elf if isinstance(data_or_elf, ElfFile) else ElfFile(data_or_elf)
    # GNU note before the legacy text scan: a note-less binary with a
    # GNU build id that happens to carry the legacy marker bytes in its
    # text head must keep its GNU identity (the reference gates the
    # legacy path on the Go note section and never raw-scans,
    # pkg/buildid/buildid.go:43-56).
    return (go_build_id(ef) or gnu_build_id(ef) or legacy_go_build_id(ef)
            or text_hash_id(ef))
