"""Strip a binary to only what symbolization needs.

Role of the reference's pkg/debuginfo/extract.go:46-123: keep DWARF debug
sections, symbol tables, notes, and the Go symbol tables; drop text, data
and relocation payload. Implemented on the filtering ELF writer
(parca_agent_tpu/elf/writer.py).

The port's copy of parca_agent_tpu's debuginfo/extract.py.
"""

from __future__ import annotations

from parca_agent_tpu_torch.elf.reader import Section
from parca_agent_tpu_torch.elf.writer import filter_elf

# Prefixes/names kept, matching extract.go's isDWARF/isSymbolTable/isNote
# predicates.
KEEP_SECTIONS = (
    ".debug_", ".zdebug_", ".gdb_index",
    ".symtab", ".strtab", ".dynsym", ".dynstr",
    ".note.",
    ".gosymtab", ".gopclntab", ".go.buildinfo",
    ".gnu_debuglink",
)


def _keep(sec: Section) -> bool:
    return sec.name.startswith(KEEP_SECTIONS)


def extract_debuginfo(data: bytes) -> bytes:
    """Return a minimal valid ELF with only symbolization sections."""
    return filter_elf(data, _keep)
