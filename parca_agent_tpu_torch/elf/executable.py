"""Executable classification (role of reference pkg/executable/executable.go).

IsASLRElegible in the reference: a DSO/PIE (ET_DYN) moves under ASLR and its
unwind tables must be relocated by the mapping start before upload
(pkg/stack/unwind/unwind_table.go:143-158); a fixed ET_EXEC binary must not.

The port's copy of parca_agent_tpu's elf/executable.py.
"""

from __future__ import annotations

from parca_agent_tpu_torch.elf.reader import ET_DYN, ElfFile


def is_aslr_eligible(data_or_elf) -> bool:
    ef = data_or_elf if isinstance(data_or_elf, ElfFile) else ElfFile(data_or_elf)
    return ef.e_type == ET_DYN
