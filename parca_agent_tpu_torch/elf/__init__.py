"""Minimal ELF toolkit: the port's copy of the parts of parca_agent_tpu's
elf/: the reader over in-memory bytes, build ids, the base-address
rule, the executable classification (executable.py) and the filtering
writer (writer.py) that debuginfo extraction builds on.
"""

from parca_agent_tpu_torch.elf.base import compute_base
from parca_agent_tpu_torch.elf.buildid import build_id
from parca_agent_tpu_torch.elf.reader import (
    ElfError,
    ElfFile,
    Note,
    Section,
    Segment,
)

__all__ = [
    "ElfError", "ElfFile", "Note", "Section", "Segment",
    "build_id", "compute_base",
]
