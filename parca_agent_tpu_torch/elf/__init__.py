"""Minimal ELF toolkit: the port's copy of the parts of parca_agent_tpu's
elf/ that address normalization needs (the reader over in-memory bytes,
build ids, the base-address rule). The writer and the executable
classification are not ported yet.
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
