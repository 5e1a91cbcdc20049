"""Base-address computation for runtime->object address normalization.

Role of the reference's vendored pprof elfexec.GetBase (internal/pprof/
elfexec/elfexec.go:221, used at pkg/objectfile/object_file.go:156-238):
given the ELF type, the executable PT_LOAD segment, and one /proc mapping
(start, limit, offset) of that file, compute `base` so that
object_address = runtime_address - base.

Semantics per ELF type (matching pprof's rules for the cases a profiler
meets; kernel-relocation special cases handled via stext_offset):

  ET_EXEC — fixed link address: base is normally 0. Kernel images are
      ET_EXEC yet relocated (KASLR): when stext_offset is provided and
      disagrees with the mapping, base = start - stext_offset.
  ET_REL  — relocatable object: offset must be 0; base = start.
  ET_DYN  — PIE/DSO: base = (start - offset) + (seg.offset - seg.vaddr);
      i.e. runtime bias of the file's page 0 plus the link-time delta
      between the segment's file offset and virtual address.
"""

from __future__ import annotations

from parca_agent_tpu_torch.elf.reader import ET_DYN, ET_EXEC, ET_REL, ElfFile, Segment


class BaseError(ValueError):
    pass


def compute_base(
    ef_or_type,
    load_segment: Segment | None,
    start: int,
    limit: int,
    offset: int,
    stext_offset: int | None = None,
) -> int:
    e_type = ef_or_type.e_type if isinstance(ef_or_type, ElfFile) else ef_or_type

    if start == 0 and offset == 0 and limit == ~0 & (2**64 - 1):
        # Whole-address-space pseudo mapping (profile with no mappings).
        return 0

    if e_type == ET_EXEC:
        if stext_offset is not None:
            # Relocated kernel: _stext's runtime address vs link address.
            return (start - stext_offset) % 2**64
        if load_segment is None:
            return 0
        if offset == 0 and start != 0 and start == load_segment.vaddr:
            return 0
        # Mapping not at the linked address: the file was loaded shifted
        # (e.g. prelink leftovers); bias by the difference.
        if offset == 0 and start != 0:
            return (start - load_segment.vaddr) % 2**64
        return 0

    if e_type == ET_REL:
        if offset != 0:
            raise BaseError(f"ET_REL mapping with nonzero offset {offset:#x}")
        return start % 2**64

    if e_type == ET_DYN:
        if load_segment is None:
            return (start - offset) % 2**64
        return (start - offset + load_segment.offset - load_segment.vaddr) % 2**64

    raise BaseError(f"unsupported ELF type {e_type}")


def object_address(runtime_addr: int, base: int) -> int:
    return (runtime_addr - base) % 2**64
