"""Object-file cache with lazy base computation.

The port's copy of parca_agent_tpu's process/objectfile.py.

Role of the reference's pkg/objectfile/object_file.go + cache.go: open a
mapped ELF once, extract its build id, and compute the normalization base
lazily from the executable load segment and the process mapping that covers
the sampled addresses (object_file.go:156-238, via elfexec.GetBase). The
cache is keyed (pid, start, end, offset) with TTL + LRU (cache.go:28-86).

Kernel objects: a mapping whose file has the `_stext`/`_text` relocation
symbols gets its base from the stext offset instead (object_file.go:78-143)
— handled here by the caller passing `stext_offset`.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from parca_agent_tpu_torch.elf.base import BaseError, compute_base
from parca_agent_tpu_torch.elf.buildid import build_id
from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.process.maps import ProcMapping, host_path
from parca_agent_tpu_torch.utils import poison
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS


class ObjectFile:
    """The slice of an opened ELF that address normalization needs, plus
    the mapping it was sampled through.

    Deliberately does NOT hold the parsed ElfFile (whole-file bytes): an
    always-on agent's cache held ~1.3 GiB of binaries this way, yet base
    computation only ever reads e_type and the executable PT_LOAD, and
    upload keys only need the build id. The file is re-opened on the rare
    paths that need sections (debuginfo extraction reads it itself)."""

    def __init__(self, path: str, elf: ElfFile, mapping: ProcMapping,
                 build_id: str | None = None):
        from parca_agent_tpu_torch.elf.buildid import build_id as _compute

        self.path = path
        self.mapping = mapping
        self.e_type = elf.e_type
        self.exec_segment = elf.exec_load_segment()
        # The cache passes the per-file build id it computed once; direct
        # constructions compute it here.
        self.build_id = (_compute(elf) or "") if build_id is None else build_id
        self._base: int | None = None

    @classmethod
    def from_meta(cls, path: str, e_type: int, exec_segment, build_id: str,
                  mapping: ProcMapping) -> "ObjectFile":
        """Construct from the cache's extracted metadata, no ElfFile."""
        self = cls.__new__(cls)
        self.path = path
        self.mapping = mapping
        self.e_type = e_type
        self.exec_segment = exec_segment
        self.build_id = build_id
        self._base = None
        return self

    def base(self, stext_offset: int | None = None) -> int:
        """Relocation base, computed once per object file (lazy, like the
        reference's sync.Once around computeBase)."""
        if self._base is None:
            m = self.mapping
            self._base = compute_base(
                self.e_type, self.exec_segment,
                m.start, m.end, m.offset, stext_offset=stext_offset,
            )
        return self._base

    def normalize(self, runtime_addr: int) -> int:
        """Runtime address -> position-independent object address (the role
        of reference pkg/address/normalizer.go:48-74)."""
        return (runtime_addr - self.base()) % 2**64


class ObjectFileCache:
    """open(pid, mapping) -> ObjectFile | None with TTL+LRU eviction."""

    def __init__(self, fs: VFS | None = None, size: int = 512,
                 ttl_s: float = 300.0, clock=time.monotonic):
        self._fs = fs or RealFS()
        self._size = size
        self._ttl = ttl_s
        self._clock = clock
        self._cache: OrderedDict[tuple, tuple[float, ObjectFile | None]] = OrderedDict()
        # Underlying-file identity -> (e_type, exec seg, build id); see _file_meta.
        self._elves: OrderedDict[tuple, tuple[int, object, str]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _file_meta(self, path: str) -> tuple[int, object, str]:
        """(e_type, exec PT_LOAD segment, build id) per underlying FILE —
        stat identity incl. device — shared across the per-(pid, mapping)
        entries: libc mapped into hundreds of processes parses and
        build-id-hashes once, and the file BYTES are dropped immediately
        after extraction (holding whole ElfFiles cost ~1.3 GiB on a host
        with large binaries; normalization needs only these three
        values). A read snapshot, not an mmap: a file truncated in place
        under an mmap SIGBUSes the process, uncatchably."""
        sig = self._fs.stat_signature(path)
        hit = self._elves.get(sig)
        if hit is not None:
            self._elves.move_to_end(sig)
            return hit
        # Bounded read: a PROT_EXEC-mapped multi-GB sparse file must not
        # be materialized before ElfFile can reject it.
        elf = ElfFile(read_bounded(self._fs, path, poison.ELF_READ_CAP))
        entry = (elf.e_type, elf.exec_load_segment(), build_id(elf) or "")
        self._elves[sig] = entry
        while len(self._elves) > self._size:
            self._elves.popitem(last=False)
        return entry

    def get(self, pid: int, mapping: ProcMapping) -> ObjectFile | None:
        """None when the mapped file is unreadable or not a supported ELF
        (the profiler treats that as 'cannot normalize', not an error)."""
        key = (pid, mapping.start, mapping.end, mapping.offset, mapping.path)
        now = self._clock()
        hit = self._cache.get(key)
        if hit is not None and now - hit[0] < self._ttl:
            self._cache.move_to_end(key)
            self.hits += 1
            return hit[1]
        self.misses += 1
        obj: ObjectFile | None = None
        try:
            e_type, seg, bid = self._file_meta(host_path(pid, mapping.path))
            obj = ObjectFile.from_meta(mapping.path, e_type, seg, bid,
                                       mapping)
        except (OSError, PoisonInput, BaseError):
            # PoisonInput covers the whole ingest taxonomy (ElfError and
            # any injected elf.read fault): a corrupt mapped binary
            # degrades THIS object to fallback normalization, never the
            # window's table build.
            obj = None
        self._cache[key] = (now, obj)
        self._cache.move_to_end(key)
        while len(self._cache) > self._size:
            self._cache.popitem(last=False)
        return obj

    def build_ids(self, per_pid: dict[int, list[ProcMapping]]) -> dict[str, str]:
        """path -> build id for every distinct executable file-backed path
        (feeds process.maps.build_mapping_table)."""
        out: dict[str, str] = {}
        for pid, maps in per_pid.items():
            for m in maps:
                if not (m.executable and m.file_backed) or m.path in out:
                    continue
                obj = self.get(pid, m)
                if obj is not None and obj.build_id:
                    out[m.path] = obj.build_id
        return out
