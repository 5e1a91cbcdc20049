"""/proc/PID/maps parsing and the per-window mapping table build.

The port's copy of parca_agent_tpu's process/maps.py: parse the text
maps file (ProcMapping rows), cache each pid's mappings with content-hash
invalidation (ProcessMapCache), and fold the executable file-backed
mappings of many pids into one (pid, start)-sorted MappingTable
(build_mapping_table), each row's normalization base from the mapped
ELF when an object cache is given. The quarantine registry of the
original is not ported: a poisoned maps file raises MapsError (a
PoisonInput) to the caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parca_agent_tpu_torch.capture.formats import MappingTable
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.filehash import hash_bytes
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

_log = get_logger("maps")

# Pseudo-paths that are never ELF objects.
_SPECIAL = ("[vdso]", "[vsyscall]", "[stack]", "[heap]", "[anon", "[uprobes]")


class MapsError(PoisonInput):
    site = "maps.parse"


# Poison caps: the busiest real processes sit around tens of thousands of
# mappings (the kernel's own default cap is vm.max_map_count = 65530); a
# maps file past these is a resource bomb from a hostile or broken
# process (a fake /proc in its mount namespace), not a map. The byte cap
# bounds the read itself.
_MAX_ROWS = 262_144
_MAX_BYTES = 32 << 20
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class ProcMapping:
    start: int
    end: int
    perms: str
    offset: int
    dev: str
    inode: int
    path: str

    @property
    def executable(self) -> bool:
        return "x" in self.perms

    @property
    def file_backed(self) -> bool:
        return bool(self.path) and not self.path.startswith(_SPECIAL) \
            and self.inode != 0


def parse_proc_maps(data: bytes) -> list[ProcMapping]:
    """Parse maps lines: start-end perms offset dev inode [path].

    Malformed lines are skipped; values are masked to 64 bits (a hostile
    process can remount a fake /proc in its namespace — an out-of-range
    address must not blow up the whole window's uint64 table build
    downstream); a file past the row cap raises MapsError (PoisonInput)
    so the caller can quarantine the pid."""
    out = []
    for line in data.splitlines():
        parts = line.split(None, 5)
        if len(parts) < 5:
            continue
        try:
            start_s, end_s = parts[0].split(b"-")
            start, end = int(start_s, 16), int(end_s, 16)
            offset = int(parts[2], 16)
            inode = int(parts[4])
        except ValueError:
            continue
        if start < 0 or end < 0 or offset < 0:
            continue
        if len(out) >= _MAX_ROWS:
            raise MapsError(f"maps file exceeds row cap ({_MAX_ROWS})")
        path = parts[5].decode(errors="replace").strip() if len(parts) == 6 else ""
        out.append(ProcMapping(start & _MASK64, end & _MASK64,
                               parts[1].decode(errors="replace"),
                               offset & _MASK64,
                               parts[3].decode(errors="replace"),
                               inode, path))
    return out


class ProcessMapCache:
    """mappings_for_pid(pid) -> [ProcMapping], hash-invalidated per pid."""

    def __init__(self, fs: VFS | None = None):
        self._fs = fs or RealFS()
        self._cache: dict[int, tuple[int, list[ProcMapping]]] = {}

    def mappings_for_pid(self, pid: int) -> list[ProcMapping]:
        """Raises OSError for exited/unreadable pids and PoisonInput
        (MapsError or OversizedInput) for poisoned maps files."""
        faults.inject("maps.parse")
        data = read_bounded(self._fs, f"/proc/{pid}/maps", _MAX_BYTES,
                            site="maps.parse")
        h = hash_bytes(data)
        cached = self._cache.get(pid)
        if cached and cached[0] == h:
            return cached[1]
        maps = parse_proc_maps(data)
        self._cache[pid] = (h, maps)
        return maps

    def evict(self, pid: int) -> None:
        self._cache.pop(pid, None)

    def executable_mappings(self, pid: int) -> list[ProcMapping]:
        return [m for m in self.mappings_for_pid(pid)
                if m.executable and m.file_backed]


def host_path(pid: int, path: str) -> str:
    """A target path seen through the target's mount namespace."""
    return f"/proc/{pid}/root{path}"


def build_mapping_table(
    per_pid: dict[int, list[ProcMapping]],
    build_ids: dict[str, str] | None = None,
    objcache=None,
    quarantine=None,
) -> MappingTable:
    """Fold executable file-backed mappings of many pids into one sorted
    MappingTable; objects dedup by path.

    With an object cache (``objcache.get(pid, mapping)`` returning an
    object with ``base()``, or None), each row's normalization base comes
    from the mapped object (pprof GetBase semantics); an object that is
    missing or whose base() raises takes base = start - offset. Such
    failures are counted per pid and logged at debug, and with a
    quarantine registry (runtime/quarantine.py) they feed the pid's
    error budget. Pids already on the degradation ladder skip the object
    open entirely (the file is the suspected poison) and take the
    file-offset base."""
    build_ids = build_ids or {}
    obj_ids: dict[str, int] = {}
    rows: list[tuple[int, int, int, int, int, int]] = []
    for pid, maps in per_pid.items():
        obj_failures = 0
        last_err: Exception | None = None
        degraded = quarantine is not None and quarantine.level(pid) > 0
        t0 = quarantine.clock() if quarantine is not None else 0.0
        for m in maps:
            if not (m.executable and m.file_backed):
                continue
            obj = obj_ids.setdefault(m.path, len(obj_ids))
            base = None
            if objcache is not None and not degraded:
                of = objcache.get(pid, m)
                if of is not None:
                    try:
                        base = of.base()
                    except Exception as e:  # noqa: BLE001 - counted below
                        obj_failures += 1
                        last_err = e
                        base = None
            if base is None:
                base = (m.start - m.offset) % 2**64
            rows.append((pid, m.start, m.end, m.offset, obj, base))
        if obj_failures:
            _log.debug("object-file failures during mapping build",
                       pid=pid, failures=obj_failures,
                       error=repr(last_err))
            if quarantine is not None:
                quarantine.record_error(pid, "maps.objfile", last_err)
        if quarantine is not None:
            # The per-pid deadline covers the object opens too: an object
            # that parses slowly is poison as well.
            quarantine.check_deadline(pid, t0)
    if not rows:
        return MappingTable.empty()
    rows.sort(key=lambda r: (r[0], r[1]))
    arr = np.array(rows, np.uint64)
    paths = list(obj_ids)
    return MappingTable(
        pids=arr[:, 0].astype(np.int32),
        starts=arr[:, 1],
        ends=arr[:, 2],
        offsets=arr[:, 3],
        objs=arr[:, 4].astype(np.int32),
        obj_paths=tuple(paths),
        obj_buildids=tuple(build_ids.get(p, "") for p in paths),
        bases=arr[:, 5],
    )
