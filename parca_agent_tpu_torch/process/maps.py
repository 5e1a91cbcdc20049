"""The per-window mapping table build from per-pid mappings.

The port's copy of the two pieces of parca_agent_tpu's process/maps.py
that the streaming feeder runs: ProcMapping (one row of /proc/PID/maps)
and build_mapping_table, which folds the executable file-backed
mappings of many pids into one (pid, start)-sorted MappingTable. The
/proc parser and its per-pid cache are not ported (the port has no live
capture); callers hand in mapping lists from their own source.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parca_agent_tpu_torch.capture.formats import MappingTable
from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("maps")

# Pseudo-paths that are never ELF objects.
_SPECIAL = ("[vdso]", "[vsyscall]", "[stack]", "[heap]", "[anon", "[uprobes]")


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


def build_mapping_table(
    per_pid: dict[int, list[ProcMapping]],
    build_ids: dict[str, str] | None = None,
    objcache=None,
) -> MappingTable:
    """Fold executable file-backed mappings of many pids into one sorted
    MappingTable; objects dedup by path.

    With an object cache (``objcache.get(pid, mapping)`` returning an
    object with ``base()``, or None), each row's normalization base comes
    from the mapped object (pprof GetBase semantics); an object that is
    missing or whose base() raises takes base = start - offset. Such
    failures are counted per pid and logged at debug."""
    build_ids = build_ids or {}
    obj_ids: dict[str, int] = {}
    rows: list[tuple[int, int, int, int, int, int]] = []
    for pid, maps in per_pid.items():
        obj_failures = 0
        last_err: Exception | None = None
        for m in maps:
            if not (m.executable and m.file_backed):
                continue
            obj = obj_ids.setdefault(m.path, len(obj_ids))
            base = None
            if objcache is not None:
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
