"""JIT symbolization via perf map files.

JIT runtimes (node, JVMs with perf-map-agent, ...) drop
`/tmp/perf-<pid>.map` files of `start size name` lines. The agent must read
them through the *target's* mount namespace and with the target's
*namespaced* pid: `/proc/<pid>/root/tmp/perf-<nspid>.map`, where nspid is
the last field of the NSpid line in `/proc/<pid>/status` (reference
pkg/perf/perf.go:128-142,165-209).

Lookup contract matches the reference (perf.go:62-110): entries sorted by
end address, binary search for the first entry with End > addr, hit iff its
Start <= addr. Per-PID cache invalidated by content hash (perf.go:143-162).

Poison hardening: the file is
written by the *profiled process* — arbitrary and untrusted. Malformed
LINES are tolerated and skipped (bad hex, negative or out-of-range
start/size, wrong field count — unsorted and overlapping entries are fine
by the lookup contract and need no rejection); whole-file poison — more
rows than the row cap, a file past the byte cap — raises PerfMapError so
the caller can quarantine the pid. `faults.inject("perfmap.parse")` is
the chaos site.

The port's copy of parca_agent_tpu's symbolize/perfmap.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.filehash import hash_bytes
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS


class NoSymbolFound(LookupError):
    pass


class PerfMapError(PoisonInput):
    site = "perfmap.parse"


# Row/size caps: a hot JVM's perf map is a few hundred thousand rows and
# tens of MB; past these the file is a resource bomb, not a symbol table.
_MAX_ROWS = 1_000_000
_MAX_BYTES = 64 << 20
_MAX_ADDR = 2**64


@dataclasses.dataclass
class PerfMap:
    starts: np.ndarray  # uint64 [K], sorted by end
    ends: np.ndarray    # uint64 [K]
    names: list[str]
    skipped_lines: int = 0  # malformed lines tolerated during parse

    def __len__(self) -> int:
        return len(self.names)

    def lookup(self, addr: int) -> str:
        i = int(np.searchsorted(self.ends, np.uint64(addr), side="right"))
        if i >= len(self.names) or int(self.starts[i]) > addr:
            raise NoSymbolFound(hex(addr))
        return self.names[i]

    def lookup_many(self, addrs) -> list[str | None]:
        addrs = np.asarray(addrs, np.uint64)
        if not len(self.names):
            return [None] * len(addrs)
        idx = np.searchsorted(self.ends, addrs, side="right")
        safe = np.minimum(idx, len(self.names) - 1)
        ok = (idx < len(self.names)) & (self.starts[safe] <= addrs)
        return [self.names[int(i)] if hit else None
                for i, hit in zip(safe, ok)]


def parse_perf_map(data: bytes) -> PerfMap:
    """Parse `start size symbol-with-possible-spaces` lines (perf.go:62-95).

    Tolerant of malformed lines (skipped, counted); raises PerfMapError
    when the FILE itself is poison (row cap / byte cap exceeded)."""
    if len(data) > _MAX_BYTES:
        raise PerfMapError(
            f"perf map exceeds byte cap ({len(data)} > {_MAX_BYTES})")
    starts: list[int] = []
    sizes: list[int] = []
    names: list[str] = []
    skipped = 0
    for line in data.splitlines():
        parts = line.split(b" ", 2)
        if len(parts) != 3:
            if line.strip():
                skipped += 1
            continue
        try:
            start = int(parts[0], 16)
            size = int(parts[1], 16)
        except ValueError:
            skipped += 1
            continue
        # int(.., 16) accepts a sign; a negative start/size (or one past
        # the address space) is not a mapping, and would blow up the
        # uint64 conversion below for every GOOD row of the file.
        if not (0 <= start < _MAX_ADDR and 0 <= size
                and start + size < _MAX_ADDR):
            skipped += 1
            continue
        if len(starts) >= _MAX_ROWS:
            raise PerfMapError(f"perf map exceeds row cap ({_MAX_ROWS})")
        starts.append(start)
        sizes.append(size)
        names.append(parts[2].decode(errors="replace").rstrip())
    s = np.array(starts, np.uint64)
    e = s + np.array(sizes, np.uint64)
    order = np.argsort(e, kind="stable")
    return PerfMap(s[order], e[order], [names[i] for i in order],
                   skipped_lines=skipped)


def namespaced_pid(fs: VFS, pid: int) -> int:
    """Innermost-namespace pid: last field of NSpid in /proc/pid/status."""
    data = fs.read_bytes(f"/proc/{pid}/status")
    for line in data.splitlines():
        if line.startswith(b"NSpid:"):
            fields = line.split()
            if len(fields) >= 2:
                try:
                    return int(fields[-1])
                except ValueError:
                    break  # poisoned status line: fall back to host pid
    return pid


def perf_map_path(fs: VFS, pid: int) -> str:
    nspid = namespaced_pid(fs, pid)
    return f"/proc/{pid}/root/tmp/perf-{nspid}.map"


# Consecutive content-changed reparses a single pid's map may burn
# before the cache declares churn abuse and raises (charging the
# pid's quarantine budget through the symbolizer's PoisonInput path).
# A healthy JIT appends — its rewrites settle; a map rewritten with NEW
# content on every single read is either a runaway runtime or an
# adversary feeding the parser, and either way the parse work stops. A
# read observing UNCHANGED content resets the streak.
_CHURN_BUDGET = 8


class PerfMapCache:
    """map_for_pid(pid) -> PerfMap with two-tier invalidation.

    Tier 1 is the stat signature (``VFS.stat_signature``: dev/inode/
    size/mtime on a real fs, a content version on the fake) — unchanged
    signature returns the cached map WITHOUT touching file contents, so
    a stable JVM map costs one stat per window instead of a re-read and
    re-hash of tens of MB. Tier 2 is the content hash: a changed
    signature re-reads, and only changed BYTES re-parse (a touch/rewrite
    with identical content refreshes the signature and resets the churn
    streak). Actual reparses are counted (``reparse_total`` — exported
    as parca_agent_perfmap_reparse_total) and budgeted: past
    ``churn_budget`` consecutive content changes the entry is dropped
    and PerfMapError is raised, which the symbolizer's existing
    PoisonInput handler charges to the pid's quarantine budget — churn
    abuse rides the same ladder as any other poisoned input."""

    def __init__(self, fs: VFS | None = None,
                 churn_budget: int = _CHURN_BUDGET):
        self._fs = fs or RealFS()
        # pid -> [stat_sig, content_hash, PerfMap, churn_streak]
        self._cache: dict[int, list] = {}
        self._budget = max(1, int(churn_budget))
        self.stats = {
            "stat_hits_total": 0,
            "reads_total": 0,
            "parses_total": 0,
            "reparse_total": 0,
            "churn_trips_total": 0,
        }

    def map_for_pid(self, pid: int) -> PerfMap:
        """Raises FileNotFoundError when the process has no perf map and
        PoisonInput (PerfMapError or OversizedInput) when the map it
        does have is poison — including churn abuse (see class doc).

        The read itself is BOUNDED: the file is written by the profiled
        process, so a multi-GB map must cost at most the byte cap of RSS
        — never a full materialization before the cap check."""
        faults.inject("perfmap.parse")
        path = perf_map_path(self._fs, pid)
        ent = self._cache.get(pid)
        try:
            sig = self._fs.stat_signature(path)
        except OSError:
            # Stat is an optimization, not a gate: the bounded read
            # below owns the authoritative error (FileNotFoundError for
            # a mapless process, PoisonInput for a hostile stream — a
            # fake/test fs may serve open() for paths it cannot stat).
            sig = None
        if ent is not None and sig is not None and ent[0] == sig:
            self.stats["stat_hits_total"] += 1
            return ent[2]
        data = read_bounded(self._fs, path, _MAX_BYTES,
                            site="perfmap.parse")
        self.stats["reads_total"] += 1
        h = hash_bytes(data)
        if ent is not None and ent[1] == h:
            # Touched but not changed (mtime bump, rewrite-in-place with
            # identical bytes): refresh the signature, forgive the streak.
            ent[0] = sig
            ent[3] = 0
            return ent[2]
        if ent is not None:
            streak = ent[3] + 1
            if streak >= self._budget:
                # Drop the entry so a post-probation retry starts with a
                # fresh budget instead of tripping forever.
                del self._cache[pid]
                self.stats["churn_trips_total"] += 1
                raise PerfMapError(
                    f"perf map churn abuse: {streak} consecutive "
                    f"content rewrites (budget {self._budget})")
        else:
            streak = 0
        m = parse_perf_map(data)
        self.stats["parses_total"] += 1
        if ent is not None:
            self.stats["reparse_total"] += 1
        self._cache[pid] = [sig, h, m, streak]
        return m

    def evict(self, pid: int) -> None:
        self._cache.pop(pid, None)
