"""Kernel symbolization from /proc/kallsyms.

Design follows the reference's ksym cache (pkg/ksym/ksym.go): parse kallsyms
once into an address-sorted table, resolve by binary search, keep an LRU of
resolved addresses, and re-validate at most every `ttl` by re-hashing the
file — reparse only when the content hash changed (ksym.go:90-122,250-252).

Differences, deliberate:
  - the sorted table is a pair of numpy arrays, and `resolve` takes a whole
    address vector and answers it with one `searchsorted` — batch-shaped
    like everything else on our hot path, instead of the reference's
    per-address map lookups;
  - symbols with type b/B/d/D/r/R (data/bss/rodata) are skipped exactly as
    in the reference (ksym.go:177-232).

The port's copy of parca_agent_tpu's symbolize/ksym.py.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.filehash import hash_bytes
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

_SKIP_TYPES = frozenset("bBdDrR")
_DEFAULT_TTL_S = 300.0  # reference: 5 min (ksym.go:66-77)
_LRU_SIZE = 10_000      # reference: 10k resolved addrs (ksym.go:35)
# Poison caps: a real kallsyms is a few hundred thousand lines; the file
# normally comes from the kernel, but snapshot/replay paths feed cached
# copies that can be corrupt.
_MAX_SYMS = 4_000_000
_MAX_ADDR = 2**64


def parse_kallsyms(data: bytes) -> tuple[np.ndarray, list[str]]:
    """Parse kallsyms text -> (sorted uint64 addresses, names).

    Lines are `addr type name [module]`. Zero addresses (unprivileged read:
    kptr_restrict) parse fine and resolve to whatever the search finds —
    callers should treat an all-zero table as "no kallsyms access".
    Malformed lines (bad hex, out-of-range addresses) are skipped, and the
    table is truncated at a row cap, so a corrupt cache degrades coverage
    instead of aborting the window's symbolization.
    """
    addrs: list[int] = []
    names: list[str] = []
    for line in data.splitlines():
        parts = line.split()
        if len(parts) < 3:
            continue
        if parts[1].decode(errors="replace") in _SKIP_TYPES:
            continue
        try:
            addr = int(parts[0], 16)
        except ValueError:
            continue
        if not 0 <= addr < _MAX_ADDR:
            continue
        if len(addrs) >= _MAX_SYMS:
            break
        addrs.append(addr)
        names.append(parts[2].decode(errors="replace"))
    a = np.array(addrs, np.uint64)
    order = np.argsort(a, kind="stable")
    return a[order], [names[i] for i in order]


class KsymCache:
    """resolve(addrs) -> list[str|None], hash-invalidated every ttl."""

    def __init__(self, fs: VFS | None = None, path: str = "/proc/kallsyms",
                 ttl_s: float = _DEFAULT_TTL_S, clock=time.monotonic):
        self._fs = fs or RealFS()
        self._path = path
        self._ttl = ttl_s
        self._clock = clock
        self._addrs = np.zeros(0, np.uint64)
        self._names: list[str] = []
        self._hash = 0
        self._checked_at = -1e18
        self._lru: OrderedDict[int, str | None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _maybe_reload(self) -> None:
        now = self._clock()
        if now - self._checked_at < self._ttl:
            return
        try:
            data = self._fs.read_bytes(self._path)
        except OSError:
            # Leave _checked_at untouched so a transient failure (container
            # startup ordering, EPERM blip) is retried on the next resolve
            # instead of pinning an empty table for a full ttl.
            return
        self._checked_at = now
        h = hash_bytes(data)
        if h == self._hash:
            return
        self._hash = h
        self._addrs, self._names = parse_kallsyms(data)
        self._lru.clear()

    def loaded(self) -> bool:
        self._maybe_reload()
        return len(self._addrs) > 0

    def resolve(self, addrs) -> list[str | None]:
        """Resolve each address to the name of the last symbol at or below
        it (reference ksym.go:235-248). None when below the first symbol."""
        faults.inject("symbolize.kernel")
        self._maybe_reload()
        addrs = np.asarray(addrs, np.uint64)
        out: list[str | None] = [None] * len(addrs)
        missing_idx: list[int] = []
        missing_addr: list[int] = []
        for i, a in enumerate(addrs):
            a = int(a)
            if a in self._lru:
                self._lru.move_to_end(a)
                out[i] = self._lru[a]
                self.hits += 1
            else:
                missing_idx.append(i)
                missing_addr.append(a)
                self.misses += 1
        if missing_addr and len(self._addrs):
            pos = np.searchsorted(
                self._addrs, np.array(missing_addr, np.uint64), side="right"
            ) - 1
            for i, p, a in zip(missing_idx, pos, missing_addr):
                name = self._names[p] if p >= 0 else None
                out[i] = name
                self._lru[a] = name
                if len(self._lru) > _LRU_SIZE:
                    self._lru.popitem(last=False)
        return out
