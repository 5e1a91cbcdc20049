"""Debuginfo upload manager: dedup, extract, ship.

Role of the reference's pkg/debuginfo/manager.go: called once per profiler
iteration with the window's object files; work happens asynchronously so
the capture loop never blocks on uploads (manager.go:130-155, errgroup
limit 4 -> ThreadPoolExecutor(4) here). Per-build-id dedup via three
caches: `uploading` (in-flight singleflight), `exists` (server-confirmed),
`failed` (don't retry hopeless binaries every window) —
manager.go:116-127,226-248.

Flow per new build id (manager.go:157-270): prefer a separate debug file
found on disk (Finder), else extract/strip the mapped binary; validate the
result parses as ELF; ask the server Exists(build_id, hash) first; upload
only on miss.

The port's copy of parca_agent_tpu's debuginfo/manager.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Protocol

from parca_agent_tpu_torch.debuginfo.extract import extract_debuginfo
from parca_agent_tpu_torch.debuginfo.find import Finder
from parca_agent_tpu_torch.elf.reader import ElfError, ElfFile
from parca_agent_tpu_torch.process.maps import host_path
from parca_agent_tpu_torch.utils import poison
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

_log = get_logger("debuginfo")


class DebuginfoClient(Protocol):
    """Server interface (reference client.go:22-38)."""

    def exists(self, build_id: str, hash_: str) -> bool: ...
    def upload(self, build_id: str, hash_: str, data: bytes) -> None: ...


class NoopClient:
    """Default when no remote store is configured (client.go:27-38)."""

    def exists(self, build_id: str, hash_: str) -> bool:
        return True  # pretend present: nothing to do

    def upload(self, build_id: str, hash_: str, data: bytes) -> None:
        pass


@dataclasses.dataclass
class UploadStats:
    uploaded: int = 0
    already_present: int = 0
    extracted: int = 0
    found_separate: int = 0
    errors: int = 0


class DebuginfoManager:
    def __init__(self, client: DebuginfoClient | None = None,
                 fs: VFS | None = None, finder: Finder | None = None,
                 workers: int = 4, failed_ttl_s: float = 600.0,
                 exists_ttl_s: float = 300.0, strip: bool = True,
                 clock=None):
        import time as _time

        self._client = client or NoopClient()
        self._fs = fs or RealFS()
        self._finder = finder or Finder(fs=self._fs)
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="debuginfo")
        self._lock = threading.Lock()
        self._uploading: dict[str, object] = {}   # build_id -> Future
        # Server-confirmed build ids, cached with a TTL (the reference's
        # --debuginfo-upload-cache-duration, default 5m): servers can
        # garbage-collect, so "exists" is a lease, not a fact.
        self._exists: dict[str, float] = {}       # build_id -> confirmed_at
        self._exists_ttl = exists_ttl_s
        # strip=False uploads the exact binary unmodified (the
        # reference's --debuginfo-strip=false).
        self._strip = strip
        # Failures expire so a transient store outage doesn't blacklist a
        # binary for the agent's lifetime (the reference's caches are
        # TTL-based for the same reason).
        self._failed: dict[str, float] = {}       # build_id -> failed_at
        self._failed_ttl = failed_ttl_s
        self._clock = clock or _time.monotonic
        self.stats = UploadStats()

    def ensure_uploaded(self, objfiles: list[tuple[int, str, str]]) -> None:
        """objfiles: (pid, path, build_id). Fire-and-forget per iteration
        (manager.go:130-155); call drain() to wait (tests, shutdown)."""
        for pid, path, build_id in objfiles:
            if not build_id:
                continue
            with self._lock:
                failed_at = self._failed.get(build_id)
                if failed_at is not None:
                    if self._clock() - failed_at < self._failed_ttl:
                        continue
                    del self._failed[build_id]
                confirmed_at = self._exists.get(build_id)
                if confirmed_at is not None:
                    if self._clock() - confirmed_at < self._exists_ttl:
                        continue
                    del self._exists[build_id]
                if build_id in self._uploading:
                    continue
                fut = self._pool.submit(self._process, pid, path, build_id)
                self._uploading[build_id] = fut
                fut.add_done_callback(
                    lambda _f, b=build_id: self._uploading.pop(b, None)
                )

    def drain(self) -> None:
        while True:
            with self._lock:
                futs = list(self._uploading.values())
            if not futs:
                return
            for f in futs:
                f.result()

    def close(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)

    # -- internals ----------------------------------------------------------

    def _process(self, pid: int, path: str, build_id: str) -> None:
        try:
            data = self._debug_payload(pid, path, build_id)
            if data is None:
                with self._lock:
                    self._failed[build_id] = self._clock()
                    self.stats.errors += 1
                return
            h = hashlib.sha256(data).hexdigest()
            if self._client.exists(build_id, h):
                with self._lock:
                    self._exists[build_id] = self._clock()
                    self.stats.already_present += 1
                return
            self._client.upload(build_id, h, data)
            with self._lock:
                self._exists[build_id] = self._clock()
                self.stats.uploaded += 1
        except Exception as e:
            with self._lock:
                self._failed[build_id] = self._clock()
                self.stats.errors += 1
            _log.warn("debuginfo upload failed", build_id=build_id,
                      error=repr(e))

    def _debug_payload(self, pid: int, path: str, build_id: str) -> bytes | None:
        try:
            # Bounded: the path comes from the target's mount namespace —
            # a staged multi-GB sparse "binary" must not OOM the agent.
            raw = read_bounded(self._fs, host_path(pid, path),
                               poison.ELF_READ_CAP)
        except (OSError, PoisonInput):
            return None
        sep = self._finder.find(pid, path, data=raw, build_id=build_id)
        if sep is not None:
            try:
                payload = read_bounded(self._fs, sep, poison.ELF_READ_CAP)
                ElfFile(payload)  # validate
                with self._lock:
                    self.stats.found_separate += 1
                return payload
            except (OSError, PoisonInput):
                pass
        if not self._strip:
            # --debuginfo-strip=false: ship the exact binary unmodified
            # (reference main.go flag semantics).
            try:
                ElfFile(raw)
            except ElfError:
                return None
            return raw
        try:
            payload = extract_debuginfo(raw)
            ElfFile(payload)  # validate round-trips
        except (ElfError, Exception):
            return None
        with self._lock:
            self.stats.extracted += 1
        return payload
