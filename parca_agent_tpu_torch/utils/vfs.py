"""Filesystem injection seam, and the crash-atomic file write.

Every component that reads procfs or ELF files takes a `VFS` so tests run
against in-memory trees (the port's copy of parca_agent_tpu's
utils/vfs.py). Paths are absolute strings; FakeFS keys are absolute paths.
"""

from __future__ import annotations

import io
import os
from typing import Iterable, Protocol

# palint: persistence-root — atomic_write_bytes is the shared tmp+rename primitive.


class VFS(Protocol):
    def read_bytes(self, path: str) -> bytes: ...
    def exists(self, path: str) -> bool: ...
    def listdir(self, path: str) -> list[str]: ...
    def open(self, path: str) -> io.BufferedIOBase: ...

    def stat_signature(self, path: str) -> tuple:
        """Cheap file-identity tuple for change detection and cross-path
        dedup. Must distinguish files across devices (the agent reads
        through /proc/<pid>/root/, crossing container mounts)."""
        ...


class RealFS:
    """The host filesystem."""

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> list[str]:
        return os.listdir(path)

    def open(self, path: str):
        return open(path, "rb")

    def stat_signature(self, path: str) -> tuple:
        st = os.stat(path)
        # st_dev matters: inode numbers are only unique per device, and
        # /proc/<pid>/root paths cross container filesystems.
        return (st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns)


class FakeFS:
    """In-memory tree: {absolute_path: bytes}."""

    def __init__(self, files: dict[str, bytes] | None = None):
        self.files = dict(files or {})
        self._version = 0

    def put(self, path: str, data: bytes) -> None:
        self.files[path] = data
        self._version += 1

    def read_bytes(self, path: str) -> bytes:
        try:
            return self.files[path]
        except KeyError:
            raise FileNotFoundError(path) from None

    def exists(self, path: str) -> bool:
        if path in self.files:
            return True
        prefix = path.rstrip("/") + "/"
        return any(p.startswith(prefix) for p in self.files)

    def listdir(self, path: str) -> list[str]:
        prefix = path.rstrip("/") + "/"
        names = {p[len(prefix):].split("/", 1)[0]
                 for p in self.files if p.startswith(prefix)}
        if not names and not self.exists(path):
            raise FileNotFoundError(path)
        return sorted(names)

    def open(self, path: str):
        return io.BytesIO(self.read_bytes(path))

    def stat_signature(self, path: str) -> tuple:
        data = self.read_bytes(path)
        # Content hash stands in for (dev, inode): distinct fake files
        # must never collide just by having equal lengths.
        import hashlib

        digest = hashlib.blake2b(data, digest_size=8).hexdigest()
        return (digest, len(data), self._version)


class ErrorFS:
    """Every operation raises `err` — exercises error paths in tests."""

    def __init__(self, err: Exception):
        self.err = err

    def _raise(self, *a, **k):
        raise self.err

    read_bytes = exists = listdir = open = stat_signature = _raise


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> None:
    """Crash-atomic file write: tmp sibling + os.replace, tmp cleaned on
    failure. Readers of `path` only ever see a whole file (the
    local-store profile writer and the snapshot fixtures depend on this
    — a crash mid-write must never leave a truncated artifact)."""
    tmp = os.fspath(path) + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fake_procfs(pids: Iterable[int], extra: dict[str, bytes] | None = None) -> FakeFS:
    """A minimal /proc skeleton for the given pids."""
    files = {}
    for pid in pids:
        files[f"/proc/{pid}/comm"] = f"proc{pid}\n".encode()
    files.update(extra or {})
    return FakeFS(files)
