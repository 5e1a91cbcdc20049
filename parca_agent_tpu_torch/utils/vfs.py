"""Filesystem helpers."""

from __future__ import annotations

import os


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
