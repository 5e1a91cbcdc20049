"""Cheap content hashing for cache invalidation.

The role minio/highwayhash plays in the reference (pkg/hash/hash.go:36-58:
hash a file to detect change without parsing it). blake2b is in-stdlib,
keyed, and fast enough for the few-MB files involved (kallsyms, perf maps,
/proc/PID/maps).
"""

from __future__ import annotations

import hashlib

from parca_agent_tpu_torch.utils.vfs import VFS

_KEY = b"parca-agent-tpu-filehash"


def hash_bytes(data: bytes) -> int:
    h = hashlib.blake2b(data, key=_KEY, digest_size=8)
    return int.from_bytes(h.digest(), "little")


def hash_file(fs: VFS, path: str) -> int:
    return hash_bytes(fs.read_bytes(path))
