"""Local profile store: one .pb.gz per profile under a directory.

Role of the reference's pkg/profiler/profile_writer.go:32-97 in
--local-store-directory mode. Each profile is one self-contained
tmp-file + rename under a nanosecond-stamped filename, so readers of
the directory only ever see whole profiles.
"""

from __future__ import annotations

import gzip
import os
import time

from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes


def _series_filename(labels: dict[str, str], now_ns: int) -> str:
    parts = [f"{k}={labels[k]}" for k in sorted(labels)
             if not k.startswith("__")]
    safe = "_".join(parts).replace("/", "-") or "profile"
    return f"{safe}.{now_ns}.pb.gz"


class FileProfileWriter:
    def __init__(self, directory: str):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)

    def write_raw(self, labels: dict[str, str], sample: bytes) -> None:
        """`sample` is already a gzipped pprof proto."""
        path = os.path.join(self._dir, _series_filename(labels, time.time_ns()))
        atomic_write_bytes(path, sample)

    def write(self, labels: dict[str, str],
              pprof_bytes: bytes | memoryview) -> None:
        """Profile-writer interface: encode side handles gzip."""
        self.write_raw(labels, gzip.compress(pprof_bytes, 1))
