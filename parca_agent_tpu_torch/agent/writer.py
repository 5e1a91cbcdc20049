"""Profile writers: local files and remote (via listener/batcher).

Role of the reference's pkg/profiler/profile_writer.go:32-97:
FileProfileWriter stores each window's profile as a .pb.gz under a
directory (--local-store-directory mode); RemoteProfileWriter gzips the
encoded pprof and hands it to the write path (listener -> batch client).

Thread contract: in fast-encode mode write() is called from the encode
pipeline's worker thread (ship overlaps the next window's capture), and
may be called CONCURRENTLY from the profiler thread on the scalar
fallback path — both writers must (and do) tolerate that:
FileProfileWriter does one self-contained open/write per profile under a
nanosecond-stamped filename, RemoteProfileWriter's gzip is pure and its
downstream batch buffer is lock-protected. `pprof_bytes` may be any bytes-like (the pipeline
ships zero-copy memoryviews into the encoder's template buffer; the gzip
pass here materializes them before the view is recycled).

The port's copy of parca_agent_tpu's agent/writer.py.
"""

from __future__ import annotations

import gzip
import os
import time

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

# palint: persistence-root — local profile store writes survive restarts.


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
        """`sample` is already a gzipped pprof proto. Written through a
        tmp file + os.replace so a crash (or injected disk-full) mid-write
        never leaves a truncated .pb.gz in the local-store directory —
        readers of the directory only ever see whole profiles."""
        path = os.path.join(self._dir, _series_filename(labels, time.time_ns()))
        faults.inject("writer.write")
        atomic_write_bytes(path, sample)

    def write(self, labels: dict[str, str],
              pprof_bytes: bytes | memoryview) -> None:
        """Profile-writer interface: encode side handles gzip."""
        self.write_raw(labels, gzip.compress(pprof_bytes, 1))


class RemoteProfileWriter:
    """pprof bytes -> gzip -> downstream write_raw sink."""

    def __init__(self, sink):
        self._sink = sink

    def write(self, labels: dict[str, str],
              pprof_bytes: bytes | memoryview) -> None:
        self._sink.write_raw(labels, gzip.compress(pprof_bytes, 1))


class TeeProfileWriter:
    """Fan one profile write to several writers (--local-store-directory
    plus the remote path). Arms are constructed ONCE, here — the old CLI
    closure built a fresh RemoteProfileWriter per write. A failing arm
    aborts the remaining arms, like the single-writer path: the caller's
    per-profile error handling owns the failure either way."""

    def __init__(self, *writers):
        self._writers = writers

    def write(self, labels: dict[str, str],
              pprof_bytes: bytes | memoryview) -> None:
        for w in self._writers:
            w.write(labels, pprof_bytes)
