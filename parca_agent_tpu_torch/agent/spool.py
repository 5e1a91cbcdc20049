"""Disk spill spool: CRC-framed write-ahead segments for the ship path.

The reference's batch client retries forever with an unbounded in-memory
buffer; an hours-long store outage therefore costs either the host's
profile history or the agent's RSS. Here the batch client spills whole
batches to this spool instead: one segment file per batch, written
tmp-then-rename (crash-atomic), each series CRC32-framed so a torn or
bit-rotted segment is detected at replay rather than shipped corrupt.
The payload per frame is the wire codec's own single-series
WriteRawRequest encoding (gzipped pprof inside — spill is cheap), so
replay needs no second format.

Size cap: when total spool bytes exceed ``max_bytes`` the OLDEST
segments are evicted first (the newest data is the most valuable in a
profiler — history beyond the cap is the sacrifice) and every dropped
sample/byte is counted, never silent.

Segment layout::

    MAGIC "PASPOOL1" | u32 n_samples | frames...
    frame: u32 len | u32 crc32(payload) | payload

Thread contract: read/pop run on the batch client's flush thread, but
append also runs on whatever thread hits the buffer's overflow spill
(the capture thread or the encode pipeline's worker), and the
stats/pending accessors are read from the HTTP metrics thread — all
shared state is lock-guarded, and the read path re-checks the index
after its unlocked file read (a concurrent append's eviction may have
unlinked the segment under it).

The port's copy of parca_agent_tpu's agent/spool.py.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

from parca_agent_tpu_torch.agent.profilestore import (
    RawSeries,
    decode_write_raw_request,
    encode_write_raw_request,
)
from parca_agent_tpu_torch.runtime import trace as window_trace
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

_log = get_logger("spool")

# palint: persistence-root — the spool dir IS the crash-only pattern's home.

_MAGIC = b"PASPOOL1"
_HEADER = struct.Struct("<I")   # n_samples
_FRAME = struct.Struct("<II")   # len, crc32


class SpoolDir:
    def __init__(self, directory: str, max_bytes: int = 256 << 20,
                 clock=time.monotonic):
        self._dir = directory
        self._max_bytes = max_bytes
        self._clock = clock
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        # seq -> (bytes, samples, appended_at). Crash leftovers are
        # adopted with appended_at = adoption time (their true age is
        # unknowable across the monotonic-clock restart), so replay lag
        # counts from adoption — nonzero the moment a restart inherits a
        # backlog, which is exactly when the lag gauge matters most.
        self._index: dict[int, tuple[int, int, float]] = {}  # guarded-by: _lock
        # Segments whose corruption has already been counted: a retained
        # partially-corrupt segment is re-read every replay attempt, and
        # its loss must be counted once, not once per attempt.
        self._corrupt_counted: set[int] = set()  # guarded-by: _lock
        self.stats = {  # guarded-by: _lock
            "segments_written": 0,
            "bytes_written": 0,
            "segments_replayed": 0,
            "segments_dropped": 0,
            "samples_dropped": 0,
            "bytes_dropped": 0,
            "corrupt_segments": 0,
            "disk_errors": 0,
        }
        self._next_seq = 1
        self._scan()

    # -- startup adoption ----------------------------------------------------

    def _path(self, seq: int) -> str:
        return os.path.join(self._dir, f"{seq:012d}.seg")

    def _scan(self) -> None:
        """Adopt segments a previous process left behind (crash-only
        recovery: whatever survived the rename barrier is replayable).
        Runs at construction only, but takes the (uncontended) lock
        anyway: the index/stats discipline then holds unconditionally
        (palint lock-discipline) instead of relying on "called before
        the object is shared" staying true."""
        with self._lock:
            self._scan_locked()

    def _scan_locked(self) -> None:  # palint: holds=_lock
        for name in sorted(os.listdir(self._dir)):
            path = os.path.join(self._dir, name)
            if name.endswith(".tmp"):
                # A torn write from a crashed predecessor: never valid.
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not name.endswith(".seg"):
                continue
            try:
                seq = int(name[:-4])
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    head = f.read(len(_MAGIC) + _HEADER.size)
                if not head.startswith(_MAGIC):
                    raise ValueError("bad magic")
                (n_samples,) = _HEADER.unpack(
                    head[len(_MAGIC):len(_MAGIC) + _HEADER.size])
            except (ValueError, OSError):
                self.stats["corrupt_segments"] += 1
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self._index[seq] = (size, n_samples, self._clock())
            self._next_seq = max(self._next_seq, seq + 1)
        if self._index:
            _log.info("adopted spilled segments from a previous run",
                      segments=len(self._index))

    # -- write side ----------------------------------------------------------

    def append(self, series: list[RawSeries]) -> bool:
        """Spill one batch as a new segment; evict oldest segments past
        the byte cap. False (with counted drops) when the disk write
        itself fails — the batch is lost, but the agent lives."""
        n_samples = sum(len(s.samples) for s in series)
        t0 = time.perf_counter()  # spool_spill stage (runtime/trace.py)
        body = bytearray(_MAGIC)
        body += _HEADER.pack(n_samples)
        for s in series:
            payload = encode_write_raw_request([s], normalized=True)
            body += _FRAME.pack(len(payload), zlib.crc32(payload))
            body += payload
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        # The disk write runs OUTSIDE the lock: a multi-MB spill must not
        # stall the flush thread's replay or the metrics thread for the
        # write's duration. The segment only becomes visible (index
        # insert) after the rename barrier.
        try:
            faults.inject("spool.write")
            atomic_write_bytes(self._path(seq), bytes(body))
        except OSError as e:
            with self._lock:
                self.stats["disk_errors"] += 1
                self.stats["samples_dropped"] += n_samples
                self.stats["bytes_dropped"] += len(body)
            _log.warn("spool write failed; batch dropped",
                      samples=n_samples, error=repr(e))
            # Failed spills are observed too: a slow-then-failing disk
            # is precisely the stall the histogram exists to explain.
            window_trace.observe("spool_spill", time.perf_counter() - t0)
            return False
        with self._lock:
            self._index[seq] = (len(body), n_samples, self._clock())
            self.stats["segments_written"] += 1
            self.stats["bytes_written"] += len(body)
            self._evict_locked()
        # One spill end-to-end (encode + frame + atomic write): the
        # latency a capture-thread overflow pays — exactly what the
        # flight recorder's spool_spill histogram must answer for.
        window_trace.observe("spool_spill", time.perf_counter() - t0)
        return True

    def _evict_locked(self) -> None:  # palint: holds=_lock
        while self._index and self._total_bytes_locked() > self._max_bytes:
            seq = min(self._index)
            size, n_samples, _ = self._index.pop(seq)
            try:
                os.unlink(self._path(seq))
            except OSError:
                pass
            self.stats["segments_dropped"] += 1
            self.stats["samples_dropped"] += n_samples
            self.stats["bytes_dropped"] += size
            _log.warn("spool over byte cap; evicted oldest segment",
                      seq=seq, samples=n_samples)

    def _total_bytes_locked(self) -> int:  # palint: holds=_lock
        return sum(size for size, _, _ in self._index.values())

    # -- replay side ---------------------------------------------------------

    def read_oldest(self) -> tuple[int, list[RawSeries]] | None:
        """Decode the oldest segment (replay is oldest-first so the store
        receives history in order). A CRC/frame failure drops the BAD
        TAIL of the segment (frames before it are intact by construction)
        and counts the corruption; a fully corrupt segment is deleted and
        the next one is tried."""
        while True:
            with self._lock:
                if not self._index:
                    return None
                seq = min(self._index)
                _, n_samples, _ = self._index[seq]
            series, ok = self._read_segment(seq)
            if series:
                if not ok:
                    # Partial salvage: the torn/corrupt tail frames are a
                    # real loss — count the sample shortfall vs the
                    # header's total, not just the corruption event —
                    # ONCE per segment (a retained segment is re-read on
                    # every replay attempt while the store is down).
                    salvaged = sum(len(s.samples) for s in series)
                    with self._lock:
                        if seq in self._index and \
                                seq not in self._corrupt_counted:
                            self._corrupt_counted.add(seq)
                            self.stats["corrupt_segments"] += 1
                            self.stats["samples_dropped"] += max(
                                0, n_samples - salvaged)
                return seq, series
            # Nothing salvageable. Distinguish real corruption from a
            # concurrent eviction (an overflow-spill append on another
            # thread may have unlinked this segment after our index
            # lookup): an evicted segment was already counted as a drop
            # by _evict_locked and must not read as phantom corruption.
            with self._lock:
                meta = self._index.get(seq)
                if meta is None:
                    continue  # evicted under us; try the next oldest
                if seq not in self._corrupt_counted:
                    self._corrupt_counted.add(seq)
                    self.stats["corrupt_segments"] += 1
                    self.stats["samples_dropped"] += meta[1]
                    self.stats["bytes_dropped"] += meta[0]
            self.pop(seq, replayed=False)

    def _read_segment(self, seq: int) -> tuple[list[RawSeries], bool]:
        series: list[RawSeries] = []
        try:
            with open(self._path(seq), "rb") as f:
                data = f.read()
        except OSError:
            return [], False
        if not data.startswith(_MAGIC):
            return [], False
        off = len(_MAGIC) + _HEADER.size
        while off < len(data):
            if off + _FRAME.size > len(data):
                return series, False  # torn tail
            length, crc = _FRAME.unpack_from(data, off)
            off += _FRAME.size
            payload = data[off:off + length]
            off += length
            if len(payload) != length or zlib.crc32(payload) != crc:
                return series, False
            decoded, _ = decode_write_raw_request(payload)
            series.extend(decoded)
        return series, True

    def pop(self, seq: int, replayed: bool = True) -> None:
        """Delete a segment — after successful replay by default;
        ``replayed=False`` for corrupt-segment disposal so replay
        progress is never overstated while data is being lost."""
        with self._lock:
            meta = self._index.pop(seq, None)
            self._corrupt_counted.discard(seq)
            if meta is not None and replayed:
                self.stats["segments_replayed"] += 1
            try:
                os.unlink(self._path(seq))
            except OSError:
                pass

    # -- observability -------------------------------------------------------

    def pending(self) -> tuple[int, int]:
        """(segments, bytes) awaiting replay."""
        with self._lock:
            return len(self._index), self._total_bytes_locked()

    def oldest_age_s(self) -> float:
        """Age of the oldest pending segment (replay lag proxy); 0 when
        empty. Adopted pre-crash segments age from adoption time."""
        with self._lock:
            if not self._index:
                return 0.0
            _, _, at = self._index[min(self._index)]
            return max(0.0, self._clock() - at)
