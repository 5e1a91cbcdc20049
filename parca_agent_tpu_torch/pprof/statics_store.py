"""Warm statics + registry snapshot: the restart path of the encoder.

The port's copy of parca_agent_tpu's pprof/statics_store.py, with the
same file format byte for byte (magic, frame marks, CRC frames, record
layout, header JSON keys), so a snapshot either package writes adopts in
the other.

The per-pid pprof statics (head/tail sections, location blobs — see
pprof/window_encoder.py) are pure functions of the pid's location
registry and the sampling period, and that registry is stable across an
agent restart: the profiled processes did not move, so the same
mappings and addresses re-register. This module persists both. On the
encode-pipeline worker's window clock (never the capture thread) the
store serializes every pid's registry content plus its built statics
into ONE snapshot file, written crash-only: tmp sibling + os.replace so
readers only ever see a whole file, and every record individually
CRC32-framed so a torn or bit-rotted record is detected at adoption.
Each record also carries a content digest of its registry
(aggregator/dict.py registry_content_digest); adoption recomputes it
from the decoded content, so a record that frames correctly but decodes
to different content is discarded too.

Adoption (startup, before the profiler runs) is per-record crash-only:

  * a valid record installs the registry into the aggregator
    (adopt_registry — refused if the pid already exists) and the statics
    into the encoder (adopt_statics);
  * a corrupt record (CRC, framing, decode, digest) is counted and
    skipped — the pid simply cold-builds;
  * a stale snapshot (older than max_age_s) or a stale record (pid
    already registered) adopts nothing for that scope, counted;
  * a record whose period differs from the configured one still adopts
    — registry and location blob stay valid; only the head/tail pair is
    rebuilt by the encoder's own staleness guard (counted stale here).

Adoption can therefore never make the agent wrong, only warm: registries
are append-only content the first window extends. A write failure is
counted and logged, never fatal (the original's chaos site at the head
of every save is not ported).
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib

from parca_agent_tpu_torch.aggregator.base import ProfileMapping
from parca_agent_tpu_torch.aggregator.dict import registry_content_digest
from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

_log = get_logger("statics-store")

# palint: persistence-root — the warm statics snapshot is adopted at startup.

_MAGIC = b"PASTATS1"
_FMARK = b"PSRC"                       # per-frame marker (resync anchor)
_FRAME = struct.Struct("<II")          # payload len, crc32(payload)
_REC_HEAD = struct.Struct("<IQIQ16s")  # pid, period_ns, n_mappings,
#                                        n_locs, registry digest
_MAP_ROW = struct.Struct("<IQQQQ")     # id, start, end, offset, base
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode()
    out += _U32.pack(len(b))
    out += b


class _Reader:
    """Bounds-checked cursor over one record payload; any overrun raises
    ValueError (the adoption loop counts it as corruption)."""

    __slots__ = ("data", "off")

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.data):
            raise ValueError("record truncated")
        out = self.data[self.off: self.off + n]
        self.off += n
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))

    def take_str(self, cap: int = 1 << 16) -> str:
        (n,) = self.unpack(_U32)
        if n > cap:
            raise ValueError("string field over cap")
        return self.take(n).decode()


class StaticsStore:
    """One snapshot file; save() runs on the encode worker, adopt() at
    startup, stats read from any thread (plain int/float slots —
    GIL-consistent)."""

    def __init__(self, path: str, max_bytes: int = 512 << 20,
                 max_age_s: float | None = 900.0, clock=time.time):
        self.path = path
        self._max_bytes = max_bytes
        self._max_age_s = max_age_s
        self._clock = clock
        # (registry version, rotation epoch, period) the file on disk
        # already describes: a clean steady state (stationary processes
        # => no registry mutations) skips the whole serialization pass.
        self._last_saved: tuple | None = None
        self.stats: dict[str, int | float] = {
            "snapshots_written": 0,
            "snapshots_skipped_clean": 0,
            "snapshot_bytes": 0,
            "snapshot_records": 0,
            "snapshot_write_errors": 0,
            "records_dropped_cap": 0,
            "records_adopted": 0,
            "records_stale": 0,
            "records_corrupt": 0,
            "snapshot_adopt_ms": 0.0,
            "snapshot_save_ms": 0.0,
        }

    # -- write side (encode worker) ------------------------------------------

    def save(self, agg, encoder, period_ns: int) -> bool:
        """Serialize the aggregator's per-pid registries plus the
        encoder's built statics into the snapshot file. Registries are
        read through frozen caps (append-only + published lengths), the
        same concurrent-reader contract build_statics uses, so a feed
        landing on the profiler thread mid-save can only make the
        snapshot slightly behind — never torn. False (counted) when the
        write fails; the agent carries on, one snapshot poorer. The
        whole body rides the counted try: this runs as an EncodePipeline
        snapshot hook, and an exception from the skip-check's stat()
        would otherwise read as an encoder death and disable the
        pipeline over a disk hiccup."""
        import numpy as np

        try:
            t0 = time.perf_counter()
            # Clean skip: nothing mutated any registry since the last
            # save (same version/epoch/period), so the file on disk is
            # already byte-equivalent — the common steady state, where
            # re-serializing every pid each interval would keep the
            # encode worker busy for seconds and push the NEXT window
            # into submit() backpressure.
            state = (getattr(agg, "_reg_version", None),
                     getattr(agg, "registry_epoch", 0), int(period_ns))
            # _last_saved records the state only when the encoder was
            # FULLY built at write time (see below), so matching it
            # means the file on disk carries complete statics for
            # exactly this content — a later encoder reset cannot
            # invalidate it (content unchanged).
            if state[0] is not None and state == self._last_saved \
                    and os.path.exists(self.path):
                try:
                    # The skip VERIFIED the on-disk content is current,
                    # so refresh the file's mtime as the liveness signal
                    # — otherwise a long stationary run would let the
                    # header timestamp rot past
                    # --statics-snapshot-max-age and the next restart
                    # would reject a perfectly current snapshot as stale
                    # (adoption ages by max(header, mtime)).
                    now = self._clock()
                    os.utime(self.path, times=(now, now))
                except OSError:
                    pass
                self.stats["snapshots_skipped_clean"] += 1
                return "skipped"  # truthy: the on-disk snapshot IS current
            # Chaos site: a failed snapshot is counted and skipped; the
            # window it followed is already shipped.
            faults.inject("statics.snapshot")
            # Whether the encoder's statics are provably complete at
            # this version (its clean marker): only then may this save's
            # state be recorded for future skips — else a straggler pid
            # whose statics finish after this write would stay
            # registry-only forever.
            enc_clean = (encoder is None or getattr(
                encoder, "_statics_clean", None)
                == (state[0], int(period_ns)))
            body = bytearray(_MAGIC)

            def _frame(payload) -> None:
                body.extend(_FMARK)
                body.extend(_FRAME.pack(len(payload),
                                        zlib.crc32(payload)))
                body.extend(payload)

            _frame(json.dumps({
                "version": 1,
                "created_at_unix": self._clock(),
                "period_ns": int(period_ns),
                "epoch": getattr(agg, "registry_epoch", 0),
            }).encode())
            n_records = dropped = 0
            for pid, reg in list(agg._pids.items()):
                # Location lengths FIRST, mapping count second — the
                # same read order _reg_cap documents: registries append
                # mappings BEFORE the location rows that reference them,
                # so nl-then-nm guarantees every persisted location's
                # mapping id resolves inside the persisted mapping rows
                # even while a feed is appending concurrently (extra
                # unreferenced mappings are legal; dangling ids are not).
                nl = min(len(reg.loc_address), len(reg.loc_normalized),
                         len(reg.loc_mapping_id), len(reg.loc_is_kernel))
                nm = len(reg.mappings)
                st = encoder._static.get(pid) if encoder is not None \
                    else None
                # Statics are snapshotted only as far as they are BUILT
                # against this registry prefix; a straggling pid still
                # snapshots its registry (the expensive half to rebuild).
                # st.reg identity guards the reused-pid hazard: a
                # rotation may have dropped and re-created this pid's
                # registry since the statics were built, and pairing NEW
                # registry content with OLD statics bytes would pass
                # every CRC/digest check while being silently wrong.
                has_statics = (st is not None and st.reg is reg
                               and 0 <= st.n_mappings <= nm
                               and st.n_locs <= nl)
                st_nm = st.n_mappings if has_statics else 0
                st_nl = st.n_locs if has_statics else 0
                st_period = st.period_ns if has_statics else int(period_ns)
                # Serialize the (small) mapping block first, then size
                # the whole record from lengths alone BEFORE the
                # expensive parts (numpy array dumps + content digest):
                # past the byte cap every remaining pid skips those
                # entirely, and the mapping strings are encoded once.
                map_block = bytearray()
                for m in reg.mappings[:nm]:
                    map_block += _MAP_ROW.pack(m.id, m.start, m.end,
                                               m.offset, m.base)
                    _pack_str(map_block, m.path)
                    _pack_str(map_block, m.build_id)
                rec_size = (_REC_HEAD.size + len(map_block) + 21 * nl
                            + _U32.size)
                if has_statics:
                    rec_size += (2 * _U32.size + 2 * _U64.size + _U32.size
                                 + len(st.head) + len(st.tail)
                                 + len(st.loc_bytes))
                if len(body) + len(_FMARK) + _FRAME.size + rec_size \
                        > self._max_bytes:
                    dropped += 1
                    continue
                # Digest the LOOP-LOCAL reg — the object the content
                # below is serialized from. Re-fetching by pid (e.g.
                # agg.registry_digest) could race a rotation-prune +
                # re-create on the profiler thread and pair old content
                # with a new registry's digest, reading as phantom
                # corruption at the next adoption.
                digest = registry_content_digest(
                    reg.mappings[:nm], reg.loc_address[:nl],
                    reg.loc_normalized[:nl], reg.loc_mapping_id[:nl],
                    reg.loc_is_kernel[:nl])
                rec = bytearray()
                rec += _REC_HEAD.pack(int(pid) & 0xFFFFFFFF,
                                      int(st_period) & (2**64 - 1),
                                      nm, nl, digest)
                rec += map_block
                rec += np.asarray(reg.loc_address[:nl],
                                  np.uint64).tobytes()
                rec += np.asarray(reg.loc_normalized[:nl],
                                  np.uint64).tobytes()
                rec += np.asarray(reg.loc_mapping_id[:nl],
                                  np.int32).tobytes()
                rec += np.asarray(reg.loc_is_kernel[:nl],
                                  np.uint8).tobytes()
                rec += _U32.pack(1 if has_statics else 0)
                if has_statics:
                    rec += _U32.pack(st_nm)
                    rec += _U64.pack(st_nl)
                    rec += _U32.pack(len(st.head))
                    rec += st.head
                    rec += _U32.pack(len(st.tail))
                    rec += st.tail
                    rec += _U64.pack(len(st.loc_bytes))
                    rec += st.loc_bytes
                assert len(rec) == rec_size
                _frame(bytes(rec))
                n_records += 1
            atomic_write_bytes(self.path, bytes(body))
            self._last_saved = state if enc_clean else None
            self.stats["snapshots_written"] += 1
            self.stats["snapshot_bytes"] = len(body)
            self.stats["snapshot_records"] = n_records
            self.stats["records_dropped_cap"] += dropped
            self.stats["snapshot_save_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            return True
        except Exception as e:  # noqa: BLE001 - a snapshot may fail for
            # any reason (disk, a serialization surprise) and must always
            # degrade to "no snapshot this interval", counted — never
            # crash the caller.
            self.stats["snapshot_write_errors"] += 1
            _log.warn("statics snapshot write failed; skipping",
                      error=repr(e))
            return False

    # -- read side (startup) -------------------------------------------------

    def adopt(self, agg, encoder, period_ns: int) -> dict:
        """Adopt the snapshot into a cold aggregator + encoder. Returns
        (and merges into stats) the outcome counts; every failure mode
        degrades to a cold build for that record only.

        The record loop allocates millions of tracked objects (addr
        dicts, location lists); CPython's gen-2 collector goes quadratic
        over exactly that shape, so collection is paused for the loop
        (restored in finally)."""
        import gc

        t0 = time.perf_counter()
        out = {"adopted": 0, "stale": 0, "corrupt": 0, "outcome": "adopted"}
        try:
            # Bound the READ itself: a misconfigured path or on-disk
            # growth must not materialize gigabytes on the startup path
            # before any validation runs.
            with open(self.path, "rb") as f:
                data = f.read(self._max_bytes + 1)
        except OSError:
            out["outcome"] = "absent"
            return out
        if len(data) > self._max_bytes:
            out["outcome"] = "corrupt"
            out["corrupt"] += 1
            self.stats["records_corrupt"] += 1
            _log.warn("statics snapshot over the byte cap; cold build",
                      cap=self._max_bytes)
            return out
        if not data.startswith(_MAGIC):
            out["outcome"] = "corrupt"
            self.stats["records_corrupt"] += 1
            out["corrupt"] += 1
            return out
        # Frame scan with per-frame RESYNC: every frame starts with the
        # _FMARK anchor, so a corrupted payload, length field, or torn
        # region costs the records it covers and the scan re-locks on
        # the next anchor — one bit flip can never silently discard the
        # rest of the file. A marker byte-pattern occurring inside a
        # payload only costs a wasted CRC check during resync.
        off = len(_MAGIC)
        head_len = len(_FMARK) + _FRAME.size
        frames: list[bytes] = []
        first_valid_at = None
        while 0 <= off < len(data):
            if data[off: off + len(_FMARK)] != _FMARK \
                    or off + head_len > len(data):
                out["corrupt"] += 1
                nxt = data.find(_FMARK, off + 1)
                if nxt < 0:
                    break
                off = nxt
                continue
            length, crc = _FRAME.unpack_from(data, off + len(_FMARK))
            start = off + head_len
            payload = data[start: start + length]
            if len(payload) != length or zlib.crc32(payload) != crc:
                out["corrupt"] += 1
                nxt = data.find(_FMARK, off + 1)
                if nxt < 0:
                    break
                off = nxt
                continue
            if first_valid_at is None:
                first_valid_at = off
            frames.append(payload)
            off = start + length
        # The header is the frame at the very start of the file; if THAT
        # frame is gone, frame[0] is a pid record, not a header.
        header_ok = first_valid_at == len(_MAGIC)
        if not frames:
            out["outcome"] = "corrupt"
            self.stats["records_corrupt"] += out["corrupt"]
            return out
        created = None
        if header_ok:
            try:
                created = float(json.loads(frames[0])
                                .get("created_at_unix", 0.0))
            except (ValueError, TypeError):
                out["corrupt"] += 1
        if created is not None:
            try:
                # Freshness is the NEWER of the header timestamp (last
                # content write) and the file mtime (refreshed by every
                # clean skip): a stationary agent keeps its snapshot
                # adoptable without rewriting it.
                created = max(created, os.stat(self.path).st_mtime)
            except OSError:
                pass
        # A lost header must not demote frame 0's SUCCESSOR to header:
        # without header_ok every valid frame is a pid record.
        records = frames[1:] if header_ok else frames
        if self._max_age_s is not None and (
                created is None
                or self._clock() - created > self._max_age_s):
            # Too old — or the header (the only age evidence) is gone
            # while an age bar is configured: with the age unknowable,
            # honoring the operator's bar means rejecting, counted as
            # stale. Without an age bar a lost header costs only the
            # header; every record still adopts below.
            out["outcome"] = "stale"
            out["stale"] += len(records)
            self.stats["records_stale"] += out["stale"]
            self.stats["records_corrupt"] += out["corrupt"]
            _log.info("statics snapshot stale; cold build",
                      age_s=(round(self._clock() - created, 1)
                             if created is not None else None))
            return out
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            for payload in records:
                try:
                    self._adopt_record(payload, agg, encoder, period_ns,
                                       out)
                except (ValueError, struct.error, UnicodeDecodeError):
                    out["corrupt"] += 1
        finally:
            if gc_was_enabled:
                gc.enable()
        self.stats["records_adopted"] += out["adopted"]
        self.stats["records_stale"] += out["stale"]
        self.stats["records_corrupt"] += out["corrupt"]
        self.stats["snapshot_adopt_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        if not out["adopted"]:
            # A legal header-only file (snapshotted before any pid
            # registered) is EMPTY, not corrupt — a false corruption
            # signal would send an operator chasing nonexistent rot.
            out["outcome"] = ("stale" if out["stale"]
                              else "corrupt" if out["corrupt"]
                              else "empty")
        _log.info("statics snapshot adoption done", **{
            k: v for k, v in out.items()})
        return out

    def _adopt_record(self, payload: bytes, agg, encoder, period_ns: int,
                      out: dict) -> None:
        import numpy as np

        r = _Reader(payload)
        pid, rec_period, nm, nl, digest = r.unpack(_REC_HEAD)
        mappings = []
        for _ in range(nm):
            mid, start, end, offset, base = r.unpack(_MAP_ROW)
            path = r.take_str()
            build_id = r.take_str()
            mappings.append(ProfileMapping(
                id=mid, start=start, end=end, offset=offset, path=path,
                build_id=build_id, base=base))
        loc_address = np.frombuffer(r.take(8 * nl), np.uint64)
        loc_normalized = np.frombuffer(r.take(8 * nl), np.uint64)
        loc_mapping_id = np.frombuffer(r.take(4 * nl), np.int32)
        loc_is_kernel = np.frombuffer(r.take(nl), np.uint8).astype(bool)
        # The stored digest must match the digest of what we DECODED —
        # ties the statics blobs to this exact registry content and
        # catches any corruption/skew the CRC framing did not.
        if registry_content_digest(mappings, loc_address, loc_normalized,
                                   loc_mapping_id, loc_is_kernel) != digest:
            raise ValueError("registry content digest mismatch")
        (has_statics,) = r.unpack(_U32)
        statics = None
        if has_statics:
            (st_nm,) = r.unpack(_U32)
            (st_nl,) = r.unpack(_U64)
            (n_head,) = r.unpack(_U32)
            head = r.take(n_head)
            (n_tail,) = r.unpack(_U32)
            tail = r.take(n_tail)
            (n_loc,) = r.unpack(_U64)
            loc_bytes = r.take(n_loc)
            if st_nm > nm or st_nl > nl:
                raise ValueError("statics extend past the registry")
            statics = (head, tail, loc_bytes, st_nm, st_nl)
        # .tolist() (C-level) — per-element Python conversion made
        # adoption cost more than the cold build it replaces.
        if not agg.adopt_registry(int(pid), mappings,
                                  loc_address.tolist(),
                                  loc_normalized.tolist(),
                                  loc_mapping_id.tolist(),
                                  loc_is_kernel.tolist()):
            out["stale"] += 1  # pid already live: adoption is cold-start only
            return
        if encoder is not None and statics is not None:
            head, tail, loc_bytes, st_nm, st_nl = statics
            encoder.adopt_statics(int(pid), head, tail, loc_bytes,
                                  st_nm, st_nl, int(rec_period))
            if int(rec_period) != int(period_ns):
                # Registry + locations adopt warm; the head/tail pair
                # embeds the old period and will rebuild on first use.
                out["stale"] += 1
        out["adopted"] += 1

    # -- observability -------------------------------------------------------

    def snapshot_info(self) -> dict:
        """One-line statics state: file presence, size, and age, plus the
        adoption outcome counts."""
        info = {
            "path": self.path,
            "present": False,
            "bytes": 0,
            "age_s": None,
            "adopted": self.stats["records_adopted"],
            "stale": self.stats["records_stale"],
            "corrupt": self.stats["records_corrupt"],
            "snapshots_written": self.stats["snapshots_written"],
            "write_errors": self.stats["snapshot_write_errors"],
        }
        try:
            st = os.stat(self.path)
            info["present"] = True
            info["bytes"] = st.st_size
            info["age_s"] = round(max(0.0, self._clock() - st.st_mtime), 1)
        except OSError:
            pass
        return info
