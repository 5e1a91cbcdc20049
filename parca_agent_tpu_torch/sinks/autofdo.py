"""AutoFDO sink: per-binary LLVM profdata-text profiles keyed by build-id.

Closes the sampling -> compiler loop the roadmap's PGO papers argue for
("From Profiling to Optimization", arxiv 2507.16649; "Hardware Counted
Profile-Guided Optimization", arxiv 1411.6361): the agent already holds
exactly the data an AutoFDO consumer wants — binary-relative leaf
addresses with exact per-stack sample counts — so this sink folds every
shipped window's leaf samples into per-binary accumulators and
periodically persists them as LLVM sample-profile TEXT records.

Format (docs/sinks.md pins it; the golden fixture in
tests/test_sinks.py holds the bytes):

    <name>:<total_samples>:<total_samples>
     0x<offset>: <count>
     ...

one record per binary, one body line per distinct normalized (binary-
relative) leaf address, offsets ascending. The agent ships unsymbolized
(the reference's contract — the server symbolizes), so the record is at
BINARY granularity with raw offsets where upstream AutoFDO text has
per-function records with line offsets; ``llvm-profgen``-style tooling
that has the binary can split it by symbol table (docs/parity.md
records the deviation). Kernel leaves are counted but not attributed
(AutoFDO targets userspace binaries); unmapped leaves likewise.

Keying: the mapping's build id (elf/buildid.py fills it at capture);
a mapping without one falls back to a content hash of its path, so
same-named binaries from different images never merge. One file per
key: ``<key>.afdo.txt``.

Persistence is crash-only, like agent/spool.py segments: accumulate in
memory, every ``flush_windows``-th emitted window rewrite the dirty
binaries' files via tmp+rename (utils/vfs.atomic_write_bytes), so a
reader only ever sees whole profiles and a crash costs at most the
un-flushed windows — never a torn file. On restart the sink ADOPTS the
directory: each parseable file seeds its binary's accumulator, so
counts keep accumulating monotonically and nothing is replayed or
double-counted; an unparseable file is counted and skipped (it will be
overwritten at the next flush of that key).

Memory is bounded: at most ``max_binaries`` accumulators and
``max_offsets`` distinct offsets per binary; past either cap the
samples are dropped and counted (``samples_dropped``) — the hot
offsets were admitted first and AutoFDO cares about those.
"""

from __future__ import annotations

import hashlib
import os
import re

from parca_agent_tpu_torch.utils import faults
from parca_agent_tpu_torch.utils.log import get_logger
from parca_agent_tpu_torch.utils.vfs import atomic_write_bytes

# palint: persistence-root — profdata files survive restarts (adoption).

_log = get_logger("sink-autofdo")

_SUFFIX = ".afdo.txt"
_STALE_SUFFIX = ".stale"
_SAFE_KEY = re.compile(r"[^0-9a-zA-Z._-]")
_BODY_RE = re.compile(r"^ 0x([0-9a-f]+): (\d+)$")


def binary_key(mapping) -> str:
    """Stable per-binary key: the build id (filesystem-safe), else a
    content hash of the path so same-named binaries from different
    images never merge. Shared with the regression sentinel
    (runtime/regression.py) so drift verdicts and profdata files agree
    on the binary's identity."""
    if mapping.build_id:
        return _SAFE_KEY.sub("_", mapping.build_id)
    digest = hashlib.blake2b((mapping.path or "?").encode(),
                             digest_size=16).hexdigest()
    return f"p-{digest}"


class _Binary:
    __slots__ = ("key", "name", "counts", "dirty")

    def __init__(self, key: str, name: str):
        self.key = key
        self.name = name
        self.counts: dict[int, int] = {}  # normalized offset -> samples
        self.dirty = False


def render_profile(name: str, counts: dict[int, int]) -> bytes:
    """One binary's accumulator as an LLVM sample-profile text record.
    Deterministic: offsets ascending, fields ':'-safe."""
    safe = name.replace(":", "_").replace("\n", "_") or "unknown"
    total = sum(counts.values())
    lines = [f"{safe}:{total}:{total}"]
    for off in sorted(counts):
        lines.append(f" 0x{off:x}: {counts[off]}")
    return ("\n".join(lines) + "\n").encode()


def parse_profile(data: bytes) -> tuple[str, dict[int, int]]:
    """Inverse of render_profile, for restart adoption. Raises ValueError
    on anything this writer would not have produced."""
    text = data.decode()
    lines = text.split("\n")
    if not lines or lines[-1] != "":
        raise ValueError("missing trailing newline")
    lines.pop()
    if not lines:
        raise ValueError("empty profile")
    head = lines[0].rsplit(":", 2)
    if len(head) != 3:
        raise ValueError("bad header")
    name, total_s, head_s = head
    counts: dict[int, int] = {}
    for ln in lines[1:]:
        m = _BODY_RE.match(ln)
        if m is None:
            raise ValueError(f"bad body line {ln!r}")
        counts[int(m.group(1), 16)] = int(m.group(2))
    if int(total_s) != sum(counts.values()) or total_s != head_s:
        raise ValueError("totals do not match the body")
    return name, counts


class AutoFDOSink:
    name = "autofdo"

    def __init__(self, directory: str, flush_windows: int = 6,
                 max_binaries: int = 256, max_offsets: int = 65536,
                 adopt: bool = True):
        if flush_windows < 1:
            raise ValueError("flush_windows must be >= 1")
        self._dir = directory
        self._flush_every = flush_windows
        self._max_binaries = max_binaries
        self._max_offsets = max_offsets
        self._emits = 0          # flush-cadence clock: every emit ticks
        self._acc: dict[str, _Binary] = {}
        self.stats = {
            "windows": 0,
            "windows_skipped": 0,   # no registry view: frames unreadable
            "samples": 0,
            "samples_kernel": 0,
            "samples_unmapped": 0,
            "samples_dropped": 0,
            "binaries": 0,
            "flushes": 0,
            "flush_errors": 0,
            "bytes": 0,             # profdata bytes written (crash-only)
            "files_adopted": 0,
            "adopt_errors": 0,
            "stale_marked": 0,      # regression-sentinel staleness marks
        }
        os.makedirs(directory, exist_ok=True)
        if adopt:
            self._adopt()

    # -- restart adoption ----------------------------------------------------

    def _adopt(self) -> None:
        """Seed accumulators from the previous run's flushed profiles —
        the spool-segment adoption pattern: whole files only (the writes
        were atomic), unparseable ones counted and skipped, and nothing
        re-added (the file IS the previous run's total, so post-restart
        windows accumulate on top instead of replaying)."""
        for fname in sorted(os.listdir(self._dir)):
            if not fname.endswith(_SUFFIX):
                continue
            key = fname[: -len(_SUFFIX)]
            try:
                with open(os.path.join(self._dir, fname), "rb") as f:
                    name, counts = parse_profile(f.read())
            except (OSError, ValueError, UnicodeDecodeError) as e:
                self.stats["adopt_errors"] += 1
                _log.warn("unparseable autofdo profile skipped at "
                          "adoption; it will be overwritten",
                          file=fname, error=repr(e))
                continue
            if len(self._acc) >= self._max_binaries:
                self.stats["adopt_errors"] += 1
                continue
            b = _Binary(key, name)
            b.counts = counts
            self._acc[key] = b
            self.stats["files_adopted"] += 1
        self.stats["binaries"] = len(self._acc)

    # -- fold path (registry-serialized) -------------------------------------

    def _key_for(self, mapping) -> str:
        return binary_key(mapping)

    def emit(self, win) -> None:
        # The flush cadence ticks on EVERY emit — including skipped and
        # empty windows — so dirty accumulated state can never out-wait
        # the flush_windows crash-loss bound just because the workload
        # went idle or the view capture kept failing.
        self._emits += 1
        try:
            self._fold(win)
        finally:
            if self._emits % self._flush_every == 0:
                self.flush()

    def _fold(self, win) -> None:
        view = win.view
        if view is None:
            # No rotation-consistent mirror capture for this window:
            # reading the live arrays would race cold-stack rotation.
            self.stats["windows_skipped"] += 1
            return
        idx = win.idx
        if not len(idx):
            self.stats["windows"] += 1
            return
        # Leaf-most frame first (capture/formats.py stack contract):
        # the leaf location id of stack `sid` is loc_flat[loc_off[sid]].
        leaf = view._loc_flat[view._loc_off[idx]]
        pids = win.pids_live
        vals = win.vals
        acc = self._acc
        st = self.stats
        for i in range(len(idx)):
            v = int(vals[i])
            cap = win.caps.get(int(pids[i]))
            j = int(leaf[i]) - 1  # registry loc ids are 1-based
            if cap is None or not (0 <= j < cap[2]):
                st["samples_unmapped"] += v
                continue
            reg = cap[0]
            if reg.loc_is_kernel[j]:
                st["samples_kernel"] += v
                continue
            mid = int(reg.loc_mapping_id[j])
            if not (1 <= mid <= cap[1]):
                st["samples_unmapped"] += v
                continue
            m = reg.mappings[mid - 1]
            key = self._key_for(m)
            b = acc.get(key)
            if b is None:
                if len(acc) >= self._max_binaries:
                    st["samples_dropped"] += v
                    continue
                b = acc[key] = _Binary(
                    key, os.path.basename(m.path) or key)
            off = int(reg.loc_normalized[j])
            if off not in b.counts and len(b.counts) >= self._max_offsets:
                st["samples_dropped"] += v
                continue
            b.counts[off] = b.counts.get(off, 0) + v
            b.dirty = True
            st["samples"] += v
        st["windows"] += 1
        st["binaries"] = len(acc)

    # -- crash-only persistence ----------------------------------------------

    def flush(self) -> None:
        """Rewrite every dirty binary's profile via tmp+rename. A failed
        file is counted and stays dirty (retried next flush); the error
        propagates after the remaining files were attempted, so one full
        disk never silently stalls the whole set."""
        first_err: Exception | None = None
        wrote = 0
        for b in self._acc.values():
            if not b.dirty:
                continue
            data = render_profile(b.name, b.counts)
            try:
                faults.inject("sink.flush")
                atomic_write_bytes(
                    os.path.join(self._dir, b.key + _SUFFIX), data)
            except Exception as e:  # noqa: BLE001 - per-file containment
                self.stats["flush_errors"] += 1
                if first_err is None:
                    first_err = e
                continue
            b.dirty = False
            wrote += 1
            self.stats["bytes"] += len(data)
        if wrote:
            self.stats["flushes"] += 1
        if first_err is not None:
            raise first_err

    def mark_stale(self, key: str) -> None:
        """Regression-sentinel staleness signal (runtime/regression.py
        drift verdicts): drop a crash-only ``<key>.stale`` marker beside
        the binary's profdata and count it, so a downstream PGO consumer
        knows the emitted profile no longer matches the live behavior
        and must refresh rather than trust it ("From Profiling to
        Optimization", arxiv 2507.16649 — stale profiles actively hurt).
        The marker persists until the consumer removes it; later flushes
        keep updating the profdata beside it. May raise (disk): the
        sentinel's counted fail-open hook guard owns the failure. Runs
        on the encode worker — the same thread pipelined emits run on,
        and a distinct file from any flush target, so no write can tear."""
        safe = _SAFE_KEY.sub("_", key)
        atomic_write_bytes(
            os.path.join(self._dir, safe + _STALE_SUFFIX),
            b"stale: profile drift exceeded threshold\n")
        self.stats["stale_marked"] += 1

    def close(self) -> None:
        self.flush()
