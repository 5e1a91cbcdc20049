"""Alerts sink: crash-only JSONL verdict records from the sentinel.

The regression sentinel (runtime/regression.py) turns rollup diffs into
verdicts; this sink is how they leave the process for operators'
tooling: one JSON object per line appended to a local file, the
append-only twin of the spool's crash-only discipline — every record is
a whole line, a crash can tear at most the final line, and a reader
that skips a torn tail has lost nothing committed. Rotation is
crash-only too: past ``max_bytes`` the live file os.replace()s the
``.1`` sibling (readers only ever see whole files).

It is a registered Sink (sinks/registry.py) deliberately: the registry
already owns the fail-open contract, the per-sink serialization lock,
and the /metrics//healthz surfaces — the verdict drain just rides every
shipped window's emit tick (and the close flush), so alert latency is
bounded by the window cadence without any new thread. ``emit`` drains
whatever verdicts sealed since the last window; a window with no
verdicts (the steady state) costs one deque check.
"""

from __future__ import annotations

import json
import os

from parca_agent_tpu_torch.utils.log import get_logger

# palint: persistence-root — verdict records are append-only crash files.

_log = get_logger("sink-alerts")


class AlertsSink:
    name = "alerts"

    def __init__(self, path: str, sentinel=None, max_bytes: int = 16 << 20):
        if max_bytes < 4096:
            raise ValueError("max_bytes must be >= 4096")
        self._path = path
        self._max_bytes = max_bytes
        self._sentinel = sentinel
        self.stats = {
            "windows": 0,
            "verdicts": 0,
            "bytes": 0,
            "rotations": 0,
        }
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def emit(self, win) -> None:
        """Drain the sentinel's pending verdicts to disk. May raise (a
        full disk): the registry's counted fail-open guard owns it, and
        the drained records are REQUEUED into the sentinel's bounded
        ring first, so a failed append retries at the next window
        instead of losing verdicts."""
        self.stats["windows"] += 1
        if self._sentinel is None:
            return
        records = self._sentinel.drain_alerts()
        if not records:
            return
        self._append(records)

    def _append(self, records) -> None:
        data = "".join(
            json.dumps(rec, separators=(",", ":")) + "\n"
            for rec in records).encode()
        try:
            try:
                size = os.path.getsize(self._path)
            except OSError:
                size = 0
            if size + len(data) > self._max_bytes and size > 0:
                # Crash-only rotation: one atomic replace; a crash
                # between the replace and the next append costs nothing
                # committed.
                os.replace(self._path, self._path + ".1")
                self.stats["rotations"] += 1
            with open(self._path, "ab") as f:
                f.write(data)
        except Exception:
            # The disk said no: hand the records back to the sentinel's
            # ring (retried next window) and let the registry's
            # fail-open guard count the failure.
            self._sentinel.requeue_alerts(records)
            raise
        self.stats["verdicts"] += len(records)
        self.stats["bytes"] += len(data)

    def flush(self) -> None:
        """Appends are unbuffered (one open/write per drain); flush just
        drains anything a final window left pending."""
        if self._sentinel is None:
            return
        records = self._sentinel.drain_alerts()
        if records:
            self._append(records)

    def close(self) -> None:
        self.flush()
