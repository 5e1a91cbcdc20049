"""Replay source: feed saved WindowSnapshot fixtures through the agent.

The reference has no replay path — its aggregation can only be exercised
against live BPF maps (SURVEY.md section 4 closing note). ReplaySource is the
fixture seam that lets every downstream layer run kernel-free.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

from parca_agent_tpu_torch.capture.formats import WindowSnapshot, load_snapshot


class ReplaySource:
    """Iterates snapshots from files or in-memory values.

    Implements the capture-source protocol: ``poll()`` returns the next
    window's snapshot or None when exhausted.
    """

    def __init__(self, items: Sequence[WindowSnapshot | str | os.PathLike]):
        self._items = list(items)
        self._pos = 0

    def poll(self) -> WindowSnapshot | None:
        if self._pos >= len(self._items):
            return None
        item = self._items[self._pos]
        self._pos += 1
        if isinstance(item, WindowSnapshot):
            return item
        return load_snapshot(item)

    def __iter__(self) -> Iterator[WindowSnapshot]:
        while (snap := self.poll()) is not None:
            yield snap
