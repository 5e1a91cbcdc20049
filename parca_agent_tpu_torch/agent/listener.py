"""Matching profile listener: tee in the write path for live queries.

Role of the reference's pkg/agent/matching_profile_listener.go:44-127: the
HTTP /query endpoint registers an observer with Prometheus-style label
matchers and receives the next raw profile whose labels match; regular
writes flow through to the next writer unchanged.

The port's copy of parca_agent_tpu's agent/listener.py.
"""

from __future__ import annotations

import threading
from typing import Callable

Matcher = Callable[[dict[str, str]], bool]


def equals_matcher(**want: str) -> Matcher:
    return lambda labels: all(labels.get(k) == v for k, v in want.items())


class _Observer:
    def __init__(self, matcher: Matcher):
        self.matcher = matcher
        self.event = threading.Event()
        self.result: tuple[dict[str, str], bytes] | None = None


class MatchingProfileListener:
    def __init__(self, next_writer=None):
        self._next = next_writer
        self._lock = threading.Lock()
        self._observers: list[_Observer] = []

    def write_raw(self, labels: dict[str, str], sample: bytes) -> None:
        with self._lock:
            remaining = []
            for ob in self._observers:
                if ob.result is None and ob.matcher(labels):
                    ob.result = (dict(labels), sample)
                    ob.event.set()
                else:
                    remaining.append(ob)
            self._observers = remaining
        if self._next is not None:
            self._next.write_raw(labels, sample)

    def next_matching_profile(self, matcher: Matcher,
                              timeout: float | None = None
                              ) -> tuple[dict[str, str], bytes] | None:
        ob = _Observer(matcher)
        with self._lock:
            self._observers.append(ob)
        if not ob.event.wait(timeout):
            with self._lock:
                if ob in self._observers:
                    self._observers.remove(ob)
            return None
        return ob.result
