"""The abandonable bounded call: one shared guard for wedge-able work.

The port's own copy of parca_agent_tpu/utils/bounded.py. A fleet peer
lost mid-collective (or a wedged device runtime) blocks inside a C call
no exception ever leaves and no thread can cancel; the only containment
is to run the call where it can be ABANDONED. Used by the bounded fleet
join and the fleet collective guard (parallel/distributed.py), the
device-health probe (runtime/device_health.py), the window's device
call and the inline encode's deadline (profiler/cpu.py) and the
streaming feeder's feeds (profiler/streaming.py). One implementation, so
the subtle parts (BaseException capture, the done-event ordering that
lets callers gate on "the abandoned call may still be executing") stay
in sync.

The device watchdogs bound only the call's waits on the card
(``waits_only``): a host wait on the device (an upload that syncs the
stream, a fetch, an ``.item()``) is marked with :func:`device_wait`, and
the call is abandoned when one such wait stays open past the timeout.
The host work between the waits (a cold window's miss settle, tens of
seconds at the bench width) is not timed: it is not the card's, and a
wedged card shows at its next wait.
"""

from __future__ import annotations

import contextlib
import threading
import time

# How often a waits-only bound looks at its call's open device wait.
_TICK_S = 0.1

_local = threading.local()


class _WaitClock:
    """When the bounded call's open device wait began (None between
    waits)."""

    __slots__ = ("since",)

    def __init__(self):
        self.since = None


@contextlib.contextmanager
def device_wait():
    """Mark a host wait on the device. Inside ``bounded_call(...,
    waits_only=True)`` only such waits count against the timeout;
    anywhere else this is a no-op. Nested waits count as the outer one."""
    clock = getattr(_local, "clock", None)
    if clock is None or clock.since is not None:
        yield
        return
    clock.since = time.monotonic()
    try:
        yield
    finally:
        clock.since = None


def _wait_device(done: threading.Event, clock: _WaitClock,
                 timeout_s: float) -> bool:
    """Wait for ``done`` until one device wait of the call has been open
    for ``timeout_s``; True once the call returned."""
    tick = min(timeout_s, _TICK_S)
    while True:
        since = clock.since
        if since is None:
            if done.wait(tick):
                return True
            continue
        left = since + timeout_s - time.monotonic()
        if left <= 0:
            return done.is_set()
        if done.wait(min(left, tick)):
            return True


def bounded_call(thunk, timeout_s: float, thread_name: str = "bounded-call",
                 waits_only: bool = False):
    """Run ``thunk`` on a new abandonable daemon thread, bounded by
    ``timeout_s``: its whole run, or with ``waits_only`` each of its
    device waits (:func:`device_wait`). A daemon thread, NOT a
    ThreadPoolExecutor: pool workers are non-daemon and joined at
    interpreter exit, so one wedged call would block process shutdown
    forever.

    Returns ``(status, value, done, box)``:

      * ``("ok", result, ...)`` — the call returned in time;
      * ``("err", exception, ...)`` — it raised in time;
      * ``("hang", None, done, box)`` — it blew the deadline and was
        abandoned. It may STILL be executing: ``done`` (a
        threading.Event) fires when it finally returns, and ``box`` then
        holds ``"out"`` or ``"err"`` — callers that share state with the
        thunk must gate on ``done`` before touching it again, and should
        inspect ``box`` for a late error instead of discarding it.

    The box is filled BEFORE the event fires, so ``done.is_set()``
    guarantees the box is complete.
    """
    box: dict = {}
    done = threading.Event()
    clock = _WaitClock() if waits_only else None

    def call():
        _local.clock = clock
        try:
            box["out"] = thunk()
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=call, name=thread_name, daemon=True).start()
    finished = (done.wait(timeout_s) if clock is None
                else _wait_device(done, clock, timeout_s))
    if finished:
        if "err" in box:
            return "err", box["err"], done, box
        return "ok", box["out"], done, box
    return "hang", None, done, box

