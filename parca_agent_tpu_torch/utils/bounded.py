"""The abandonable bounded call: one shared guard for wedge-able work.

The port's own copy of parca_agent_tpu/utils/bounded.py. A fleet peer
lost mid-collective (or a wedged device runtime) blocks inside a C call
no exception ever leaves and no thread can cancel; the only containment
is to run the call where it can be ABANDONED. Used by the bounded fleet
join and the fleet collective guard (parallel/distributed.py) — one
implementation, so the subtle parts (BaseException capture, the
done-event ordering that lets callers gate on "the abandoned call may
still be executing") stay in sync.
"""

from __future__ import annotations

import threading


def bounded_call(thunk, timeout_s: float, thread_name: str = "bounded-call"):
    """Run ``thunk`` on an abandonable daemon thread, bounded by
    ``timeout_s``. A daemon thread, NOT a ThreadPoolExecutor: pool
    workers are non-daemon and joined at interpreter exit, so one wedged
    call would block process shutdown forever.

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

    def call():
        try:
            box["out"] = thunk()
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=call, name=thread_name, daemon=True).start()
    if done.wait(timeout_s):
        if "err" in box:
            return "err", box["err"], done, box
        return "ok", box["out"], done, box
    return "hang", None, done, box
