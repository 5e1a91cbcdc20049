"""Actor supervision: a run-group that restarts crashed actors.

Role of the reference's oklog/run group (cmd/parca-agent/main.go:505-592)
— but where the reference tears the whole process down when any actor
exits, an always-on profiler must NOT die because one component crashed:
the profiler is the last thing allowed to take a node down. So this
run-group restarts a crashed actor with capped exponential backoff, marks
it dead after ``max_restarts`` crashes (crash-looping forever would just
hide the bug), and surfaces per-actor state for ``/healthz``:

    healthy   running, no recent crash
    degraded  restarted within the last ``healthy_after_s`` seconds
    dead      crash budget exhausted (a critical dead actor turns the
              whole /healthz red)
    exited    returned cleanly (e.g. a replay source ran dry)

Two supervision styles:

  * ``add_actor(name, run, stop)`` — a thread-backed long-running actor
    (the batch flush loop, the profiler loop, the config reloader). The
    supervisor owns the thread and restarts it on an escaped exception.
  * ``add_probe(name, check, revive)`` — a component that owns its own
    thread/lifecycle (the encode pipeline's worker, the discovery
    manager's provider threads). The supervisor's tick polls ``check()``
    and calls ``revive()`` on failure, with the same crash budget.

Actors may call ``faults.inject("actor.<name>")`` at their loop tick so
the chaos layer can kill them at a named site.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from parca_agent_tpu_torch.utils.log import get_logger

_log = get_logger("supervisor")


@dataclasses.dataclass
class _Actor:
    name: str
    run: object = None            # callable | None (probe actors)
    stop_fn: object = None
    check: object = None          # probe: () -> bool healthy
    revive: object = None         # probe: () -> None
    critical: bool = True
    restarts: int = 0             # cumulative (the /metrics counter)
    strikes: int = 0              # consecutive-ish crashes (the budget);
    #                               reset after a sustained healthy run
    last_crash_at: float | None = None
    last_error: BaseException | None = None
    dead: bool = False
    finished: bool = False        # clean return
    thread: threading.Thread | None = None


class Supervisor:
    def __init__(self, max_restarts: int = 5,
                 backoff_initial_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 healthy_after_s: float = 30.0,
                 probe_tick_s: float = 1.0,
                 clock=time.monotonic, sleep=None):
        self._max_restarts = max_restarts
        self._backoff_initial = backoff_initial_s
        self._backoff_max = backoff_max_s
        self._healthy_after = healthy_after_s
        self._tick = probe_tick_s
        self._clock = clock
        self._stop = threading.Event()
        self._sleep = sleep or (lambda s: self._stop.wait(s))
        self._lock = threading.Lock()
        self._actors: dict[str, _Actor] = {}
        self._probe_thread: threading.Thread | None = None
        self._started = False

    # -- registration --------------------------------------------------------

    def add_actor(self, name: str, run, stop=None,
                  critical: bool = True) -> None:
        if name in self._actors:
            raise ValueError(f"duplicate actor {name!r}")
        self._actors[name] = _Actor(name=name, run=run, stop_fn=stop,
                                    critical=critical)
        if self._started:
            self._start_actor(self._actors[name])

    def add_probe(self, name: str, check, revive=None,
                  critical: bool = True) -> None:
        if name in self._actors:
            raise ValueError(f"duplicate actor {name!r}")
        self._actors[name] = _Actor(name=name, check=check, revive=revive,
                                    critical=critical)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._started = True
        for a in self._actors.values():
            if a.run is not None:
                self._start_actor(a)
        if any(a.check is not None for a in self._actors.values()):
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="supervisor-probe",
                daemon=True)
            self._probe_thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Tear down in REVERSE registration order, joining each actor
        before stopping the next: upstream actors (registered last, e.g.
        the profiler) finish draining into downstream ones (registered
        first, e.g. the batch flush loop) before those run their final
        drain. ``timeout_s`` is PER ACTOR — a slow profiler join must
        not leave the flush actor's final drain with a zero budget (the
        drain of exactly the windows the profiler just handed over)."""
        self._stop.set()
        for a in reversed(list(self._actors.values())):
            if a.stop_fn is not None:
                try:
                    a.stop_fn()
                except Exception as e:  # noqa: BLE001 - teardown continues
                    _log.warn("actor stop hook failed", actor=a.name,
                              error=repr(e))
            t = a.thread
            if t is not None and t.is_alive():
                t.join(timeout_s)
                if t.is_alive():
                    _log.warn("actor did not stop within its budget",
                              actor=a.name, timeout_s=timeout_s)
        if self._probe_thread is not None:
            self._probe_thread.join(timeout_s)

    # -- thread actors -------------------------------------------------------

    def _start_actor(self, a: _Actor) -> None:
        a.thread = threading.Thread(target=self._run_actor, args=(a,),
                                    name=f"actor-{a.name}", daemon=True)
        a.thread.start()

    def _run_actor(self, a: _Actor) -> None:
        while not self._stop.is_set():
            try:
                a.run()
                a.finished = True
                return
            except Exception as e:  # noqa: BLE001 - the point of supervision
                if self._stop.is_set():
                    return
                self._note_crash(a, e)
                if a.dead:
                    return
                backoff = min(
                    self._backoff_initial * (2 ** (a.strikes - 1)),
                    self._backoff_max)
                _log.warn("actor crashed; restarting after backoff",
                          actor=a.name, restarts=a.restarts,
                          backoff_s=round(backoff, 3), error=repr(e))
                self._sleep(backoff)
            except BaseException as e:  # noqa: BLE001 - terminal, never
                # restarted (SystemExit and friends are not crashes to
                # supervise through) — but the death must be VISIBLE:
                # before supervision, thread death was caught by the
                # CLI's is_alive() check; mark the actor dead so
                # finished()/health() report it instead of an eternally
                # "healthy" corpse.
                with self._lock:
                    a.last_error = e
                    a.last_crash_at = self._clock()
                    a.dead = True
                _log.error("actor raised a terminal BaseException; "
                           "marking dead", actor=a.name, exc=e)
                return

    def _note_crash(self, a: _Actor, e: BaseException) -> None:
        with self._lock:
            now = self._clock()
            if a.last_crash_at is not None and \
                    now - a.last_crash_at >= self._healthy_after:
                # A sustained healthy run refreshes the crash budget: an
                # always-on agent must only die for crash LOOPS, not for
                # max_restarts transient crashes spread over weeks of
                # uptime. `restarts` stays cumulative for the metric.
                a.strikes = 0
            a.restarts += 1
            a.strikes += 1
            a.last_crash_at = now
            a.last_error = e
            if a.strikes > self._max_restarts:
                a.dead = True
                _log.error("actor exhausted its crash budget; marking dead",
                           actor=a.name, restarts=a.restarts, exc=e)

    # -- probe actors --------------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.poll_probes()
            self._stop.wait(self._tick)

    def poll_probes(self) -> None:
        """One probe pass over every check-style actor (the tick thread
        calls this; tests and simulated-time harnesses call it directly)."""
        for a in self._actors.values():
            if a.check is None or a.dead:
                continue
            try:
                healthy = bool(a.check())
            except Exception as e:  # noqa: BLE001 - a broken probe = unhealthy
                healthy = False
                a.last_error = e
            if healthy:
                continue
            self._note_crash(a, a.last_error
                             or RuntimeError(f"probe {a.name} unhealthy"))
            if a.dead or a.revive is None:
                continue
            try:
                a.revive()
                _log.warn("probe actor revived", actor=a.name,
                          restarts=a.restarts)
            except Exception as e:  # noqa: BLE001 - next tick retries
                a.last_error = e
                _log.warn("probe actor revive failed", actor=a.name,
                          error=repr(e))

    # -- observability -------------------------------------------------------

    def _state(self, a: _Actor) -> str:
        if a.dead:
            return "dead"
        if a.finished:
            return "exited"
        if a.last_crash_at is not None and \
                self._clock() - a.last_crash_at < self._healthy_after:
            return "degraded"
        return "healthy"

    def health(self) -> dict[str, dict]:
        with self._lock:
            out = {}
            for a in self._actors.values():
                alive = (a.thread.is_alive() if a.thread is not None
                         else a.check is not None and not a.dead)
                out[a.name] = {
                    "state": self._state(a),
                    "restarts": a.restarts,
                    "alive": bool(alive and not a.finished),
                    "critical": a.critical,
                    "last_error": (repr(a.last_error)[:200]
                                   if a.last_error else ""),
                }
            return out

    def overall(self) -> str:
        """healthy | degraded | dead for the /healthz headline. Only
        critical actors can turn it dead; any degraded actor (critical
        or not) turns it degraded."""
        worst = "healthy"
        for name, h in self.health().items():
            if h["state"] == "dead" and h["critical"]:
                return "dead"
            if h["state"] in ("dead", "degraded"):
                worst = "degraded"
        return worst

    def finished(self, name: str) -> bool:
        a = self._actors.get(name)
        return a is not None and (a.finished or a.dead)

    def actor_restarts(self) -> dict[str, int]:
        with self._lock:
            return {a.name: a.restarts for a in self._actors.values()}
