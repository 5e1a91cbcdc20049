"""Discovery manager: providers push target groups, consumers read a
debounced merged view (the port's copy of parca_agent_tpu's
discovery/manager.py).

Role of the reference's Prometheus-SD-style pkg/discovery/
discovery_manager.go:86-300: each named provider runs in its own thread
pushing [Group] updates; the manager coalesces updates and publishes the
full map at most once per debounce interval. Instead of Go channels the
published state is a versioned snapshot guarded by a condition variable —
`wait_for_update(version)` is the SyncCh equivalent.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Protocol


@dataclasses.dataclass
class Group:
    """One target group (reference target.go:22-35)."""

    source: str
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    pids: list[int] = dataclasses.field(default_factory=list)
    entry_pid: int = 0


class Discoverer(Protocol):
    def run(self, stop: threading.Event,
            up: Callable[[list[Group]], None]) -> None: ...


class DiscoveryManager:
    def __init__(self, debounce_s: float = 5.0):
        self._debounce = debounce_s
        self._providers: dict[str, Discoverer] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._groups: dict[str, dict[str, Group]] = {}  # provider -> source -> group
        self._version = 0
        self._last_publish = 0.0
        self._dirty = False
        self.failed_updates = 0

    def apply_config(self, providers: dict[str, Discoverer]) -> None:
        """Register providers (reference ApplyConfig + provider registry)."""
        self._providers.update(providers)

    def run(self) -> None:
        for name, p in self._providers.items():
            self._spawn(name, p)

    def _spawn(self, name: str, p: Discoverer) -> None:
        t = threading.Thread(
            target=self._run_provider, args=(name, p),
            name=f"discovery-{name}", daemon=True,
        )
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    # -- supervision hooks (runtime/supervisor.py probe actor) ---------------

    def alive(self) -> bool:
        """True while every started provider thread is still running (a
        provider that raised died silently before; the supervisor's probe
        surfaces and heals it). Fail-open supervisor probe (palint
        fail-open-hook): an exception here reads as unhealthy, never as
        a dead poll loop."""
        try:
            # Snapshot first: restart_dead (the revive hook) mutates the
            # list, and "list changed size during iteration" out of a
            # health probe would be self-harm.
            return all(t.is_alive() for t in list(self._threads))
        except Exception:  # noqa: BLE001 - probe contract: never raise
            self.failed_updates += 1
            return False

    def restart_dead(self) -> int:
        """Respawn provider threads that died (the supervisor's revive
        hook). Returns how many were restarted. Fail-open: a respawn
        failure (thread limits, a provider constructor raising) is
        counted and retried at the next probe tick."""
        try:
            if self._stop.is_set():
                return 0
            restarted = 0
            for t in [t for t in self._threads if not t.is_alive()]:
                # Per-provider containment: one spawn failure (thread
                # limits) must not abort the remaining respawns or
                # discard the count of those already restarted. Spawn
                # FIRST, drop the dead entry only on success: a failed
                # spawn leaves the corpse in _threads so alive() stays
                # False and the next probe tick retries — removing
                # first would read as healthy with the provider
                # silently gone.
                try:
                    name = t.name.removeprefix("discovery-")
                    p = self._providers.get(name)
                    if p is not None:
                        self._spawn(name, p)
                        restarted += 1
                    self._threads.remove(t)
                except Exception:  # noqa: BLE001 - probe contract
                    self.failed_updates += 1
            return restarted
        except Exception:  # noqa: BLE001 - probe contract: never raise
            self.failed_updates += 1
            return 0

    def _run_provider(self, name: str, p: Discoverer) -> None:
        def up(groups: list[Group]) -> None:
            self._update(name, groups)

        try:
            p.run(self._stop, up)
        except Exception:
            with self._lock:
                self.failed_updates += 1

    def _update(self, provider: str, groups: list[Group]) -> None:
        with self._cond:
            # Each provider update carries its FULL current target set:
            # replacing the provider's map (not merging into it) is what
            # lets dead sources disappear, so exited containers/units stop
            # labeling recycled PIDs and the map stays bounded.
            self._groups[provider] = {g.source: g for g in groups}
            now = time.monotonic()
            self._dirty = True
            # Debounce: publish immediately if quiet, else mark dirty and
            # let the next update (or reader poll) publish.
            if now - self._last_publish >= self._debounce:
                self._publish_locked(now)

    def _publish_locked(self, now: float) -> None:
        self._version += 1
        self._last_publish = now
        self._dirty = False
        self._cond.notify_all()

    def flush(self) -> None:
        """Force-publish pending updates (tests, shutdown)."""
        with self._cond:
            if self._dirty:
                self._publish_locked(time.monotonic())

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def groups(self) -> list[Group]:
        """Current merged view across providers."""
        with self._lock:
            if self._dirty and \
                    time.monotonic() - self._last_publish >= self._debounce:
                self._publish_locked(time.monotonic())
            return [g for per in self._groups.values() for g in per.values()]

    def wait_for_update(self, seen_version: int, timeout: float | None = None) -> int:
        """Block until the published version advances past seen_version
        (the SyncCh read equivalent). Returns the new version."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._version > seen_version, timeout=timeout
            )
            return self._version
