"""systemd service discovery (the port's copy of parca_agent_tpu's
discovery/systemd.py).

Role of the reference's pkg/discovery/systemd.go:48-107 (D-Bus
SubscribeUnitsCustom on .service units, reading MainPID, emitting Groups
labeled systemd_unit). No D-Bus client library exists in this image, so
the same facts come from systemctl — injectable as `runner` so tests feed
canned output and hosts without systemd skip cleanly.
"""

from __future__ import annotations

import dataclasses
import subprocess
import threading
from typing import Callable

from parca_agent_tpu_torch.discovery.manager import Group


def _systemctl(args: list[str]) -> str:
    return subprocess.run(
        ["systemctl", *args], capture_output=True, text=True, timeout=10,
    ).stdout


@dataclasses.dataclass
class SystemdDiscoverer:
    units: tuple[str, ...] = ()        # empty = all .service units
    poll_s: float = 5.0
    runner: Callable[[list[str]], str] = _systemctl

    def scrape(self) -> list[Group]:
        names = list(self.units)
        if not names:
            listing = self.runner(
                ["list-units", "--type=service", "--state=running",
                 "--plain", "--no-legend", "--no-pager"]
            )
            names = [ln.split()[0] for ln in listing.splitlines() if ln.split()]
        if not names:
            return []
        # One batched `show` for all units (blank-line-separated blocks in
        # argument order) instead of N+1 execs per scrape.
        out = self.runner(["show", "-p", "MainPID", "--value", *names])
        values = out.split("\n\n") if out else []
        groups = []
        for unit, block in zip(names, values):
            try:
                pid = int(block.strip())
            except ValueError:
                continue
            if pid <= 0:
                continue
            groups.append(Group(
                source=f"systemd/{unit}",
                labels={"systemd_unit": unit},
                pids=[pid],
                entry_pid=pid,
            ))
        return groups

    def run(self, stop: threading.Event,
            up: Callable[[list[Group]], None]) -> None:
        while not stop.is_set():
            try:
                up(self.scrape())
            except (OSError, subprocess.SubprocessError):
                pass  # systemd absent or transient failure; retry next poll
            stop.wait(self.poll_s)
