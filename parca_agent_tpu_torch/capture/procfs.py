"""Unprivileged procfs capture source (the port's copy of
parca_agent_tpu's capture/procfs.py).

The capture hierarchy:

  1. native perf_event sampler (capture/live.py + native/) — real user+kernel
     call stacks, needs perf_event_open permission;
  2. THIS: /proc/<pid>/stat CPU-tick accounting — whole-machine per-process
     CPU attribution with depth-1 stacks, needs only procfs read access.

Per window: sample utime+stime of every PID at poll_hz; the per-PID tick
delta over the window becomes the sample count (1 tick = 1/USER_HZ s of
CPU). The single stack frame is the process's runtime entry point
(ELF entry + load bias) so the profile symbolizes to the binary — honest
"which process burns CPU" attribution, never fabricated call chains. The
mapping table is the PID's real /proc/maps, so address normalization,
build ids, and debuginfo upload all exercise the true pipeline.
"""

from __future__ import annotations

import time

import numpy as np

from parca_agent_tpu_torch.capture.formats import (
    STACK_SLOTS,
    MappingTable,
    WindowSnapshot,
)
from parca_agent_tpu_torch.elf.base import BaseError, compute_base
from parca_agent_tpu_torch.elf.reader import ElfFile
from parca_agent_tpu_torch.process.maps import (
    ProcessMapCache,
    build_mapping_table,
    host_path,
)
from parca_agent_tpu_torch.utils import poison
from parca_agent_tpu_torch.utils.poison import PoisonInput, read_bounded
from parca_agent_tpu_torch.utils.vfs import VFS, RealFS

USER_HZ = 100  # kernel tick rate exposed in /proc/*/stat


def read_cpu_ticks(fs: VFS, pid: int) -> int | None:
    """utime+stime from /proc/pid/stat (fields 14/15, after the comm that
    may itself contain spaces/parens)."""
    try:
        data = fs.read_bytes(f"/proc/{pid}/stat")
    except OSError:
        return None
    # comm is parenthesized and may contain ')' — split after the LAST ')'.
    rp = data.rfind(b")")
    if rp < 0:
        return None
    fields = data[rp + 2:].split()
    if len(fields) < 13:
        return None
    try:
        return int(fields[11]) + int(fields[12])  # utime, stime
    except ValueError:
        return None


class ProcfsSampler:
    def __init__(self, fs: VFS | None = None, frequency_hz: int = 100,
                 window_s: float = 10.0, poll_hz: float = 2.0,
                 clock=time.monotonic, sleep=time.sleep):
        self._fs = fs or RealFS()
        self._freq = frequency_hz
        self._window = window_s
        self._poll_interval = 1.0 / poll_hz
        self._clock = clock
        self._sleep = sleep
        self._maps = ProcessMapCache(fs=self._fs)
        # Ingest containment (runtime/quarantine.py), set by the CLI.
        self.quarantine = None
        self._prev: dict[int, int] = {}
        self._started = False
        # (path, start, offset) -> runtime entry addr; constant per mapping.
        self._entry_cache: dict[tuple, int | None] = {}

    def _pid_mappings(self, pid: int) -> list:
        """executable_mappings with the poison taxonomy contained: an
        exited pid or a poisoned maps file degrades to 'no mappings' for
        this pid, never aborting the whole window's collect; with a
        quarantine registry the poison is charged to the pid."""
        try:
            return self._maps.executable_mappings(pid)
        except OSError:
            return []
        except PoisonInput as e:
            if self.quarantine is not None:
                self.quarantine.record_error(
                    pid, getattr(e, "site", "maps.parse"), e)
            return []

    def _pids(self) -> list[int]:
        try:
            return [int(n) for n in self._fs.listdir("/proc") if n.isdigit()]
        except OSError:
            return []

    def sample_ticks(self) -> dict[int, int]:
        out = {}
        for pid in self._pids():
            t = read_cpu_ticks(self._fs, pid)
            if t is not None:
                out[pid] = t
        return out

    def _entry_address(self, pid: int) -> int | None:
        """Runtime entry point: ELF entry + load bias of the exec mapping."""
        maps = self._pid_mappings(pid)
        if not maps:
            return None
        m = maps[0]
        key = (m.path, m.start, m.offset)
        if key in self._entry_cache:
            return self._entry_cache[key]
        try:
            ef = ElfFile(read_bounded(self._fs, host_path(pid, m.path),
                                      poison.ELF_READ_CAP))
            base = compute_base(ef, ef.exec_load_segment(),
                                m.start, m.end, m.offset)
            addr = (ef.entry + base) % 2**64
        except (OSError, PoisonInput, BaseError):
            # Unreadable/poison binary (incl. injected elf.read faults —
            # PoisonInput covers the whole ingest taxonomy): attribute
            # to the mapping start.
            addr = m.start
        if len(self._entry_cache) > 4096:
            self._entry_cache.clear()
        self._entry_cache[key] = addr
        return addr

    def collect(self, deltas: dict[int, int]) -> WindowSnapshot:
        """Tick deltas -> snapshot with real mappings + entry-point frames."""
        rows = []
        per_pid_maps = {}
        for pid, ticks in sorted(deltas.items()):
            if ticks <= 0:
                continue
            addr = self._entry_address(pid)
            if addr is None:
                continue
            per_pid_maps[pid] = self._pid_mappings(pid)
            # Scale kernel ticks (USER_HZ) to the nominal sampling frequency
            # so counts are comparable with real samplers at frequency_hz.
            count = max(1, ticks * self._freq // USER_HZ)
            rows.append((pid, addr, count))

        n = len(rows)
        stacks = np.zeros((n, STACK_SLOTS), np.uint64)
        pids = np.zeros(n, np.int32)
        counts = np.zeros(n, np.int64)
        for i, (pid, addr, count) in enumerate(rows):
            pids[i] = pid
            stacks[i, 0] = addr
            counts[i] = count
        table = build_mapping_table(per_pid_maps) if per_pid_maps \
            else MappingTable.empty()
        return WindowSnapshot(
            pids=pids,
            tids=pids.copy(),
            counts=counts,
            user_len=np.full(n, 1, np.int32),
            kernel_len=np.zeros(n, np.int32),
            stacks=stacks,
            mappings=table,
            period_ns=int(1e9 / self._freq),
            window_ns=int(self._window * 1e9),
            time_ns=time.time_ns(),
        )

    def accumulate(self, window_deltas: dict[int, int]) -> None:
        """One poll step: fold tick deltas since the previous step into
        window_deltas. New PIDs first seen mid-window contribute their full
        tick count (a process born inside the window spent all of it here);
        PIDs that exit keep whatever they accumulated — the reason polling
        runs at poll_hz instead of only at window edges."""
        cur = self.sample_ticks()
        for pid, t in cur.items():
            prev = self._prev.get(pid)
            if prev is None:
                # PID first seen mid-run: a genuinely new process, count all
                # its ticks. (prev == 0 is a real observation, not missing.)
                delta = t if self._started else 0
            else:
                delta = t - prev
            if delta > 0:
                window_deltas[pid] = window_deltas.get(pid, 0) + delta
        self._prev = cur

    def poll(self) -> WindowSnapshot:
        """Block for one window, accumulating tick deltas at poll_hz."""
        if not self._started:
            self._prev = self.sample_ticks()
            self._started = True
        window_deltas: dict[int, int] = {}
        deadline = self._clock() + self._window
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            self._sleep(min(self._poll_interval, remaining))
            self.accumulate(window_deltas)
        return self.collect(window_deltas)
