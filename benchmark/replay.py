"""The one traffic generator: a closed-loop replay of BPF stack-count drains.

A configuration (``configs/<name>.json``) fixes the deployment: pids,
live unique stacks, samples a window, drains a window, the stack shape
(depth, kernel tails, mappings, functions an object) and the Zipf skew.
A traffic mix (``traffic/<name>.json``) fixes what changes from window
to window: how many pids exit and start (churn) and whether the windows
cycle through a pool drawn at set-up.

The population is a set of stack slots, each owned by a pid slot (equal
shares, assigned by a permutation) and each carrying a fixed Zipf weight
(rank by a second permutation), so hot stacks stay hot. A window draws
its counts anew: every live stack gets one sample and the rest of the
window's samples are spread by the Zipf weights, or, in a mix with
``every_stack_sampled`` false, all of them are, so rare stacks come and
go from window to window (a capture map holds no zero-count row either
way), then each row's count is split over the window's drains
by sequential binomials, so heavy rows appear in every drain and single
samples in one. A drain is its distinct rows with their counts, the
columns one drain of the BPF maps yields: (pids, tids, user_len,
kernel_len, stacks [n, 128] uint64 leaf first, counts).

Churn retires pid slots at random each window and gives each a fresh pid
number, a fresh executable mapping and fresh stacks in its stack slots
(a retired pid's maps stay cached: pid numbers are never reused).

Everything is drawn from ``seed`` (any non-negative integer), so the same
seed gives the same drains; ``Replay(...).window(w)`` must be called for
w = 0, 1, 2, ... in order (churn is a state). ``prepare()`` draws the
mix's pool, or its first ``ahead_windows`` windows, at set-up, so that
the measured interval only hands drains over; a run that outlasts them
draws the rest as it goes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SLOTS = 128
KERNEL_ADDR_START = 0xFFFF_8000_0000_0000
FIRST_PID = 1000
MAPPING_SIZE = 1 << 24          # 16 MiB of text a mapping
EXE_PATH = "/app/bin/worker"
PERIOD_NS_PER_S = 1_000_000_000
TIME0_NS = 1_700_000_000_000_000_000


def _rng(seed: int, *stream: int) -> np.random.Generator:
    # A seed below zero folds onto the non-negative ones SeedSequence takes.
    return np.random.default_rng([int(seed) % 2**64, *stream])


@dataclasses.dataclass(frozen=True)
class Mapping:
    """One executable file-backed row of a pid's maps."""

    start: int
    end: int
    offset: int
    path: str
    perms: str = "r-xp"
    dev: str = "08:01"
    inode: int = 1
    executable: bool = True
    file_backed: bool = True


@dataclasses.dataclass
class Window:
    """One window of the replay: its drains and what the check needs."""

    index: int
    drains: list            # [(pids, tids, ulen, klen, stacks, counts)]
    total: int              # samples in the window
    rows: int               # distinct (pid, stack) rows with samples
    time_ns: int
    check_pids: np.ndarray  # pids whose pprof the check decodes
    # The whole window as one capture's columns (window 0 only): what the
    # live source's window-end snapshot holds, a row a live stack.
    columns: tuple | None = None


class Replay:
    """The generator of one run (module docs)."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.cfg = config
        self.mix = traffic
        self.seed = int(seed)
        n_pids = int(config["pids"])
        n_stacks = int(config["unique_stacks"])
        if n_stacks < n_pids:
            raise ValueError("fewer stacks than pids")
        self.every = bool(traffic.get("every_stack_sampled", True))
        if self.every and int(config["samples_per_window"]) < n_stacks:
            raise ValueError("a window needs a sample for every live stack")
        if config["max_depth"] > SLOTS - 1:
            raise ValueError("stacks are at most 127 frames deep")
        self.n_pids, self.n_stacks = n_pids, n_stacks
        self.churn = int(traffic.get("churn_pids_per_window", 0))
        self.pool = int(traffic.get("pool_windows", 0))
        if self.churn and self.pool:
            raise ValueError("a churning population cannot cycle a pool")
        rng = _rng(seed, 0)
        self.pid_slot = rng.permutation(np.arange(n_stacks) % n_pids)
        per_pid = np.bincount(self.pid_slot, minlength=n_pids)
        want = traffic.get("stacks_per_new_pid")
        if self.churn and want is not None and not (per_pid == want).all():
            raise ValueError(f"churn gives each new pid {want} stacks: the "
                             "configuration must give every pid as many")
        ranks = rng.permutation(n_stacks).astype(np.float64) + 1.0
        w = ranks ** -float(config["zipf_s"])
        self.pvals = w / w.sum()
        self.pid_of_slot = np.arange(FIRST_PID, FIRST_PID + n_pids,
                                     dtype=np.int64)
        self.next_pid = FIRST_PID + n_pids
        self.n_shared = int(config["mappings_per_pid"]) - 1
        if self.n_shared < 1:
            raise ValueError("a pid maps its executable and a shared object")
        self.shared_base = (0x0000_7F00_0000_0000
                            + (np.arange(self.n_shared, dtype=np.uint64)
                               << np.uint64(28)))
        self.exe_base = self._exe_bases(rng, n_pids)
        self.ulen = np.zeros(n_stacks, np.int32)
        self.klen = np.zeros(n_stacks, np.int32)
        self.stacks = np.zeros((n_stacks, SLOTS), np.uint64)
        self._fill_stacks(rng, np.arange(n_stacks))
        self.maps: dict[int, list[Mapping]] = {}
        for p in range(n_pids):
            self._add_maps(p)
        self.ahead = int(traffic.get("ahead_windows", 0))
        self._pool: dict[int, Window] = {}
        self._stored: dict[int, Window] = {}
        self._next = 0          # the next window handed out
        self._drawn = 0         # the next window drawn
        self.retired: list[int] = []  # pids retired by the last window

    # -- population ------------------------------------------------------

    def _exe_bases(self, rng, n: int) -> np.ndarray:
        return 0x0000_5500_0000_0000 + (
            rng.integers(0, 1 << 20, n, dtype=np.uint64) << np.uint64(12))

    def _add_maps(self, pslot: int) -> None:
        pid = int(self.pid_of_slot[pslot])
        rows = [Mapping(int(self.exe_base[pslot]),
                        int(self.exe_base[pslot]) + MAPPING_SIZE, 0,
                        EXE_PATH)]
        for j in range(self.n_shared):
            start = int(self.shared_base[j])
            rows.append(Mapping(start, start + MAPPING_SIZE, 0x1000 * (j + 1),
                                f"/usr/lib/libshared{j}.so"))
        self.maps[pid] = rows

    def object_paths(self) -> list[str]:
        return [EXE_PATH] + [f"/usr/lib/libshared{j}.so"
                             for j in range(self.n_shared)]

    def _fill_stacks(self, rng, slots: np.ndarray) -> None:
        """Draw fresh frames for the stack slots `slots` (ragged: only the
        live frames are drawn)."""
        cfg = self.cfg
        n = len(slots)
        kmax = int(cfg["max_kernel_depth"])
        ulen = np.clip(rng.poisson(float(cfg["mean_depth"]), n), 2,
                       int(cfg["max_depth"]) - kmax).astype(np.int32)
        has_k = rng.random(n) < float(cfg["kernel_fraction"])
        klen = np.where(has_k, rng.integers(1, kmax + 1, n), 0).astype(
            np.int32)
        depth = (ulen + klen).astype(np.int64)
        total = int(depth.sum())
        row = np.repeat(np.arange(n), depth)
        col = np.arange(total) - np.repeat(np.cumsum(depth) - depth, depth)
        in_user = col < np.repeat(ulen, depth)
        nu = int(in_user.sum())
        funcs = int(cfg["functions_per_object"])
        off = (rng.integers(0, funcs, nu, dtype=np.uint64)
               << np.uint64(8)) + np.uint64(0x40)
        obj = rng.integers(0, self.n_shared + 1, nu)
        urow = row[in_user]
        base = np.where(obj == 0,
                        self.exe_base[self.pid_slot[slots[urow]]],
                        self.shared_base[np.maximum(obj - 1, 0)])
        frames = np.empty(total, np.uint64)
        frames[in_user] = base + off % np.uint64(MAPPING_SIZE)
        frames[~in_user] = np.uint64(KERNEL_ADDR_START) + (
            rng.integers(0, 65536, total - nu, dtype=np.uint64)
            << np.uint64(6))
        self.stacks[slots] = 0
        self.stacks[slots[row], col] = frames
        self.ulen[slots] = ulen
        self.klen[slots] = klen

    def _apply_churn(self, w: int) -> None:
        rng = _rng(self.seed, 2, w)
        gone = np.sort(rng.choice(self.n_pids, self.churn, replace=False))
        self.retired = [int(self.pid_of_slot[p]) for p in gone]
        new = np.arange(self.next_pid, self.next_pid + len(gone))
        self.next_pid += len(gone)
        self.pid_of_slot[gone] = new
        self.exe_base[gone] = self._exe_bases(rng, len(gone))
        for p in gone.tolist():
            self._add_maps(p)
        self._fill_stacks(rng, np.flatnonzero(np.isin(self.pid_slot, gone)))

    # -- windows ---------------------------------------------------------

    def prepare(self) -> None:
        """Draw the pool, or the first ``ahead_windows`` windows, now."""
        for k in range(self.pool):
            self.pooled(k)
        while self._drawn < self.ahead:
            win = self._draw_next()
            self._stored[win.index] = win

    def window(self, w: int) -> Window:
        """Window `w` (call in order from 0)."""
        if w != self._next:
            raise ValueError(f"window {w} asked for, {self._next} is next")
        self._next += 1
        if self.pool:
            return self.pooled(w)
        got = self._stored.pop(w, None)
        return got if got is not None else self._draw_next()

    def _draw_next(self) -> Window:
        w = self._drawn
        self._drawn += 1
        if self.churn and w > 0:
            self._apply_churn(w)
        return self._draw(w)

    def pooled(self, w: int) -> Window:
        """Window `w` of a pooled mix, drawn at set-up or now, without
        advancing the replay (the check reads the windows again)."""
        k = w % self.pool
        if k not in self._pool:
            self._pool[k] = self._draw(k)
        return dataclasses.replace(self._pool[k], index=w,
                                   time_ns=self._time_ns(w),
                                   check_pids=self._check_pids(w))

    def _time_ns(self, w: int) -> int:
        return TIME0_NS + w * int(self.cfg["window_s"]) * PERIOD_NS_PER_S

    def _draw(self, w: int) -> Window:
        cfg = self.cfg
        rng = _rng(self.seed, 1, w)
        n_samples = int(cfg["samples_per_window"])
        if self.every:
            counts = 1 + rng.multinomial(n_samples - self.n_stacks,
                                         self.pvals)
        else:
            counts = rng.multinomial(n_samples, self.pvals)
        n_drains = int(cfg["drains_per_window"])
        left = counts
        pids = self.pid_of_slot[self.pid_slot].astype(np.int32)
        drains = []
        for d in range(n_drains):
            if d == n_drains - 1:
                part = left
            else:
                part = rng.binomial(left, 1.0 / (n_drains - d))
                left = left - part
            idx = np.flatnonzero(part)
            p = pids[idx]
            drains.append((p, p.copy(), self.ulen[idx], self.klen[idx],
                           self.stacks[idx], part[idx].astype(np.int64)))
        columns = None
        if w == 0:
            # Copies only where later churn rewrites the population or
            # some stacks have no sample.
            if self.every:
                own = (lambda a: a.copy()) if self.churn else (lambda a: a)
            else:
                live = np.flatnonzero(counts)
                own = (lambda a: a[live])   # noqa: E731
                pids, counts = pids[live], counts[live]
            columns = (pids, pids.copy(), own(self.ulen), own(self.klen),
                       own(self.stacks), counts.astype(np.int64))
        return Window(index=w, drains=drains, total=int(counts.sum()),
                      rows=int(np.count_nonzero(counts)),
                      time_ns=self._time_ns(w),
                      check_pids=self._check_pids(w), columns=columns)

    def _check_pids(self, w: int) -> np.ndarray:
        """The pids whose pprof the output check decodes in window w:
        drawn from the seed, half of them among the pids born this window
        when there are any, and always the pid with the most stacks."""
        k = int(self.mix["check_pids_per_window"])
        rng = _rng(self.seed, 3, w)
        live = self.pid_of_slot
        born = live[live >= self.next_pid - self.churn] if (
            self.churn and w > 0) else live[:0]
        pick = [rng.choice(born, min(len(born), k // 2), replace=False)]
        pick.append(rng.choice(live, k - len(pick[0]), replace=False))
        widest = int(np.argmax(np.bincount(self.pid_slot,
                                           minlength=self.n_pids)))
        pick.append(live[widest:widest + 1])
        return np.unique(np.concatenate(pick)).astype(np.int64)
