"""Workload zoo scenarios: seeded, deterministic hostile-world generators.

The port's copy of parca_agent_tpu/bench_zoo/scenarios.py (numpy and
bytes only: nothing here touches torch or the card). Each scenario is
one axis of the breadth matrix — pid reuse under tenant migration, JIT
perf-map churn, fork/exec storms, deep native stacks, kernel-heavy
mixes, multi-tenant bursts. A scenario compiles, from a seed, to a list
of ``ZooWindow``s: per-window :class:`WindowSnapshot` inputs plus the
WORLD mutations (procfs files, starttimes) that must land before the
window is polled. The runner (bench_zoo/runner.py) drives those windows
through the port's window loop — ``AggregateLoop.run_iteration`` with a
live DictAggregator, Symbolizer, quarantine, admission and identity
tracker, or ``CPUProfiler.run_iteration`` on the fast arms — and scores
each scenario against its bars.

Determinism contract: everything a scenario emits derives from
``np.random.default_rng(seed)`` and fixed constants; the same (seed,
scale) always yields the same window stream — byte for byte the
original's — and the runner's digest of the shipped output is the
regression handle (tests/test_torch_zoo.py pins both).

Window *builds* are fail-open against the injected ``zoo.scenario``
fault: a window whose build raises degrades to an idle filler window —
the run narrows, it never dies (the chaos drill pins this, same
contract as every other ingest site).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from parca_agent_tpu_torch.capture.formats import (
    KERNEL_ADDR_START, MAX_STACK_DEPTH, STACK_SLOTS, WindowSnapshot)
from parca_agent_tpu_torch.process.maps import ProcMapping, build_mapping_table
from parca_agent_tpu_torch.utils import faults

# Fixed epoch for window timestamps: wall-clock must never leak into a
# seeded run (byte-identity bars compare shipped pprof blobs).
T0_NS = 1_750_000_000_000_000_000
WINDOW_NS = 10_000_000_000


@dataclasses.dataclass
class ZooWindow:
    """One window of scenario input: the snapshot the source hands the
    profiler, plus the world state that must exist when it does."""

    snapshot: WindowSnapshot
    files: dict[str, bytes] = dataclasses.field(default_factory=dict)
    starttimes: dict[int, int] = dataclasses.field(default_factory=dict)
    degraded: bool = False   # build failed open to an idle filler


def _mapping(start: int, end: int, path: str,
             offset: int = 0) -> ProcMapping:
    return ProcMapping(start=start, end=end, perms="r-xp", offset=offset,
                       dev="08:01", inode=1, path=path)


def make_snapshot(rows, per_pid_maps, time_ns: int) -> WindowSnapshot:
    """rows: [(pid, tid, count, user_addrs, kernel_addrs)] ->
    WindowSnapshot, with the mapping table folded from per_pid_maps
    exactly the way the live capture path folds /proc/<pid>/maps."""
    n = len(rows)
    pids = np.zeros(n, np.int32)
    tids = np.zeros(n, np.int32)
    counts = np.zeros(n, np.int64)
    ulen = np.zeros(n, np.int32)
    klen = np.zeros(n, np.int32)
    stacks = np.zeros((n, STACK_SLOTS), np.uint64)
    for i, (pid, tid, count, user, kernel) in enumerate(rows):
        pids[i], tids[i], counts[i] = pid, tid, count
        ulen[i], klen[i] = len(user), len(kernel)
        frames = list(user) + list(kernel)
        stacks[i, :len(frames)] = np.asarray(frames, np.uint64)
    table = build_mapping_table(per_pid_maps)
    return WindowSnapshot(pids, tids, counts, ulen, klen, stacks, table,
                          time_ns=time_ns)


def _cgroup_pod(uid: str) -> bytes:
    return f"0::/kubepods/burstable/pod{uid}/zoo\n".encode()


def _cgroup_svc(unit: str) -> bytes:
    return f"0::/system.slice/{unit}.service\n".encode()


def _status(pid: int) -> bytes:
    return f"Name:\tzoo\nNSpid:\t{pid}\n".encode()


class Scenario:
    """One matrix row. Subclasses define the axis, the per-window world,
    and the bars; ``build`` owns the shared fail-open/seeding frame."""

    name = ""
    axis = ""
    description = ""

    def __init__(self):
        self.truth: dict = {}

    # -- knobs the runner wires into the real components ---------------------
    def windows(self, scale: float) -> int:
        return 8

    def config(self, scale: float) -> dict:
        return {}

    # -- window stream -------------------------------------------------------
    def build(self, seed: int, scale: float) -> list[ZooWindow]:
        rng = np.random.default_rng(int(seed))
        self.truth = {}
        self._prepare(rng, scale)
        out: list[ZooWindow] = []
        for w in range(self.windows(scale)):
            try:
                faults.inject("zoo.scenario")
                out.append(self._window(w, rng, scale))
            except Exception:  # noqa: BLE001 - counted, fail-open
                # A failed window build (injected fault or scenario bug)
                # degrades to an idle filler: the matrix row narrows, the
                # run and every later window survive.
                out.append(self._idle(w))
        self.truth["degraded_builds"] = sum(zw.degraded for zw in out)
        return out

    def _idle(self, w: int) -> ZooWindow:
        maps = {1: [_mapping(0x400000, 0x500000, "/app/idle")]}
        snap = make_snapshot([(1, 1, 1, [0x400010], [])], maps,
                             T0_NS + w * WINDOW_NS)
        return ZooWindow(snap, starttimes={1: 1}, degraded=True)

    def _prepare(self, rng, scale: float) -> None:
        raise NotImplementedError

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        raise NotImplementedError

    # -- scoring -------------------------------------------------------------
    def check(self, outcome: dict, ctx) -> dict:
        """Scenario-specific bars: {bar_name: bool}. May annotate
        ``outcome`` with measured evidence (the runner keeps it)."""
        return {}


def _paths_by_mapping(prof) -> dict[int, str]:
    return {m.id: m.path for m in prof.mappings}


def _stack_mass_by_path(prof) -> dict[str, int]:
    """Window mass per mapping path, attributing each deduped stack by
    its leaf frame's mapping (the frame a flamegraph pins the sample to)."""
    out: dict[str, int] = {}
    paths = _paths_by_mapping(prof)
    for s in range(prof.n_samples):
        depth = int(prof.stack_depths[s])
        if depth <= 0:
            continue
        leaf_loc = int(prof.stack_loc_ids[s, 0])  # leaf-first frame order
        mid = int(prof.loc_mapping_id[leaf_loc - 1])
        path = paths.get(mid, "")
        out[path] = out.get(path, 0) + int(prof.values[s])
    return out


class PidReuseScenario(Scenario):
    """Pid reuse under tenant migration: tenant A's pods exit, the kernel
    recycles their pids for tenant B's pods, and the NEW binary occupies
    the SAME virtual addresses. Every bare-pid cache in the agent now
    holds a dead process's state; without generation stamping the
    aggregator's per-pid registry attributes tenant B's samples to
    tenant A's binary (the cross-process attribution the stamp hardens
    away — ``PARCA_NO_PID_GENERATION=1`` pins the old behaviour for the
    control arm)."""

    name = "pid_reuse"
    axis = "identity"
    description = ("pid recycling across tenant migration; bars: reuse "
                   "detected, zero cross-process sample attribution")

    OLD_PATH = "/app/alpha"
    NEW_PATH = "/app/beta"
    REUSE_W = 3

    def config(self, scale: float) -> dict:
        return {"admission": {"quota_samples": 0}}

    def _prepare(self, rng, scale: float) -> None:
        n = max(2, round(6 * scale))
        self._reused = [1200 + i for i in range(n)]
        self._bystanders = [1900, 1901]
        # Gen A's stack shapes, reused VERBATIM by gen B: identical
        # addresses are what make the stale registry hit silent.
        self._addrs = {
            pid: [0x400000 + np.sort(rng.integers(
                0, 0x200000 // 16, size=int(d))).astype(np.uint64) * 16
                for d in rng.integers(4, 9, size=3)]
            for pid in self._reused}
        self._by_addrs = {
            pid: [0x700000 + np.arange(5, dtype=np.uint64) * 64]
            for pid in self._bystanders}
        self.truth.update({
            "reused_pids": list(self._reused),
            "reuse_window": self.REUSE_W,
            "old_path": self.OLD_PATH,
            "new_path": self.NEW_PATH,
        })

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        files: dict[str, bytes] = {}
        starttimes: dict[int, int] = {}
        span = (0x400000, 0x600000)
        if w == 0:
            for pid in self._reused:
                files[f"/proc/{pid}/cgroup"] = _cgroup_pod("aaaaaaaa-1111")
                starttimes[pid] = 1000 + pid
            for pid in self._bystanders:
                files[f"/proc/{pid}/cgroup"] = _cgroup_svc("zoo-bystander")
                starttimes[pid] = 1000 + pid
        if w == self.REUSE_W:
            # The migration instant: same pids, new starttime, new
            # binary at the same addresses, new tenant cgroup.
            for pid in self._reused:
                files[f"/proc/{pid}/cgroup"] = _cgroup_pod("bbbbbbbb-2222")
                starttimes[pid] = 500000 + pid
        path = self.OLD_PATH if w < self.REUSE_W else self.NEW_PATH
        maps = {pid: [_mapping(span[0], span[1], path)]
                for pid in self._reused}
        maps.update({pid: [_mapping(0x700000, 0x800000, "/app/bystander")]
                     for pid in self._bystanders})
        rows = []
        for pid in self._reused:
            for addrs in self._addrs[pid]:
                rows.append((pid, pid, int(rng.integers(40, 120)),
                             addrs, []))
        for pid in self._bystanders:
            rows.append((pid, pid, int(rng.integers(40, 120)),
                         self._by_addrs[pid][0], []))
        return ZooWindow(make_snapshot(rows, maps, T0_NS + w * WINDOW_NS),
                         files=files, starttimes=starttimes)

    def check(self, outcome: dict, ctx) -> dict:
        mis = 0
        new_mass = 0
        reused = set(self.truth["reused_pids"])
        for w, profs in enumerate(ctx.profiles_by_window):
            if w < self.REUSE_W:
                continue
            for p in profs:
                if p.pid not in reused:
                    continue
                by_path = _stack_mass_by_path(p)
                mis += by_path.get(self.OLD_PATH, 0)
                new_mass += by_path.get(self.NEW_PATH, 0)
        outcome["misattributed_mass"] = mis
        outcome["post_reuse_mass_new_binary"] = new_mass
        detected = outcome["identity"].get("reuse_detected_total", 0)
        if outcome["hardened"]:
            return {
                "reuse_detected": detected >= len(reused),
                "zero_cross_process_attribution": mis == 0
                    and new_mass > 0,
            }
        # Control arm: the un-stamped agent MUST reproduce the bug, or
        # the hardened arm's zero proves nothing.
        return {
            "misattribution_reproduced": mis > 0,
            "reuse_undetected": detected == 0,
        }


class JitChurnScenario(Scenario):
    """JIT perf-map churn: healthy JITs append and settle; a runaway (or
    adversarial) runtime rewrites its map with new content on every
    read. Bars: legit updates re-parse and resolve, the abuser trips the
    churn budget and lands in quarantine, and neither costs a window."""

    name = "jit_churn"
    axis = "jit"
    description = ("perf-map reparse on change + churn-abuse budget; "
                   "bars: jit names resolve, abuser quarantined")

    ABUSER = 3999
    UPDATE_W = 4

    def config(self, scale: float) -> dict:
        return {"churn_budget": 3,
                "quarantine": {"max_strikes": 1, "quarantine_windows": 3}}

    def _prepare(self, rng, scale: float) -> None:
        self._stable = [3100 + i for i in range(max(2, round(3 * scale)))]
        self._jit_addrs = {
            pid: (0x7F00_0000_0000 + np.uint64(pid) * np.uint64(0x10000)
                  + np.arange(8, dtype=np.uint64) * np.uint64(0x40))
            for pid in self._stable + [self.ABUSER]}
        self.truth.update({"stable_pids": list(self._stable),
                           "abuser": self.ABUSER,
                           "hot_pid": self._stable[0]})

    def _perf_map(self, pid: int, version: int, extra: bool) -> bytes:
        tag = f"v{version}_" if version else ""
        lines = [f"{int(a):x} 40 jit_{tag}{pid}_fn{k}"
                 for k, a in enumerate(self._jit_addrs[pid])]
        if extra:
            hot = int(self._jit_addrs[pid][-1]) + 0x40
            lines.append(f"{hot:x} 40 jit_{pid}_hot")
        return ("\n".join(lines) + "\n").encode()

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        files: dict[str, bytes] = {}
        starttimes: dict[int, int] = {}
        all_pids = self._stable + [self.ABUSER]
        if w == 0:
            for pid in all_pids:
                files[f"/proc/{pid}/status"] = _status(pid)
                files[f"/proc/{pid}/cgroup"] = _cgroup_svc("zoo-jit")
                starttimes[pid] = 2000 + pid
            for pid in self._stable:
                files[f"/proc/{pid}/root/tmp/perf-{pid}.map"] = \
                    self._perf_map(pid, 0, extra=False)
        hot = self.truth["hot_pid"]
        if w == self.UPDATE_W:
            # The one LEGIT mid-run update: the JIT compiled a new hot
            # function and appended it — must re-parse and resolve.
            files[f"/proc/{hot}/root/tmp/perf-{hot}.map"] = \
                self._perf_map(hot, 0, extra=True)
        # The abuser rewrites with fresh content every single window.
        files[f"/proc/{self.ABUSER}/root/tmp/perf-{self.ABUSER}.map"] = \
            self._perf_map(self.ABUSER, w + 1, extra=False)
        maps = {pid: [_mapping(0x400000, 0x500000, "/app/jithost")]
                for pid in all_pids}
        rows = []
        for pid in all_pids:
            jit = self._jit_addrs[pid]
            picks = rng.integers(0, len(jit), size=2)
            for j in picks:
                rows.append((pid, pid, int(rng.integers(30, 90)),
                             [jit[int(j)], np.uint64(0x400040)], []))
        if w >= self.UPDATE_W:
            hot_addr = np.uint64(int(self._jit_addrs[hot][-1]) + 0x40)
            rows.append((hot, hot, int(rng.integers(30, 90)),
                         [hot_addr, np.uint64(0x400040)], []))
        return ZooWindow(make_snapshot(rows, maps, T0_NS + w * WINDOW_NS),
                         files=files, starttimes=starttimes)

    def check(self, outcome: dict, ctx) -> dict:
        names: set[str] = set()
        for profs in ctx.profiles_by_window:
            for p in profs:
                names.update(f[0] for f in p.functions)
        hot = self.truth["hot_pid"]
        pm = outcome["perfmap"]
        return {
            "jit_names_resolved": any(
                n.startswith(f"jit_{pid}_fn")
                for pid in self.truth["stable_pids"] for n in names),
            "legit_update_resolved": f"jit_{hot}_hot" in names,
            "reparse_counted": pm.get("reparse_total", 0) >= 1,
            "churn_budget_tripped": pm.get("churn_trips_total", 0) >= 1,
            "abuser_contained":
                outcome["quarantine"].get("trips_total", 0) >= 1,
        }


class ForkStormScenario(Scenario):
    """Fork/exec storm + container churn: one window introduces a burst
    of never-seen pids (a CI fan-out, a crash-looping deployment) whose
    discovery cost — maps parses, registry inserts, tenant resolution on
    dead-by-read cgroups — lands before any quota sees a sample. The
    admission controller's storm detector must shed via the existing
    governor ladder; the windows themselves must all ship."""

    name = "fork_storm"
    axis = "churn"
    description = ("new-pid burst sheds via admission ladder; bars: "
                   "storm detected, shed fired, no window lost")

    STORM_W = 2

    def windows(self, scale: float) -> int:
        return 6

    def config(self, scale: float) -> dict:
        return {"admission": {"quota_samples": 0, "storm_new_pids": 24}}

    def _prepare(self, rng, scale: float) -> None:
        self._base = [4100 + i for i in range(8)]
        self._storm = [5000 + i for i in range(max(40, round(160 * scale)))]
        self.truth.update({"storm_window": self.STORM_W,
                           "storm_size": len(self._storm)})

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        files: dict[str, bytes] = {}
        starttimes: dict[int, int] = {}
        if w == 0:
            for pid in self._base:
                files[f"/proc/{pid}/cgroup"] = _cgroup_svc("zoo-base")
                starttimes[pid] = 3000 + pid
        maps = {pid: [_mapping(0x400000, 0x500000, "/app/base")]
                for pid in self._base}
        rows = [(pid, pid, int(rng.integers(50, 150)),
                 0x400000 + np.arange(4, dtype=np.uint64) * 256, [])
                for pid in self._base]
        if w == self.STORM_W:
            for pid in self._storm:
                # Storm pids have no cgroup file — exec'd and gone before
                # the resolver reads; they join the unknown tenant.
                starttimes[pid] = 3500 + pid
                maps[pid] = [_mapping(0x400000, 0x480000, "/app/storm")]
                rows.append((pid, pid, int(rng.integers(1, 4)),
                             [np.uint64(0x400100 + 16 * (pid % 64))], []))
        return ZooWindow(make_snapshot(rows, maps, T0_NS + w * WINDOW_NS),
                         files=files, starttimes=starttimes)

    def check(self, outcome: dict, ctx) -> dict:
        adm = outcome["admission"]
        return {
            "storm_detected": adm.get("fork_storm_windows_total", 0) >= 1,
            "storm_shed_fired": adm.get("fork_storm_sheds_total", 0) >= 1,
            "shed_step_taken": adm.get("shed_steps_total", 0) >= 1,
        }


class DeepStacksScenario(Scenario):
    """Deep native/DWARF stacks at the 127-frame capture cap, with every
    window byte-for-byte identical input. Bars: full depth survives to
    the shipped profile, and identical input windows ship identical
    pprof bytes (the registry reuse across windows must be invisible)."""

    name = "deep_stacks"
    axis = "depth"
    description = ("MAX_STACK_DEPTH stacks, identical windows; bars: "
                   "full depth shipped, pprof byte identity")

    def windows(self, scale: float) -> int:
        return 6

    def _prepare(self, rng, scale: float) -> None:
        self._pids = [6100 + i for i in range(4)]
        self._deep = {
            pid: 0x400000 + (np.uint64(pid - 6100) * np.uint64(0x100000)
                 + np.arange(MAX_STACK_DEPTH, dtype=np.uint64)
                 * np.uint64(16))
            for pid in self._pids}
        self._counts = {pid: int(rng.integers(80, 200))
                        for pid in self._pids}
        self.truth["max_depth"] = MAX_STACK_DEPTH

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        starttimes = {pid: 4000 + pid for pid in self._pids} if w == 0 \
            else {}
        maps = {pid: [_mapping(0x400000, 0x1400000, "/app/deep")]
                for pid in self._pids}
        rows = [(pid, pid, self._counts[pid], self._deep[pid], [])
                for pid in self._pids]
        # time_ns is deliberately CONSTANT: the byte-identity bar
        # compares whole shipped pprof blobs across windows.
        return ZooWindow(make_snapshot(rows, maps, T0_NS),
                         starttimes=starttimes)

    def check(self, outcome: dict, ctx) -> dict:
        import hashlib

        max_depth = 0
        for profs in ctx.profiles_by_window:
            for p in profs:
                if p.n_samples:
                    max_depth = max(max_depth, int(p.stack_depths.max()))
        per_pid: dict[str, set[str]] = {}
        for _w, labels, blob in ctx.shipped:
            per_pid.setdefault(labels.get("pid", "?"), set()).add(
                hashlib.sha256(blob).hexdigest())
        outcome["max_depth_shipped"] = max_depth
        return {
            "full_depth_shipped": max_depth == MAX_STACK_DEPTH,
            "pprof_byte_identity": bool(per_pid)
                and all(len(v) == 1 for v in per_pid.values()),
            "every_window_shipped":
                len(ctx.shipped) == len(self._pids) * self.windows(1.0),
        }


class KernelHeavyScenario(Scenario):
    """Kernel-heavy mix: most of the window's mass carries kernel tails
    (soft-irq storms, syscall-bound services). Kernel frames must stay
    un-normalized, resolve through kallsyms, and conserve mass."""

    name = "kernel_heavy"
    axis = "kernel"
    description = ("kernel-tail-dominated windows; bars: kernel mass "
                   "exact, kallsyms names resolve")

    _SYMS = ["zoo_sys_read", "zoo_sys_write", "zoo_do_softirq",
             "zoo_tcp_rcv", "zoo_page_fault", "zoo_schedule"]

    def windows(self, scale: float) -> int:
        return 6

    def config(self, scale: float) -> dict:
        lines = [f"{int(KERNEL_ADDR_START) + (k + 1) * 0x1000:x} T {n}"
                 for k, n in enumerate(self._SYMS)]
        return {"kallsyms": ("\n".join(lines) + "\n").encode()}

    def _prepare(self, rng, scale: float) -> None:
        self._pids = [7100 + i for i in range(6)]
        self.truth["kernel_mass"] = 0

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        starttimes = {pid: 5000 + pid for pid in self._pids} if w == 0 \
            else {}
        maps = {pid: [_mapping(0x400000, 0x500000, "/app/kern")]
                for pid in self._pids}
        rows = []
        for pid in self._pids:
            user = 0x400000 + np.arange(3, dtype=np.uint64) * 128
            for s in range(3):
                count = int(rng.integers(40, 100))
                if s < 2:  # two of three stacks carry a kernel tail
                    k = int(rng.integers(0, len(self._SYMS)))
                    kern = [np.uint64(int(KERNEL_ADDR_START)
                                      + (k + 1) * 0x1000 + 8)]
                    self.truth["kernel_mass"] += count
                else:
                    kern = []
                rows.append((pid, pid + s, count, user, kern))
        return ZooWindow(make_snapshot(rows, maps, T0_NS + w * WINDOW_NS),
                         starttimes=starttimes)

    def check(self, outcome: dict, ctx) -> dict:
        kernel_mass = 0
        names: set[str] = set()
        for profs in ctx.profiles_by_window:
            for p in profs:
                names.update(f[0] for f in p.functions)
                kern_locs = set(
                    (np.flatnonzero(p.loc_is_kernel) + 1).tolist())
                for s in range(p.n_samples):
                    d = int(p.stack_depths[s])
                    ids = set(p.stack_loc_ids[s, :d].tolist())
                    if ids & kern_locs:
                        kernel_mass += int(p.values[s])
        outcome["kernel_mass_shipped"] = kernel_mass
        return {
            "kernel_mass_exact":
                kernel_mass == self.truth["kernel_mass"],
            "kallsyms_resolved": any(n.startswith("zoo_") for n in names),
        }


class TenantBurstScenario(Scenario):
    """Multi-tenant burst: one tenant sustains 4x its sample quota while
    two stay in budget. The ladder must degrade ONLY the burster — and
    degrade fidelity, never samples (mass conservation is a base bar)."""

    name = "tenant_burst"
    axis = "tenancy"
    description = ("one tenant 4x over quota; bars: burster degraded, "
                   "neighbors untouched, zero sample loss")

    BURST_W = 2

    def config(self, scale: float) -> dict:
        return {"admission": {"quota_samples": 3000, "burst_windows": 1,
                              "degrade_after": 2, "recover_windows": 6}}

    def _prepare(self, rng, scale: float) -> None:
        self._tenants = {
            "a": [9100 + i for i in range(3)],
            "b": [9200 + i for i in range(3)],
            "c": [9300 + i for i in range(3)],   # the burster
        }
        self.truth["burster"] = "c"

    def _window(self, w: int, rng, scale: float) -> ZooWindow:
        files: dict[str, bytes] = {}
        starttimes: dict[int, int] = {}
        if w == 0:
            uids = {"a": "aaaa0000-0001", "b": "bbbb0000-0002",
                    "c": "cccc0000-0003"}
            for t, pids in self._tenants.items():
                for pid in pids:
                    files[f"/proc/{pid}/cgroup"] = _cgroup_pod(uids[t])
                    starttimes[pid] = 6000 + pid
        maps = {pid: [_mapping(0x400000, 0x500000, f"/app/tenant_{t}")]
                for t, pids in self._tenants.items() for pid in pids}
        rows = []
        for t, pids in self._tenants.items():
            burst = t == "c" and w >= self.BURST_W
            per_pid = 4000 if burst else 300
            for pid in pids:
                rows.append((pid, pid,
                             per_pid + int(rng.integers(0, 50)),
                             0x400000 + np.arange(5, dtype=np.uint64) * 64,
                             []))
        return ZooWindow(make_snapshot(rows, maps, T0_NS + w * WINDOW_NS),
                         files=files, starttimes=starttimes)

    def check(self, outcome: dict, ctx) -> dict:
        lvl = {t: max(ctx.admission.level_for(pid) for pid in pids)
               for t, pids in self._tenants.items()}
        outcome["tenant_levels"] = lvl
        return {
            "burster_degraded": lvl["c"] > 0,
            "neighbors_untouched": lvl["a"] == 0 and lvl["b"] == 0,
            "degradation_charged":
                outcome["admission"].get("samples_degraded_total", 0) > 0,
        }


SCENARIOS: dict[str, Callable[[], Scenario]] = {
    cls.name: cls for cls in (
        PidReuseScenario, JitChurnScenario, ForkStormScenario,
        DeepStacksScenario, KernelHeavyScenario, TenantBurstScenario)
}


def build_schedule(seed: int, names=None) -> list[dict]:
    """Deterministic run order + per-scenario seeds for one zoo sweep.
    Same seed -> same schedule, independent of dict iteration order."""
    names = sorted(names if names is not None else SCENARIOS)
    rng = np.random.default_rng(int(seed))
    order = [names[int(i)] for i in rng.permutation(len(names))]
    return [{"scenario": n, "seed": int(rng.integers(1, 2**31))}
            for n in order]
