"""Multi-process fleet wiring: one agent process per node, real collectives.

The port's counterpart of parca_agent_tpu/parallel/distributed.py. The
one-process fleet path (parallel/fleet.py) holds the cluster as rows of
one [n_nodes, R] stream. A real deployment runs one agent PROCESS per
machine (the reference's DaemonSet pod), and the cross-node reduction
rides the interconnect: fleet_initialize forms a torch.distributed group
(rank 0 is the coordinator; NCCL on the card, gloo when the caller asks
for the CPU), after which every process calls the merges here with its
LOCAL window stream and gets the fleet-wide result back.

Each process is exactly ONE node (local_fleet_mesh: its own device), as
the JAX package puts one device of each process on the mesh: the fleet
axis is "one agent daemon = one node", not "one card = one node". The
sketch merge builds the local stream's sketches (the sketch build
kernel), then all_reduce SUM over the int32 count-min table and MAX over
the int32 registers; the exact merge all-gathers every node's rows, then
runs the one-process path's sort and segment kernel on the gathered
stream, identically on every node.

With no group formed the world is one node, as jax.process_count() is 1
uninitialized: the merges then run on the caller's device with no
collective. That is the JAX package's semantics, not a fallback: the
device is never swapped for the CPU.

The chaos sites of the JAX package (faults.inject("fleet.join") and
("fleet.collective")) are not here: the port has no fault injector yet.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from parca_agent_tpu_torch.ops.sketch import sketch_build
from parca_agent_tpu_torch.parallel.fleet import (
    FleetMergeSpec,
    _check_streams,
    _to_device,
    keys64,
    merge_rows,
)
from parca_agent_tpu_torch.parallel.mesh import FleetMesh
from parca_agent_tpu_torch.utils.bounded import bounded_call
from parca_agent_tpu_torch.utils.device import resolve_device
from parca_agent_tpu_torch.utils.log import get_logger

log = get_logger("fleet")

# The device of this process's fleet position, once fleet_initialize has
# formed the group.
_FLEET_DEVICE: torch.device | None = None


class FleetJoinError(RuntimeError):
    """Bounded fleet join failed: the coordinator refused, or the join
    did not complete within its deadline and was abandoned. The agent
    can (and should) continue single-node."""


class CollectiveTimeout(RuntimeError):
    """A fleet collective exceeded its deadline and was abandoned (a
    lost/hung peer leaves every other node blocked inside the collective;
    the merge bounds it itself)."""


def fleet_initialize(coordinator_address: str, num_nodes: int,
                     node_id: int, timeout_s: float | None = None,
                     device: str | torch.device = "cuda") -> None:
    """Join the fleet process group (torch.distributed, init_method
    tcp://<coordinator_address>, world size num_nodes, rank node_id).
    Call once, before any device work.

    The backend is NCCL on the card (the device is made current on the
    calling thread before the group forms, also when the join runs on
    the abandonable thread below) and gloo only when the caller asks for
    the CPU; asking for cuda with no card raises (utils/device.py). A group
    that is already formed is kept.

    With ``timeout_s`` the join runs on an abandonable daemon thread: a
    dead coordinator would otherwise block here forever; past the
    deadline, or when the join raises, a :class:`FleetJoinError` is
    raised so the caller can degrade to single-node mode. The abandoned
    thread may still complete the join in the background — callers that
    degraded must not assume the process group stays uninitialized."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not dist.is_initialized():
        torch.cuda.set_device(dev)  # per thread: this one, not the joiner

    def join():
        global _FLEET_DEVICE

        if dist.is_initialized():
            return
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_nodes, rank=node_id)
        _FLEET_DEVICE = dev
        log.info("fleet initialized", nodes=dist.get_world_size(),
                 node_id=node_id, backend=backend, device=str(dev))

    if timeout_s is None:
        return join()
    status, out, _, _ = bounded_call(join, timeout_s,
                                     thread_name="fleet-join")
    if status == "hang":
        raise FleetJoinError(
            f"fleet join did not complete within {timeout_s:.0f}s "
            f"(coordinator {coordinator_address}); abandoned")
    if status == "err":
        raise FleetJoinError(f"fleet join failed: {out!r}") from out


def _grouped() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def local_fleet_mesh(device: str | torch.device = "cuda") -> FleetMesh:
    """The node axis with ONE position per process (each is one agent
    daemon), on this process's device: the group's (the device given to
    fleet_initialize; for a group formed elsewhere, the current card
    under NCCL, the CPU under gloo). With no group formed, one node on
    `device`."""
    import torch.distributed as dist

    if not _grouped():
        return FleetMesh(resolve_device(device), 1)
    dev = _FLEET_DEVICE
    if dev is None:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
    return FleetMesh(dev, dist.get_world_size())


def _all_gather(t: torch.Tensor, mesh: FleetMesh) -> torch.Tensor:
    """Every node's 1-D `t` (same length everywhere), node-major."""
    import torch.distributed as dist

    if not _grouped():
        return t
    out = torch.empty(mesh.n_nodes * t.numel(), dtype=t.dtype,
                      device=t.device)
    # all_gather_into_tensor, under the name newer torch gives it.
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t.contiguous())
    return out


def _all_gather_i64(values, mesh: FleetMesh) -> np.ndarray:
    """One int64 (or a few) of every node, node-major, on the host."""
    t = torch.from_numpy(np.asarray(values, np.int64).reshape(-1).copy())
    return _all_gather(t.to(mesh.device), mesh).cpu().numpy()


def _check_fleet_total(local_counts: np.ndarray, mesh: FleetMesh) -> None:
    """SPMD analog of _check_streams' fleet-wide int32 bound: every node
    contributes its local int64 mass, all nodes see the global sum, and
    all raise together if the device lanes would wrap."""
    fleet = _all_gather_i64([local_counts.astype(np.int64).sum()], mesh)
    if int(fleet.sum()) >= 2**31:
        raise ValueError(
            "fleet-wide sample total exceeds int32; merge hierarchically")


def fleet_merge_sketches_dist(local_hashes, local_counts,
                              spec=FleetMergeSpec(), mesh=None):
    """Cluster-wide sketch merge from each node's LOCAL stream.

    Every process calls this collectively with its own [R] hashes/counts
    (R must match across nodes — pad with count-0 rows). Returns
    (cm_table, hll_regs, total) identically on every node."""
    local_hashes, local_counts = _check_streams(
        np.asarray(local_hashes)[None, :], np.asarray(local_counts)[None, :])
    if mesh is None:
        mesh = local_fleet_mesh()
    _check_fleet_total(local_counts, mesh)
    dev = mesh.device
    cm, regs, totals = sketch_build(
        _to_device(local_hashes, dev), _to_device(local_counts, dev),
        spec.cm, spec.hll, live="counts")
    if _grouped():
        import torch.distributed as dist

        dist.all_reduce(cm, op=dist.ReduceOp.SUM)
        dist.all_reduce(regs, op=dist.ReduceOp.MAX)
    # One int32 total per node, gathered so every node reports the fleet
    # total, summed on the host in int64.
    total = int(_all_gather(totals, mesh).cpu().numpy().astype(
        np.int64).sum())
    return cm.cpu().numpy(), regs.cpu().numpy(), total


def fleet_merge_exact64_dist(local_h1, local_h2, local_counts, mesh=None):
    """Cluster-wide exact (hash64 -> count) merge from local streams.

    Returns (h1, h2, counts) of the deduplicated fleet rows, identical on
    every node (each runs the sort and segment pass on the gathered
    rows)."""
    local_h1 = np.ascontiguousarray(local_h1, np.uint32)
    local_h2 = np.ascontiguousarray(local_h2, np.uint32)
    if local_h2.shape != local_h1.shape:
        raise ValueError("local_h2 must be congruent with local_h1")
    _, local_counts = _check_streams(
        local_h1[None, :], np.asarray(local_counts)[None, :])
    if mesh is None:
        mesh = local_fleet_mesh()
    _check_fleet_total(local_counts, mesh)
    dev = mesh.device
    h1, h2, counts = (_all_gather(_to_device(a.reshape(-1), dev), mesh)
                      for a in (local_h1, local_h2, local_counts))
    return merge_rows(keys64(h1, h2), counts, two_lanes=True)


def _agree_width(n_local: int, mesh: FleetMesh) -> int:
    """All nodes agree on the padded stream width for this round: the
    fleet max, at least 64, rounded up to a power of two so the rounds
    see a small set of shapes."""
    widths = _all_gather_i64([n_local], mesh)
    w = max(64, int(widths.max()))
    return 1 << (w - 1).bit_length()


class FleetWindowMerger:
    """The agent's runtime fleet actor: every `interval_s`, ALL nodes
    rendezvous in one collective round and merge their most recent
    window's compacted (h1, h2, count) stream into fleet-wide results.

    SPMD discipline: collectives are a fixed program order all processes
    must enter together, so a round NEVER skips — a node with no fresh
    window contributes a zero-count stream (the identity of every
    reduction used). A lost or hung PEER therefore leaves this node
    blocked inside the collective; with ``collective_timeout_s`` set,
    every round runs on an abandonable daemon thread and a blown deadline
    DEGRADES fleet mode instead of wedging the actor: node-local profiles
    keep shipping through the agent's own writer, the skipped merge
    rounds are COUNTED (``local_only_rounds``), and after
    ``rejoin_after_rounds`` rounds (doubling per failed attempt, capped)
    the merger re-probes with one tiny bounded collective and rejoins the
    schedule when it completes. Results land in `fleet_stats`:
    fleet_total_samples, fleet_unique_stacks, fleet_rounds. With no group
    formed the fleet is this one node, on `device`.
    """

    def __init__(self, interval_s: float = 10.0,
                 collective_timeout_s: float | None = None,
                 rejoin_after_rounds: int = 6,
                 max_rejoin_after_rounds: int = 96,
                 device: str | torch.device = "cuda"):
        import time as _time

        self._interval = interval_s
        self._collective_timeout = collective_timeout_s
        self._device = device
        self._lock = threading.Lock()
        self._window = None  # (hashes, counts) of the latest closed window
        self.fleet_stats: dict = {}
        self.failed: Exception | None = None
        self._clock = _time.monotonic
        # Degrade/rejoin state (collective timeout path).
        self.degraded = False
        self._rejoin_base = max(1, rejoin_after_rounds)
        self._rejoin_max = max(self._rejoin_base, max_rejoin_after_rounds)
        self._rejoin_backoff = self._rejoin_base
        self._rejoin_in = 0
        self._inflight = None  # Event of the abandoned collective
        self.stats = {
            "collective_timeouts": 0,
            "local_only_rounds": 0,
            "rejoins": 0,
            "rejoin_probes_failed": 0,
        }
        self.last_degrade_error: str = ""
        # Hotspot rollup rider (attach_hotspots): every successful merge
        # round's fleet-deduped stream feeds the store's fleet-scope
        # rollups; a degrade notifies it so queries flag node-local
        # answers stale. Strictly best-effort — rollup trouble must never
        # break the merge schedule.
        self._hotspots = None
        # Hang observability: a PEER's failure leaves this node blocked
        # inside the next collective with failed=None and frozen last-good
        # gauges. These two clocks make that state visible (round age
        # beyond ~2x the interval, or an in-flight round older than the
        # interval, means the fleet schedule has stalled; with no
        # collective timeout configured they are the ONLY signal).
        self.last_round_at: float | None = None
        self.round_started_at: float | None = None

    def attach_hotspots(self, store) -> None:
        """Feed a hotspot store's fleet scope from this merger's rounds
        (duck-typed: ``fleet_fold(h1, h2, counts)`` after each round,
        ``fleet_degraded(error)`` at a degrade). The store learns the
        merge cadence so it can judge staleness."""
        store.fleet_interval_s = self._interval
        self._hotspots = store

    def submit_window(self, hashes, counts) -> None:
        """Called after each window close. `hashes` is (h1, h2) row
        streams — duplicates fine, the merge segment-sums them — or a
        zero-arg callable returning them, so the hashing can run lazily
        on THIS actor's thread instead of the profiler's hot path."""
        with self._lock:
            self._window = (hashes, np.ascontiguousarray(counts, np.int32))

    def _bounded(self, thunk):
        """Run one collective under the abandonable bounded-call guard
        (utils/bounded.py): past the deadline the thread is abandoned —
        it may still be blocked inside the collective, so nothing
        re-enters the schedule until its event fires — and
        CollectiveTimeout raises to the caller."""
        if self._collective_timeout is None:
            return thunk()
        status, out, done, _ = bounded_call(
            thunk, self._collective_timeout,
            thread_name="fleet-collective")
        if status == "hang":
            self._inflight = done
            raise CollectiveTimeout(
                f"fleet collective exceeded {self._collective_timeout}s; "
                "abandoned")
        if status == "err":
            raise out
        return out

    def _inflight_clear(self) -> bool:
        return self._inflight is None or self._inflight.is_set()

    def _merge_collective(self, h1, h2, counts):
        """The full merge round's collectives (width agreement is itself
        a collective, so it rides the bounded thunk too)."""
        mesh = local_fleet_mesh(self._device)
        width = _agree_width(len(h1), mesh)
        ph1 = np.zeros(width, np.uint32)
        ph2 = np.zeros(width, np.uint32)
        pc = np.zeros(width, np.int32)
        ph1[: len(h1)] = h1
        ph2[: len(h2)] = h2
        pc[: len(counts)] = counts
        # ONE exact merge per round: it already yields the fleet total
        # (sum of merged counts) and the unique count; the sketch merge
        # would add a second cross-node collective for no extra
        # information (sketches remain the offline/bounded artifact,
        # parallel/fleet.py).
        return fleet_merge_exact64_dist(ph1, ph2, pc, mesh)

    def _probe_collective(self) -> None:
        """Rejoin probe: one tiny all_gather under the same bound, with an
        EPOCH-agreement check. The degrade state machine is itself
        lockstep-SPMD — a hung peer stalls the SAME round on every
        surviving node, so all degrade together and count rounds on the
        same interval cadence — and every node gathers its round epoch
        here: equal epochs across the gather is the mechanical evidence
        that this all_gather paired with the PEERS' probes, not with some
        differently-paced node's mid-merge collective (an unmatched
        pairing would permanently offset the program order). Any
        disagreement = the schedule is not re-aligned: stay degraded and
        back off. A peer that died outright never answers — the bound
        expires and the merger stays node-local (recovery from process
        loss requires restarting the fleet)."""
        epoch = (self.stats["local_only_rounds"]
                 + self.fleet_stats.get("fleet_rounds", 0))
        out = _all_gather_i64([epoch], local_fleet_mesh(self._device))
        if out.size == 0 or not (out == out[0]).all():
            raise RuntimeError(
                f"rejoin probe epoch mismatch {out.tolist()}: the fleet "
                "schedule is not re-aligned")

    def merge_round(self) -> None:
        if self.degraded:
            self._degraded_round()
            return
        self.round_started_at = self._clock()
        with self._lock:
            win, self._window = self._window, None
        if win is None:
            h1 = h2 = np.zeros(0, np.uint32)
            counts = np.zeros(0, np.int32)
        else:
            hashes, counts = win
            h1, h2 = hashes() if callable(hashes) else hashes
            h1 = np.ascontiguousarray(h1, np.uint32)
            h2 = np.ascontiguousarray(h2, np.uint32)
        try:
            u1, u2, uc = self._bounded(
                lambda: self._merge_collective(h1, h2, counts))
        except Exception as e:  # noqa: BLE001 - degrade, never wedge
            self._degrade(e)
            return
        if self._hotspots is not None:
            try:
                self._hotspots.fleet_fold(u1, u2, uc)
            except Exception as e:  # noqa: BLE001 - rollup is best-effort
                log.warn("fleet hotspot rollup failed; round counted, "
                         "rollup skipped", error=repr(e))
        self.fleet_stats = {
            "fleet_total_samples": int(uc.astype(np.int64).sum()),
            "fleet_unique_stacks": int(len(u1)),
            "fleet_rounds": self.fleet_stats.get("fleet_rounds", 0) + 1,
        }
        self.last_round_at = self._clock()
        self.round_started_at = None

    def _degrade(self, e: Exception) -> None:
        self.degraded = True
        if isinstance(e, CollectiveTimeout):
            self.stats["collective_timeouts"] += 1
        self.last_degrade_error = repr(e)[:200]
        if self._hotspots is not None:
            try:
                self._hotspots.fleet_degraded(self.last_degrade_error)
            except Exception:  # noqa: BLE001 - notification only
                pass
        self._rejoin_backoff = self._rejoin_base
        self._rejoin_in = self._rejoin_backoff
        self.round_started_at = None
        log.error("fleet collective hung/failed; degrading to node-local "
                  "profiles (each node's own writer keeps shipping; "
                  "merge rounds are counted, rejoin after re-probe)",
                  error=self.last_degrade_error,
                  rejoin_after_rounds=self._rejoin_in)

    def _degraded_round(self) -> None:
        """One round in degraded mode: the window's fleet contribution is
        skipped (counted — the profiles themselves already shipped via
        this node's writer), and on schedule a bounded re-probe attempts
        the rejoin."""
        with self._lock:
            self._window = None  # this round's contribution is forfeited
        self.stats["local_only_rounds"] += 1
        self._rejoin_in -= 1
        if self._rejoin_in > 0:
            return
        if not self._inflight_clear():
            # The abandoned collective is STILL blocked inside the
            # schedule; probing now would race it. Check again next round.
            self._rejoin_in = 1
            return
        try:
            self._bounded(self._probe_collective)
        except Exception as e:  # noqa: BLE001 - stay degraded, backoff
            self.stats["rejoin_probes_failed"] += 1
            self._rejoin_backoff = min(self._rejoin_backoff * 2,
                                       self._rejoin_max)
            self._rejoin_in = self._rejoin_backoff
            log.warn("fleet rejoin probe failed; staying node-local",
                     error=repr(e)[:200],
                     next_probe_rounds=self._rejoin_in)
            return
        self.degraded = False
        self._rejoin_backoff = self._rejoin_base
        self.stats["rejoins"] += 1
        self.last_round_at = self._clock()
        log.info("fleet rejoin probe ok; re-entering the merge schedule")

    # -- supervision hooks ----------------------------------------------------

    def heartbeat(self) -> bool:
        """Supervisor probe hook: False when the fleet schedule looks
        stalled — an in-flight round older than its bound (with a
        collective timeout configured a round cannot stall, so this only
        trips on the unbounded config) or fleet mode terminally failed.
        Fail-open: a probe that raises reads as unhealthy, never as a
        dead poll loop."""
        try:
            if self.failed is not None:
                return False
            started = self.round_started_at
            if started is None:
                return True
            bound = max(self._interval,
                        self._collective_timeout or 0.0) * 2 \
                + self._interval
            return self._clock() - started <= bound
        except Exception as e:  # noqa: BLE001 - probe contract
            log.warn("fleet heartbeat probe failed", error=repr(e)[:200])
            return False

    def request_rejoin(self) -> None:
        """Supervisor revive hook: pull the next rejoin probe forward to
        the next round. Fail-open: a revive that raises would read as a
        revive failure over bookkeeping."""
        try:
            if self.degraded:
                self._rejoin_in = min(self._rejoin_in, 1)
        except Exception as e:  # noqa: BLE001 - revive contract
            log.warn("rejoin request failed", error=repr(e)[:200])

    def run(self, stop) -> None:
        """Actor loop (threading.Event stop)."""
        while not stop.is_set():
            try:
                self.merge_round()
            except Exception as e:  # noqa: BLE001 - SPMD schedule broken
                # merge_round degrades on collective trouble; anything
                # escaping it is a bug in the degrade path itself.
                self.failed = e
                log.error("fleet merge failed; fleet mode disabled",
                          error=repr(e))
                return
            stop.wait(self._interval)
