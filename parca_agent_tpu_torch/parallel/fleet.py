"""Fleet merge: N nodes' window summaries -> one cluster-wide view.

The port's counterpart of parca_agent_tpu/parallel/fleet.py (BASELINE
config #5: "8-node fleet merge: per-node sketches psum'd into one
cluster-wide pprof"), equal to it bit for bit. There each path is one
shard_map program over the "node" mesh axis; here, in one process, the
node axis is the leading dimension of [n_nodes, R] tensors on one device
(parallel/mesh.py), and across processes it is the torch.distributed
group (parallel/distributed.py):

  fleet_merge_sketches — a count-min table and HLL registers of every
      node's stream, merged: the JAX program's psum of the per-node
      tables and pmax of their registers. Integer addition is
      associative (and _check_streams bounds every int32 sum) and max is
      idempotent, so one build over all nodes' rows at once gives the
      merged sketches bit for bit: one launch of the sketch build kernel
      (ops/sketch.py:sketch_build, csrc/sketch_build.cu), which also
      gives each node's total.

  fleet_merge_exact / fleet_merge_exact64 — every node's (hash, count)
      rows (JAX's all_gather is the node axis itself), one sort by the
      key (torch.sort, as JAX's lax.sort is XLA's own sort), then the
      segment pass (fleet_segment: csrc/fleet_merge.cu) that dedups
      identical stacks across nodes: each group's key and count sum, and
      the group count. Exact; the correctness oracle for the sketch path.

  fleet_merge_profiles — the config-#5 end state built on the exact path
      with 64-bit stack ids: merged per-id counts from the device,
      payload rows joined back on the host, ONE merged WindowSnapshot
      (union mapping table) and ONE cluster-wide set of per-pid profiles.

Row liveness is `count > 0`: padding (and a dead node's whole stream) is
zero counts, the identity of every reduction here. PAD_HASH is only the
conventional filler of padding rows' hashes; a real row whose hash
equals it still counts. Device counts ride int32 lanes, as the JAX
programs' do, so _check_streams enforces `sum(all counts) < 2^31` on the
host, in int64, and raises instead of letting a sum wrap.

The sort order is JAX's: uint32 keys, and (h1, h2) lexicographically as
unsigned. torch sorts neither as unsigned, so the 32-bit merge sorts the
widened key (int64) and the 64-bit merge (int32(h1 ^ 2^31) << 32) + h2,
whose signed order is that unsigned order (keys32, keys64).

Entry points run on the card unless the caller passes device="cpu" (or a
mesh on the CPU), where the kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parca_agent_tpu_torch.ops import kernels
from parca_agent_tpu_torch.ops.hashing import u32_bits, u32_wide
from parca_agent_tpu_torch.ops.sketch import (
    CountMinSpec,
    HLLSpec,
    sketch_build,
)
from parca_agent_tpu_torch.parallel.mesh import FleetMesh, fleet_mesh

# Conventional hash filler for padding rows (liveness is count > 0).
PAD_HASH = 0xFFFFFFFF

# Kernel launches: the wrapper adds one where it launches the segment
# kernel and nowhere else (the plain version counts nothing).
LAUNCHES = {"fleet_segment": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class FleetMergeSpec:
    cm: CountMinSpec = CountMinSpec()
    hll: HLLSpec = HLLSpec()


def _check_streams(node_hashes, node_counts):
    node_hashes = np.asarray(node_hashes, np.uint32)
    node_counts = np.asarray(node_counts, np.int32)
    if node_hashes.shape != node_counts.shape or node_hashes.ndim != 2:
        raise ValueError("node streams must be [n_nodes, R] and congruent")
    if np.any(node_counts < 0):
        raise ValueError("negative row count")
    # Bounds every on-device int32 sum (group sums, count-min cells, totals).
    if int(node_counts.astype(np.int64).sum()) >= 2**31:
        raise ValueError(
            "fleet-wide sample total exceeds int32; merge hierarchically"
        )
    return node_hashes, node_counts


def _mesh_for(n_nodes: int, mesh: FleetMesh | None, device) -> FleetMesh:
    if mesh is None:
        return fleet_mesh(n_nodes, device)
    if mesh.n_nodes != n_nodes:
        raise ValueError(f"the streams have {n_nodes} nodes, the mesh "
                         f"{mesh.n_nodes}")
    return mesh


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A u32 or int32 host array as an int32 tensor (u32 bits) on dev."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32)).to(dev)


# -- the segment pass (B8) ----------------------------------------------------


def keys32(h: torch.Tensor) -> torch.Tensor:
    """Sort keys of u32 hashes (int32 bits): int64 in [0, 2^32)."""
    return u32_wide(h.reshape(-1))


def keys64(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Sort keys of (h1, h2) u32 lanes (int32 bits): int64 whose signed
    order is the lanes' unsigned lexicographic order."""
    top = h1.reshape(-1) ^ torch.iinfo(torch.int32).min  # h1 - 2^31
    return top.to(torch.int64) * (1 << 32) + u32_wide(h2.reshape(-1))


def sort_rows(keys: torch.Tensor, counts: torch.Tensor):
    """The rows sorted by key: (keys, counts) in that order."""
    keys_s, order = torch.sort(keys)
    return keys_s, counts.reshape(-1)[order]


def _check_segment(keys: torch.Tensor, counts: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("keys must be int64 [n]")
    if counts.dtype != torch.int32 or counts.shape != keys.shape \
            or counts.device != keys.device:
        raise ValueError("counts must be int32, congruent with keys and on "
                         "their device")
    if keys.numel() == 0:
        raise ValueError("the segment pass needs at least one row")


def fleet_segment_plain(keys: torch.Tensor, counts: torch.Tensor,
                        two_lanes: bool):
    """fleet_segment's result by chains of torch ops (the kernel's plain
    version): reps and sums have n slots, [:n_groups] meaningful."""
    _check_segment(keys, counts)
    n = keys.numel()
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    group = torch.cumsum(first.to(torch.int64), 0) - 1
    sums = torch.zeros(n, dtype=torch.int64, device=keys.device)
    sums.scatter_add_(0, group, counts.to(torch.int64))
    reps = torch.zeros(n, dtype=torch.int64, device=keys.device)
    reps.scatter_reduce_(0, group, keys, "amax", include_self=False)
    hi = u32_bits(((reps >> 32) & 0xFFFFFFFF) ^ (1 << 31)) \
        if two_lanes else None
    return (hi, u32_bits(reps), u32_bits(sums),
            first.sum().to(torch.int32).reshape(1))


def fleet_segment(keys: torch.Tensor, counts: torch.Tensor,
                  two_lanes: bool):
    """The segment pass over rows sorted by key: (reps_hi int32 [n] or
    None, reps_lo int32 [n], sums int32 [n], n_groups int32 [1]), the reps u32 bits (reps_hi: h1 of keys64's keys,
    with two_lanes), the sums int32 sums that wrap. Only [:n_groups] of
    reps and sums is meaningful.

    CUDA tensors: one launch of csrc/fleet_merge.cu, which writes only
    [:n_groups]; a failed build or launch raises. CPU tensors run
    fleet_segment_plain."""
    _check_segment(keys, counts)
    dev = keys.device
    if dev.type == "cpu":
        return fleet_segment_plain(keys, counts, two_lanes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (keys.is_contiguous() and counts.is_contiguous()
            and keys.data_ptr() % 16 == 0 and counts.data_ptr() % 16 == 0):
        raise ValueError("the segment kernel takes contiguous, 16-byte "
                         "aligned keys and counts")
    n = keys.numel()
    lib = kernels.load("fleet_merge")
    stream = torch.cuda.current_stream(dev)
    scratch = kernels.epoch_scratch(
        "fleet_merge", dev, stream, lib.pa_fleet_segment_scratch_words(n),
        torch.int64)

    def empty(m):
        return torch.empty(m, dtype=torch.int32, device=dev)

    hi = empty(n) if two_lanes else None
    lo, sums, n_groups = empty(n), empty(n), empty(1)
    code = lib.pa_fleet_segment(
        keys.data_ptr(), counts.data_ptr(), n, scratch.data_ptr(),
        None if hi is None else hi.data_ptr(), lo.data_ptr(),
        sums.data_ptr(), n_groups.data_ptr(), stream.cuda_stream)
    kernels.check_launch(lib, code, "fleet_segment")
    LAUNCHES["fleet_segment"] += 1
    return hi, lo, sums, n_groups


def merge_rows(keys: torch.Tensor, counts: torch.Tensor, two_lanes: bool):
    """Sort, segment pass, fetch: the groups with a nonzero merged count,
    in key order, as numpy (reps_hi uint32 or None, reps_lo uint32, sums
    int32). The one-process and the distributed exact merges end here."""
    keys_s, counts_s = sort_rows(keys, counts)
    hi, lo, sums, n_groups = fleet_segment(keys_s, counts_s, two_lanes)
    k = int(n_groups.item())
    uc = sums[:k].cpu().numpy()
    # Padding-only groups merge to count 0; real rows always count >= 1.
    live = uc > 0
    ulo = lo[:k].cpu().numpy().view(np.uint32)[live]
    uhi = hi[:k].cpu().numpy().view(np.uint32)[live] if two_lanes else None
    return uhi, ulo, uc[live]


# -- the merges ---------------------------------------------------------------


def fleet_merge_sketches(node_hashes, node_counts, spec=FleetMergeSpec(),
                         mesh=None, device="cuda"):
    """Merge per-node streams into cluster-wide sketches.

    node_hashes uint32 [n_nodes, R], node_counts int32 [n_nodes, R];
    padding rows have count 0. Returns (cm_table [d, w], hll_regs [m],
    total_samples int)."""
    node_hashes, node_counts = _check_streams(node_hashes, node_counts)
    mesh = _mesh_for(node_hashes.shape[0], mesh, device)
    cm, regs, totals = sketch_build(
        _to_device(node_hashes, mesh.device),
        _to_device(node_counts, mesh.device), spec.cm, spec.hll,
        live="counts")
    # Per-node totals summed on the host in int64 (device lanes are int32;
    # _check_streams bounds the fleet total so no device sum can wrap).
    total = int(totals.cpu().numpy().astype(np.int64).sum())
    return cm.cpu().numpy(), regs.cpu().numpy(), total


def fleet_merge_exact64(node_h1, node_h2, node_counts, mesh=None,
                        device="cuda"):
    """Exact cross-node dedup on a 64-bit key carried as two uint32 lanes.

    Returns (h1 [U], h2 [U], counts [U]) for rows with nonzero merged
    count, in (h1, h2) order; (h1 << 32 | h2) is the stable cluster-wide
    stack id the host payload join keys on."""
    node_h1, node_counts = _check_streams(node_h1, node_counts)
    node_h2 = np.asarray(node_h2, np.uint32)
    if node_h2.shape != node_h1.shape:
        raise ValueError("node_h2 must be congruent with node_h1")
    mesh = _mesh_for(node_h1.shape[0], mesh, device)
    dev = mesh.device
    keys = keys64(_to_device(node_h1, dev), _to_device(node_h2, dev))
    return merge_rows(keys, _to_device(node_counts, dev), two_lanes=True)


def fleet_merge_exact(node_hashes, node_counts, mesh=None, device="cuda"):
    """Exact cross-node dedup: returns (unique_hashes [U], counts [U]) for
    rows with nonzero merged count, in hash order."""
    node_hashes, node_counts = _check_streams(node_hashes, node_counts)
    mesh = _mesh_for(node_hashes.shape[0], mesh, device)
    dev = mesh.device
    _, uh, uc = merge_rows(keys32(_to_device(node_hashes, dev)),
                           _to_device(node_counts, dev), two_lanes=False)
    return uh, uc


def fleet_merge_profiles(node_windows, mesh=None, aggregator=None,
                         assembly_nodes: int | None = None, device="cuda"):
    """BASELINE config #5 end state: N per-node WindowSnapshots -> ONE
    cluster-wide profile set.

    Device: each node contributes its compacted (h1, h2, count) stream
    and fleet_merge_exact64 gives the merged per-stack-id counts.

    Host: every merged 64-bit stack id is joined back to the (pid, tid,
    lens, frames) row held by whichever node produced it (first node
    wins), the rows are re-assembled into one WindowSnapshot whose
    mapping table is the union of the node tables, and per-pid profile
    assembly runs over pid partitions (pid % assembly_nodes; a pid's
    profile needs only its rows), each touching only its share.
    assembly_nodes defaults to the fleet size; a stateful aggregator
    (one with close_window) with assembly_nodes > 1 raises TypeError
    before any work, since each aggregate() would be a window to it.

    Returns (profiles, merged_snapshot). Identical (pid, stack) rows on
    different nodes merge into one row with the summed count; distinct
    rows colliding on the full 64-bit hash would mis-merge, with
    probability ~1e-8 at 1M fleet rows."""
    from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator
    from parca_agent_tpu_torch.capture.formats import (
        STACK_SLOTS,
        WindowSnapshot,
        merge_mapping_tables,
    )
    from parca_agent_tpu_torch.ops.hashing import row_hash_np

    ws = list(node_windows)
    if not ws:
        raise ValueError("fleet_merge_profiles needs at least one window")
    n_nodes = len(ws)
    n_asm = assembly_nodes or n_nodes
    if n_asm > 1 and aggregator is not None \
            and hasattr(aggregator, "close_window"):
        # Fail fast, before the O(rows) merge: a stateful aggregator (the
        # dict family) treats each aggregate() as a window, so feeding it
        # once per pid-partition would advance its window/rotation/
        # last-seen clocks n_asm times per merged window.
        raise TypeError(
            "fleet_merge_profiles with assembly_nodes > 1 requires a "
            "stateless aggregator (e.g. CPUAggregator); got "
            f"{type(aggregator).__name__} with windowed close_window state"
        )
    r = max(max(len(w) for w in ws), 1)
    h1s = np.zeros((n_nodes, r), np.uint32)
    h2s = np.zeros((n_nodes, r), np.uint32)
    counts = np.zeros((n_nodes, r), np.int32)
    node_keys = []
    for node, w in enumerate(ws):
        if len(w) == 0:
            node_keys.append(np.zeros(0, np.uint64))
            continue
        h1, h2 = row_hash_np(w.stacks, w.pids, w.user_len, w.kernel_len)
        h1s[node, : len(w)] = h1
        h2s[node, : len(w)] = h2
        counts[node, : len(w)] = w.counts.astype(np.int32)
        node_keys.append(
            (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64))

    uh1, uh2, uc = fleet_merge_exact64(h1s, h2s, counts, mesh=mesh,
                                       device=device)
    ukey = (uh1.astype(np.uint64) << np.uint64(32)) | uh2.astype(np.uint64)
    u = len(ukey)

    # Join each merged stack id back to a payload row (first node wins;
    # identical ids hold identical payloads by construction of the hash).
    src_node = np.full(u, -1, np.int64)
    src_row = np.zeros(u, np.int64)
    found = np.zeros(u, bool)
    for node, keys in enumerate(node_keys):
        if not len(keys) or found.all():
            continue
        order = np.argsort(keys)
        sk = keys[order]
        pos = np.searchsorted(sk, ukey)
        safe = np.clip(pos, 0, len(sk) - 1)
        hit = (pos < len(sk)) & (sk[safe] == ukey) & ~found
        src_node[hit] = node
        src_row[hit] = order[safe[hit]]
        found |= hit
    if not found.all():
        raise RuntimeError(
            f"{int((~found).sum())} merged stack ids have no payload row"
        )

    pids = np.zeros(u, np.int32)
    tids = np.zeros(u, np.int32)
    ulen = np.zeros(u, np.int32)
    klen = np.zeros(u, np.int32)
    stacks = np.zeros((u, STACK_SLOTS), np.uint64)
    for node, w in enumerate(ws):
        sel = src_node == node
        if not sel.any():
            continue
        rows = src_row[sel]
        pids[sel] = w.pids[rows]
        tids[sel] = w.tids[rows]
        ulen[sel] = w.user_len[rows]
        klen[sel] = w.kernel_len[rows]
        stacks[sel] = w.stacks[rows]

    merged = WindowSnapshot(
        pids=pids, tids=tids, counts=uc.astype(np.int64),
        user_len=ulen, kernel_len=klen, stacks=stacks,
        mappings=merge_mapping_tables([w.mappings for w in ws]),
        period_ns=ws[0].period_ns, window_ns=ws[0].window_ns,
        time_ns=min(w.time_ns for w in ws),
    )
    agg = aggregator if aggregator is not None else CPUAggregator()
    if n_asm <= 1:
        return agg.aggregate(merged), merged
    profiles = []
    for node in range(n_asm):
        sel = (merged.pids % n_asm) == node
        if not sel.any():
            continue
        part = dataclasses.replace(
            merged, pids=merged.pids[sel], tids=merged.tids[sel],
            counts=merged.counts[sel], user_len=merged.user_len[sel],
            kernel_len=merged.kernel_len[sel], stacks=merged.stacks[sel])
        profiles.extend(agg.aggregate(part))
    profiles.sort(key=lambda p: p.pid)  # pid-sorted, like single-node
    return profiles, merged
