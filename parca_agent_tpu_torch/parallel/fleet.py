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
      rows (JAX's all_gather is the node axis itself), grouped by key
      (fleet_group: csrc/fleet_merge.cu partitions the rows by their key's
      top bits and reduces each bucket in shared memory, so no row is
      sorted; JAX sorts them all with lax.sort), which dedups identical
      stacks across nodes: each group's key and count sum in key order,
      and the group count. Exact; the correctness oracle for the sketch
      path.

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

The groups' order is JAX's: uint32 keys, and (h1, h2) lexicographically
as unsigned. The 32-bit merge keys a row by the widened key (int64) and
the 64-bit merge by (int32(h1 ^ 2^31) << 32) + h2, whose signed order is
that unsigned order (keys32, keys64); the plain version sorts them with
torch.sort.

Entry points run on the card unless the caller passes device="cpu" (or a
mesh on the CPU), where the kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses
import math

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

# Kernel launches: fleet_group_launch adds one to "fleet_group" where it
# calls pa_fleet_group, which launches the exact merge's first level (three
# kernels: hist, scatter, reduce); _split adds one to "fleet_group_split"
# for each of its launches (minmax, hist, scatter, reduce), so a split on a
# path shows. Nothing else counts (the plain version counts nothing).
LAUNCHES = {"fleet_group": 0, "fleet_group_split": 0}


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


# -- the exact merge's grouping (B8) -----------------------------------------


def keys32(h: torch.Tensor) -> torch.Tensor:
    """Sort keys of u32 hashes (int32 bits): int64 in [0, 2^32)."""
    return u32_wide(h.reshape(-1))


def keys64(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Sort keys of (h1, h2) u32 lanes (int32 bits): int64 whose signed
    order is the lanes' unsigned lexicographic order."""
    top = h1.reshape(-1) ^ torch.iinfo(torch.int32).min  # h1 - 2^31
    return top.to(torch.int64) * (1 << 32) + u32_wide(h2.reshape(-1))


def _check_group(keys: torch.Tensor, counts: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("keys must be int64 [n]")
    if counts.dtype != torch.int32 or counts.shape != keys.shape \
            or counts.device != keys.device:
        raise ValueError("counts must be int32, congruent with keys and on "
                         "their device")
    if keys.numel() == 0:
        raise ValueError("the exact merge needs at least one row")


def fleet_group_plain(keys: torch.Tensor, counts: torch.Tensor,
                      two_lanes: bool):
    """fleet_group's result by chains of torch ops (the kernels' plain
    version): torch.sort of the rows, then each group's first row, key
    and sum. reps and sums have n slots, [:n_groups] meaningful."""
    _check_group(keys, counts)
    keys, order = torch.sort(keys)
    counts = counts[order]
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


# The first level's buckets hold about this many rows (group_bits). A
# bucket fits its reduce CTA (csrc/fleet_merge.cu) by rows, up to 32,768,
# whatever its rows a group: one whose groups overflow the CTA's table is
# partitioned into runs there. More, smaller buckets shorten the scatter's
# runs: chip_smoke.py's sweep of 2^10..2^13 finds 2^10 the fastest at the
# fleet's stream (2^12 on fleets that share few stacks, but 60% slower at
# the stream).
GROUP_BUCKET_ROWS = 8192
# Bits a split level takes below a segment's top differing bit.
SPLIT_BITS = 11
# csrc/fleet_merge.cu's Leaf record (32 bytes) and its flags.
LEAF = np.dtype([("start", "<i8"), ("count", "<i4"), ("flags", "<u4"),
                 ("key", "<u8"), ("sum", "<i4"), ("hbit", "<i4")])
_IN_B, _SINGLE, _OVER = 1, 2, 4
_U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def group_bits(n: int) -> int:
    """The first level's bucket bits for n rows: about GROUP_BUCKET_ROWS
    rows a bucket, from 1 to 13 bits (2^10 buckets of ~8,704 rows at the
    fleet's stream)."""
    return min(13, max(1, round(math.log2(n / GROUP_BUCKET_ROWS))))


@dataclasses.dataclass
class GroupLaunch:
    """What fleet_group_launch queued: the outputs and the first level's
    buffers, which a split level reads."""

    keys_a: torch.Tensor    # int64 [n]: the keys ^ 2^63 in bucket order
    counts_a: torch.Tensor  # int32 [n]
    keys_b: torch.Tensor    # int64 [n]: the reduce's stage, then the split's
    counts_b: torch.Tensor  # int32 [n]   second buffer
    leaves: torch.Tensor    # int64 [2^bits, 4]: LEAF records
    reps_hi: torch.Tensor | None
    reps_lo: torch.Tensor
    sums: torch.Tensor
    info: torch.Tensor      # int32 [2]: n_groups, leaves that did not fit


def fleet_group_launch(keys: torch.Tensor, counts: torch.Tensor,
                       two_lanes: bool, bits: int | None = None) -> GroupLaunch:
    """The exact merge's first level and its reduce on CUDA tensors, with
    no host sync: three launches of csrc/fleet_merge.cu (hist, scatter,
    reduce), counted once under "fleet_group". fleet_group finishes what
    it leaves (info[1] > 0). bits: the first level's bucket bits, 1..13
    (default group_bits(n); chip_smoke.py sweeps it)."""
    _check_group(keys, counts)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"fleet_group_launch takes CUDA tensors, not {dev}")
    if not (keys.is_contiguous() and counts.is_contiguous()):
        raise ValueError("the exact merge's kernels take contiguous keys and "
                         "counts")
    n = keys.numel()
    if n >= 2**31:
        raise ValueError(f"the exact merge takes fewer than 2^31 rows, not {n}")
    bits = group_bits(n) if bits is None else bits
    if not 1 <= bits <= 13:
        raise ValueError(f"the first level takes 1 to 13 bits, not {bits}")
    lib = kernels.load("fleet_merge")
    stream = torch.cuda.current_stream(dev)
    scratch = kernels.epoch_scratch(
        "fleet_merge", dev, stream, lib.pa_fleet_group_scratch_words(1 << bits),
        torch.int64)

    def empty(m, dtype=torch.int32):
        return torch.empty(m, dtype=dtype, device=dev)

    g = GroupLaunch(keys_a=empty(n, torch.int64), counts_a=empty(n),
                    keys_b=empty(n, torch.int64), counts_b=empty(n),
                    leaves=empty((1 << bits, 4), torch.int64),
                    reps_hi=empty(n) if two_lanes else None,
                    reps_lo=empty(n), sums=empty(n), info=empty(2))
    code = lib.pa_fleet_group(
        keys.data_ptr(), counts.data_ptr(), n, bits, int(two_lanes),
        scratch.data_ptr(), g.keys_a.data_ptr(), g.counts_a.data_ptr(),
        g.keys_b.data_ptr(), g.counts_b.data_ptr(), g.leaves.data_ptr(),
        _ptr(g.reps_hi), g.reps_lo.data_ptr(), g.sums.data_ptr(),
        g.info.data_ptr(), stream.cuda_stream)
    kernels.check_launch(lib, code, "fleet_group")
    LAUNCHES["fleet_group"] += 1
    return g


def _ptr(t):
    return None if t is None else t.data_ptr()


def _top_bit(x: np.ndarray) -> np.ndarray:
    """The index of the highest set bit of each uint64 x > 0, as int64."""
    x = x.astype(np.uint64)
    t = np.zeros(len(x), np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        up = (x >> np.uint64(s)) != 0
        t += np.where(up, s, 0)
        x = np.where(up, x >> np.uint64(s), x)
    return t


def _chunks(start: np.ndarray, count: np.ndarray, tile: int) -> np.ndarray:
    """int64 [c, 3]: (begin, end, segment) of tiles of every segment."""
    per = (count + tile - 1) // tile
    seg = np.repeat(np.arange(len(start)), per)
    off = np.arange(len(seg)) - np.repeat(np.cumsum(per) - per, per)
    b = start[seg] + off * tile
    e = np.minimum(b + tile, start[seg] + count[seg])
    return np.stack([b, e, seg], axis=1).astype(np.int64)


def _leaf_records(start, count, flags, key, sums=None,
                  hbit=None) -> np.ndarray:
    out = np.zeros(len(start), LEAF)
    out["start"], out["count"], out["flags"] = start, count, flags
    out["key"] = key
    if sums is not None:
        out["sum"] = sums
    if hbit is not None:
        out["hbit"] = hbit
    return out


def pack_leaves(seg, c, first, lo, hi, hbit, leaf_rows: int):
    """A split level's buckets (segment, rows, first row, key range [lo,
    hi], the bits hbit.. its segment's keys share, in key order) as
    leaves and the next level's segments: small
    buckets (at most half a leaf) are packed by where their rows begin,
    in windows of half a leaf, so that a packed leaf holds fewer than
    leaf_rows rows; a larger bucket is a leaf of its own, or, past
    leaf_rows, a segment of the next level. Returns (LEAF records of the
    nonempty leaves, their key a key none of their rows holds; the
    segments' first rows; their rows)."""
    w = leaf_rows // 2
    small = c <= w
    brk = np.ones(len(c), bool)
    brk[1:] = (seg[1:] != seg[:-1]) | ~small[1:] | ~small[:-1]
    before = np.cumsum(c) - c
    run0 = np.maximum.accumulate(np.where(brk, np.arange(len(c)), 0))
    win = np.where(small, (before - before[run0]) // w, 0)
    brk[1:] |= win[1:] != win[:-1]
    firsts = np.flatnonzero(brk)
    lasts = np.append(firsts[1:] - 1, len(c) - 1)
    lcount = np.add.reduceat(c, firsts)
    lstart = first[firsts]
    big = lcount > leaf_rows
    fit = ~big & (lcount > 0)
    llo, lhi = lo[firsts][fit], hi[lasts][fit]
    leaves = _leaf_records(
        lstart[fit], lcount[fit], 0,
        np.where(lhi != _U64_MAX, lhi + np.uint64(1), llo - np.uint64(1)),
        hbit=hbit[firsts][fit])
    return leaves, lstart[big], lcount[big]


def _split(g: GroupLaunch) -> None:
    """Splits the first level's buckets that did not fit, level by level,
    and reduces every leaf again, in key order, into g's outputs (see
    csrc/fleet_merge.cu). Each level: minmax (a host sync), then, for the
    segments of more than one key, the buckets of the 11 bits below their
    top differing bit (hist, a host sync; scatter into the other buffer),
    packed into leaves and the next level's segments (pack_leaves)."""
    dev = g.keys_a.device
    lib = kernels.load("fleet_merge")
    stream = torch.cuda.current_stream(dev)
    tile = lib.pa_fleet_group_tile()
    leaf_rows = lib.pa_fleet_group_leaf_rows()
    lv = g.leaves.cpu().numpy().view(LEAF).ravel()
    over = (lv["flags"] & _OVER) != 0
    done = [lv[~over & (lv["count"] > 0)]]
    start = lv["start"][over].astype(np.int64)
    count = lv["count"][over].astype(np.int64)
    bufs = [(g.keys_a, g.counts_a), (g.keys_b, g.counts_b)]
    src = 0

    def launch(name, *args):
        kernels.check_launch(lib, getattr(lib, name)(
            *args, stream.cuda_stream), name)
        LAUNCHES["fleet_group_split"] += 1

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    while len(start):
        dst = 1 - src
        (sk, sc), (dk, dc) = bufs[src], bufs[dst]
        chunks = up(_chunks(start, count, tile))
        mins = torch.full((len(start),), -1, dtype=torch.int64, device=dev)
        maxs = torch.zeros(len(start), dtype=torch.int64, device=dev)
        ssum = torch.zeros(len(start), dtype=torch.int32, device=dev)
        launch("pa_fleet_minmax", sk.data_ptr(), sc.data_ptr(),
               chunks.data_ptr(), len(chunks), mins.data_ptr(),
               maxs.data_ptr(), ssum.data_ptr())
        mn = mins.cpu().numpy().view(np.uint64)
        mx = maxs.cpu().numpy().view(np.uint64)
        one = mn == mx
        done.append(_leaf_records(start[one], count[one], _SINGLE, mn[one],
                                  ssum.cpu().numpy()[one]))
        start, count, mn, mx = start[~one], count[~one], mn[~one], mx[~one]
        if not len(start):
            break
        top = _top_bit(mn ^ mx)
        bits = np.minimum(top + 1, SPLIT_BITS)
        shift = top + 1 - bits
        nbk = np.left_shift(1, bits)
        base = np.cumsum(nbk) - nbk
        chunks = up(_chunks(start, count, tile))
        segs = up(np.stack([shift, bits, base], axis=1).astype(np.int64))
        hist = torch.zeros(int(nbk.sum()), dtype=torch.int32, device=dev)
        launch("pa_fleet_hist", sk.data_ptr(), chunks.data_ptr(),
               segs.data_ptr(), len(chunks), hist.data_ptr())
        c = hist.cpu().numpy().astype(np.int64)
        seg = np.repeat(np.arange(len(start)), nbk)
        before = np.cumsum(c) - c
        first = start[seg] + before - before[base][seg]
        cursor = up(first.astype(np.int32))
        launch("pa_fleet_scatter", sk.data_ptr(), sc.data_ptr(),
               chunks.data_ptr(), segs.data_ptr(), len(chunks),
               int(bits.max()), cursor.data_ptr(), dk.data_ptr(),
               dc.data_ptr())
        # Each bucket's key range [lo, hi]: the segment's shared bits above
        # its top differing bit, the bucket's digit, anything below.
        t1 = (top + 1).astype(np.uint64)
        above = np.where(t1 >= 64, np.uint64(0),
                         ~((np.uint64(1) << np.minimum(t1, 63)) - np.uint64(1)))
        sh = shift[seg].astype(np.uint64)
        d = (np.arange(len(c)) - base[seg]).astype(np.uint64)
        lo = (mn[seg] & above[seg]) | (d << sh)
        hi = lo | ((np.uint64(1) << sh) - np.uint64(1))
        fit, start, count = pack_leaves(seg, c, first, lo, hi,
                                        (top + 1)[seg], leaf_rows)
        fit["flags"] = _IN_B if dst == 1 else 0
        done.append(fit)
        src = dst
    leaves = np.concatenate(done)
    leaves = leaves[np.argsort(leaves["start"], kind="stable")]
    up_leaves = up(leaves.view(np.int64))
    scratch = kernels.epoch_scratch(
        "fleet_merge", dev, stream,
        lib.pa_fleet_group_scratch_words(len(leaves)), torch.int64)
    g.info.zero_()
    launch("pa_fleet_reduce", up_leaves.data_ptr(), len(leaves),
           g.keys_a.data_ptr(), g.counts_a.data_ptr(), g.keys_b.data_ptr(),
           g.counts_b.data_ptr(), scratch.data_ptr(), _ptr(g.reps_hi),
           g.reps_lo.data_ptr(), g.sums.data_ptr(), g.info.data_ptr())
    if int(g.info[1].item()) != 0:
        raise RuntimeError("fleet_group: a split leaf did not fit its reduce")


def fleet_group(keys: torch.Tensor, counts: torch.Tensor, two_lanes: bool):
    """The exact merge's grouping of unsorted rows: (reps_hi int32 [n] or
    None, reps_lo int32 [n], sums int32 [n], n_groups int32 [1]). keys are
    keys32's (two_lanes False: in [0, 2^32)) or keys64's; the reps are the
    groups' keys in ascending order as u32 bits (reps_hi: h1 of keys64's
    keys, with two_lanes), the sums int32 sums that wrap, n_groups the
    number of distinct keys; only [:n_groups] of reps and sums is
    meaningful. Equal to _exact_program / _exact_program64's [:n_groups].

    CUDA tensors: fleet_group_launch (the partition and the reduce, three
    launches; a bucket whose groups overflow its CTA's table is
    partitioned into runs in the reduce), then one host sync on info;
    buckets that did not fit a reduce CTA (skewed keys, fleets far larger
    than the stream) are split and reduced again (_split). A failed build
    or launch raises. CPU tensors run fleet_group_plain."""
    _check_group(keys, counts)
    dev = keys.device
    if dev.type == "cpu":
        return fleet_group_plain(keys, counts, two_lanes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g = fleet_group_launch(keys, counts, two_lanes)
    if int(g.info[1].item()) > 0:
        _split(g)
    return g.reps_hi, g.reps_lo, g.sums, g.info[:1]


def merge_rows(keys: torch.Tensor, counts: torch.Tensor, two_lanes: bool):
    """Group, fetch: the groups with a nonzero merged count, in key order,
    as numpy (reps_hi uint32 or None, reps_lo uint32, sums int32). The
    one-process and the distributed exact merges end here."""
    hi, lo, sums, n_groups = fleet_group(keys, counts.reshape(-1), two_lanes)
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
