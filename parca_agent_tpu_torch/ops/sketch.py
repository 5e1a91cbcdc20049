"""Mergeable sketches: count-min and HyperLogLog (numpy and torch).

The port's own copy of parca_agent_tpu/ops/sketch.py. They are the
dictionary's bounded-memory sideband (aggregator/dict.py, overflow
"sketch": stacks that arrive once the table is full are absorbed here
instead of dropped) and, later, the unit of a fleet merge: count-min
merges with elementwise `+`, HLL with elementwise `max`. Bucket indices
come from the same row hashes as the exact path (ops/hashing.py), so
sketches built on different hosts, or by either package, agree bucket for
bucket.

numpy arrays take the numpy paths, bit for bit as parca_agent_tpu's.
torch tensors (u32 hashes carried as int32 bits, the port's device
convention) give the values of parca_agent_tpu's jnp paths: on a CUDA
tensor cm_build and hll_build launch a sketch build kernel (B6,
csrc/sketch_build.cu: the cluster kernel or the global one, chosen by
shape in sketch_build; a failed build or launch raises), on a CPU tensor
they run its plain torch versions. sketch_build is the fused entry the
fleet merge calls (parallel/fleet.py): the count-min table, the HLL
registers and each node's total of an [n_nodes, R] stream in one launch.
The dictionary's sideband stays on the host (numpy cm_add, hll_build).

Shapes are static: (depth, width) fixed at construction, width a power of
two so bucket extraction is a mask, not a modulo.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from parca_agent_tpu_torch.ops import kernels
from parca_agent_tpu_torch.ops.hashing import mix32, u32_bits, u32_wide

# Distinct fmix32 seed per count-min row; row d uses mix32(h, _ROW_SEEDS[d]).
_MAX_DEPTH = 8
_ROW_SEEDS = tuple(int(x) for x in
                   np.random.default_rng(0x2545F491).integers(1, 1 << 32, _MAX_DEPTH))
# Seed decorrelating the HLL register stream from every count-min row.
_HLL_SEED = 0x5BD1E995
# The kernel keeps a block's HLL registers in shared memory up to this p
# (2^13 int32 = 32 KB); past it they take global atomics.
SHARED_REGS_MAX_P = 13

# The cluster kernel's shape rule (sketch_kernel_for): a CTA holds an eighth
# of a depth row, the HLL registers and its rounds' boxes (CLUSTER_BOXES)
# in at most CLUSTER_SMEM of shared memory, and the stream has at least
# CLUSTER_MIN_ROWS rows: below that the global kernel is the faster
# (chip_smoke.py's sketch_b6_rows line times both from 2^16 to 2^22 rows).
CLUSTER_SMEM = 227 * 1024
CLUSTER_BOXES = 80 * 1024
CLUSTER_MIN_ROWS = 1 << 20

# Kernel launches: the wrapper adds one where it launches a sketch build
# kernel (the global one, "sketch_build", or the cluster one) and nowhere
# else (the plain versions count nothing).
LAUNCHES = {"sketch_build": 0, "sketch_build_cluster": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class CountMinSpec:
    """depth d, width w: point-query overestimate <= e*total/w with
    probability >= 1 - e^-d (standard CM guarantee, Cormode & Muthukrishnan).
    """

    depth: int = 4
    width: int = 1 << 18

    def __post_init__(self):
        if not (1 <= self.depth <= _MAX_DEPTH):
            raise ValueError(f"depth must be in [1, {_MAX_DEPTH}]")
        if self.width & (self.width - 1):
            raise ValueError("width must be a power of two")

    @property
    def epsilon(self) -> float:
        return math.e / self.width

    @property
    def delta(self) -> float:
        return math.exp(-self.depth)


def cm_buckets(hashes, spec: CountMinSpec):
    """Row-bucket indices [depth, N] (int32) for uint32 item hashes [N]."""
    if isinstance(hashes, torch.Tensor):
        rows = [mix32(hashes, _ROW_SEEDS[d]) & (spec.width - 1)
                for d in range(spec.depth)]
        return torch.stack(rows, dim=0).to(torch.int32)
    mask = np.uint32(spec.width - 1)
    rows = [mix32(hashes, _ROW_SEEDS[d]) & mask for d in range(spec.depth)]
    return np.stack(rows, axis=0).astype(np.int32)


def _cm_build_plain(hashes: torch.Tensor, counts: torch.Tensor,
                    spec: CountMinSpec) -> torch.Tensor:
    hashes, counts = hashes.reshape(-1), counts.reshape(-1)
    table = torch.zeros((spec.depth, spec.width), dtype=torch.int32,
                        device=hashes.device)
    src = counts.to(torch.int32).expand(spec.depth, -1)
    return table.scatter_add_(1, cm_buckets(hashes, spec).to(torch.int64),
                              src)


def cm_build(hashes, counts, spec: CountMinSpec):
    """Build a [depth, width] int32 count-min table from an item stream."""
    if isinstance(hashes, torch.Tensor):
        return sketch_build(hashes, counts, spec, None)[0]
    buckets = cm_buckets(hashes, spec)
    table = np.zeros((spec.depth, spec.width), np.int32)
    for d in range(spec.depth):
        np.add.at(table[d], buckets[d], counts.astype(np.int32))
    return table


def cm_query(table, hashes, spec: CountMinSpec):
    """Point-query estimates [N]: min over rows (never underestimates)."""
    buckets = cm_buckets(hashes, spec)
    if isinstance(table, torch.Tensor):
        return table.gather(1, buckets.to(torch.int64)).min(dim=0).values
    ests = [table[d, buckets[d]] for d in range(spec.depth)]
    return np.stack(ests, axis=0).min(axis=0)


def cm_merge(a, b):
    """Merge two tables built with the same spec (linear: summable)."""
    return a + b


def cm_sub(a, b):
    """Subtract table ``b`` from table ``a`` (same spec). Because the
    structure is linear, ``cm_sub(cm_merge(ta, tb), tb)`` is elementwise
    identical to ``ta``, so point queries on the difference keep the
    one-sided guarantee over the stream that built ``ta``. For two
    independent streams, cells can go negative and a point query bounds
    the true difference within +/- epsilon * (total_a + total_b)."""
    return a - b


def cm_add(table, hashes, counts, spec: CountMinSpec) -> None:
    """Accumulate an item stream into an EXISTING host table in place
    (numpy only): the streaming twin of cm_build for long-lived tables,
    such as the dictionary's overflow sideband. Same bucket derivation as
    cm_build, so in-place accumulation, cm_build over the concatenated
    stream and cm_merge of per-batch tables are elementwise identical."""
    b = cm_buckets(np.asarray(hashes, np.uint32), spec)
    counts = np.asarray(counts)
    for d in range(spec.depth):
        np.add.at(table[d], b[d], counts)


@dataclasses.dataclass(frozen=True)
class HLLSpec:
    """2^p registers; relative error ~= 1.04 / sqrt(2^p)."""

    p: int = 12

    def __post_init__(self):
        if not (4 <= self.p <= 18):
            raise ValueError("p must be in [4, 18]")

    @property
    def m(self) -> int:
        return 1 << self.p

    @property
    def rel_error(self) -> float:
        return 1.04 / math.sqrt(self.m)


def _hll_alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def _hll_build_plain(hashes: torch.Tensor, spec: HLLSpec, live):
    h = u32_wide(mix32(hashes.reshape(-1), _HLL_SEED))
    idx = h >> (32 - spec.p)
    suffix = (h << spec.p) & 0xFFFFFFFF  # suffix bits now at the top
    rank = torch.ones(h.shape, dtype=torch.int32, device=h.device)
    found = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for b in range(32 - spec.p):
        bit_set = ((suffix >> (31 - b)) & 1) != 0
        rank = torch.where(~found & ~bit_set, rank + 1, rank)
        found = found | bit_set
    if live is not None:
        rank = torch.where(live.reshape(-1), rank, 0)
    regs = torch.zeros(spec.m, dtype=torch.int32, device=h.device)
    return regs.scatter_reduce_(0, idx, rank, "amax")


def hll_build(hashes, spec: HLLSpec, live=None):
    """Build [m] int32 registers from uint32 item hashes.

    Register index = top p bits; rank = leading-zero count of the remaining
    (32-p)-bit suffix + 1, counted with a shift cascade. Items where
    `live` is False contribute rank 0 (a no-op under scatter-max), so
    fixed-width padded streams need no separate compaction.
    """
    if isinstance(hashes, torch.Tensor):
        return sketch_build(hashes, None, None, spec, live)[1]
    h = mix32(hashes, _HLL_SEED)
    idx = (h >> np.uint32(32 - spec.p)).astype(np.int32)
    suffix = h << np.uint32(spec.p)  # suffix bits now at the top
    # rank = 1 + count of leading zeros in the top (32-p) bits of `suffix`.
    nbits = 32 - spec.p
    rank = np.zeros(h.shape, np.int32) + np.int32(1)
    found = np.zeros(h.shape, bool)
    for b in range(nbits):
        bit_set = (suffix >> np.uint32(31 - b) & np.uint32(1)) != 0
        rank = np.where(~found & ~bit_set, rank + 1, rank)
        found = found | bit_set
    if live is not None:
        rank = np.where(live, rank, 0)
    regs = np.zeros((spec.m,), np.int32)
    np.maximum.at(regs, idx, rank)
    return regs


def _check_stream(hashes, counts, cm_spec, hll_spec, live) -> None:
    if cm_spec is None and hll_spec is None:
        raise ValueError("sketch_build needs a count-min or an HLL spec")
    if hashes.dtype != torch.int32 or hashes.dim() not in (1, 2):
        raise ValueError("hashes must be int32 [R] or [n_nodes, R] (u32 "
                         f"bits), not {hashes.dtype} {tuple(hashes.shape)}")
    if counts is not None and (counts.dtype != torch.int32
                               or counts.shape != hashes.shape
                               or counts.device != hashes.device):
        raise ValueError("counts must be int32, congruent with hashes and "
                         "on their device")
    if cm_spec is not None and counts is None:
        raise ValueError("a count-min table needs counts")
    if isinstance(live, str):
        if live != "counts" or counts is None:
            raise ValueError("live must be None, a bool tensor, or "
                             "'counts' (count > 0) with counts given")
    elif live is not None and (live.dtype != torch.bool
                               or live.shape != hashes.shape
                               or live.device != hashes.device):
        raise ValueError("live must be a bool tensor congruent with hashes "
                         "and on their device")


def _live_mask(counts, live):
    return counts > 0 if isinstance(live, str) else live


def sketch_build_plain(hashes: torch.Tensor, counts, cm_spec, hll_spec,
                       live=None):
    """sketch_build's result by chains of torch ops (the kernel's plain
    version)."""
    _check_stream(hashes, counts, cm_spec, hll_spec, live)
    cm = (_cm_build_plain(hashes, counts, cm_spec)
          if cm_spec is not None else None)
    regs = (_hll_build_plain(hashes, hll_spec, _live_mask(counts, live))
            if hll_spec is not None else None)
    totals = None
    if counts is not None:
        c = counts.reshape(-1, counts.shape[-1]).to(torch.int64)
        totals = u32_bits(c.sum(dim=1))  # int32 sums wrap, as the kernel's
    return cm, regs, totals


def sketch_kernel_for(n_rows: int, cm_spec, hll_spec) -> str:
    """The kernel sketch_build launches for a CUDA stream of n_rows rows:
    "cluster" when the call builds a table, its HLL registers (if any) sit
    in shared memory (p <= SHARED_REGS_MAX_P), an eighth of a depth row,
    the registers and the kernel's boxes fit one CTA's shared memory
    (width <= 2^18 at p <= 12) and n_rows >= CLUSTER_MIN_ROWS; "global"
    otherwise (wider tables, HLL-only calls, small streams). A choice by
    shape: each kernel raises on its own failures."""
    if cm_spec is None or cm_spec.width < 8 or n_rows < CLUSTER_MIN_ROWS:
        return "global"
    regs = 0
    if hll_spec is not None:
        if hll_spec.p > SHARED_REGS_MAX_P:
            return "global"
        regs = 4 << hll_spec.p
    return "cluster" if cm_spec.width // 2 + regs + CLUSTER_BOXES \
        <= CLUSTER_SMEM else "global"


def sketch_build(hashes: torch.Tensor, counts, cm_spec, hll_spec,
                 live=None):
    """The count-min table, the HLL registers and each node's total of
    one stream, in one pass: (cm int32 [depth, width] or None, regs int32
    [m] or None, totals int32 [n_nodes] or None).

    hashes int32 [n_nodes, R] (u32 bits; [R] is one node), counts int32
    of the same shape (None: no table and no totals). cm_spec or hll_spec
    None leaves that sketch out. ``live``: None (every row feeds the
    HLL), a bool tensor of the stream's shape, or "counts" (count > 0,
    the fleet's liveness); a dead row ranks 0, a no-op under max. The
    count-min table takes every row's count (a zero adds nothing), the
    totals are int32 sums that wrap, as the JAX programs' int32 sums.

    CUDA tensors: csrc/sketch_build.cu, by shape (sketch_kernel_for):
    the cluster kernel (the table in a thread-block cluster's distributed
    shared memory, each row's add routed to its owning CTA) or the global
    kernel (its HLL registers in shared memory up to p =
    SHARED_REGS_MAX_P, global atomics past it); a failed build or launch
    raises. CPU tensors run sketch_build_plain. Integer sums and maxima
    are exact in any order, so all give the same words."""
    _check_stream(hashes, counts, cm_spec, hll_spec, live)
    dev = hashes.device
    if dev.type == "cpu":
        return sketch_build_plain(hashes, counts, cm_spec, hll_spec, live)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_nodes = hashes.shape[0] if hashes.dim() == 2 else 1
    r = hashes.shape[-1]
    if n_nodes > 65535:
        raise ValueError(f"the sketch kernel takes at most 65535 nodes, "
                         f"not {n_nodes}")
    for t in (hashes, counts, None if isinstance(live, str) else live):
        if t is not None and not t.is_contiguous():
            raise ValueError("the sketch kernel takes contiguous tensors")
    cm = (torch.zeros((cm_spec.depth, cm_spec.width), dtype=torch.int32,
                      device=dev) if cm_spec is not None else None)
    regs = (torch.zeros(hll_spec.m, dtype=torch.int32, device=dev)
            if hll_spec is not None else None)
    totals = (torch.zeros(n_nodes, dtype=torch.int32, device=dev)
              if counts is not None else None)
    if r == 0 or n_nodes == 0:
        return cm, regs, totals
    mode = 0 if live is None else (2 if isinstance(live, str) else 1)
    seeds = _ROW_SEEDS[:cm_spec.depth] if cm_spec is not None else ()
    seeds = tuple(seeds) + (0,) * (_MAX_DEPTH - len(seeds))
    lib = kernels.load("sketch_build")
    stream = torch.cuda.current_stream(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    live_ptr = ptr(live) if mode == 1 else None
    if sketch_kernel_for(n_nodes * r, cm_spec, hll_spec) == "cluster":
        p = hll_spec.p if hll_spec else 0
        n_parts = lib.pa_sketch_cluster_parts(
            n_nodes, r, cm_spec.depth, cm_spec.width, p, int(regs is not None))
        if n_parts < 0:
            kernels.check_launch(lib, -n_parts, "sketch_build_cluster")
        code = lib.pa_sketch_build_cluster(
            hashes.data_ptr(), counts.data_ptr(), live_ptr, n_nodes, r, mode,
            cm.data_ptr(), cm_spec.depth, cm_spec.width, *seeds, ptr(regs),
            p, _HLL_SEED, ptr(totals), n_parts, stream.cuda_stream)
        kernels.check_launch(lib, code, "sketch_build_cluster")
        LAUNCHES["sketch_build_cluster"] += 1
        return cm, regs, totals
    code = lib.pa_sketch_build(
        hashes.data_ptr(), ptr(counts), live_ptr,
        n_nodes, r, mode, ptr(cm), cm_spec.depth if cm_spec else 0,
        cm_spec.width if cm_spec else 0, *seeds, ptr(regs),
        hll_spec.p if hll_spec else 0, _HLL_SEED,
        int(hll_spec is not None and hll_spec.p <= SHARED_REGS_MAX_P),
        ptr(totals), stream.cuda_stream)
    kernels.check_launch(lib, code, "sketch_build")
    LAUNCHES["sketch_build"] += 1
    return cm, regs, totals


def hll_merge(a, b):
    """Merge registers (idempotent max)."""
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    return np.maximum(a, b)


def hll_estimate(regs, spec: HLLSpec) -> float:
    """Standard HLL estimator with linear-counting small-range correction."""
    if isinstance(regs, torch.Tensor):
        regs = regs.cpu().numpy()
    regs = np.asarray(regs)
    m = spec.m
    raw = _hll_alpha(m) * m * m / float(np.sum(np.exp2(-regs.astype(np.float64))))
    zeros = int(np.sum(regs == 0))
    if raw <= 2.5 * m and zeros:
        return m * math.log(m / zeros)
    return raw
