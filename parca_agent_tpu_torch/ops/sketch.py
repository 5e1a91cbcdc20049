"""Mergeable sketches: count-min and HyperLogLog (numpy and torch).

The port's own copy of parca_agent_tpu/ops/sketch.py. They are the
dictionary's bounded-memory sideband (aggregator/dict.py, overflow
"sketch": stacks that arrive once the table is full are absorbed here
instead of dropped) and, later, the unit of a fleet merge: count-min
merges with elementwise `+`, HLL with elementwise `max`. Bucket indices
come from the same row hashes as the exact path (ops/hashing.py), so
sketches built on different hosts, or by either package, agree bucket for
bucket.

numpy arrays take the numpy paths, bit for bit as parca_agent_tpu's;
torch tensors take plain torch paths (u32 hashes carried as int32 bits,
the port's device convention), which give the same values as
parca_agent_tpu's jnp paths. Nothing on the dictionary's path launches
the torch paths yet.

Shapes are static: (depth, width) fixed at construction, width a power of
two so bucket extraction is a mask, not a modulo.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from parca_agent_tpu_torch.ops.hashing import mix32, u32_wide

# Distinct fmix32 seed per count-min row; row d uses mix32(h, _ROW_SEEDS[d]).
_MAX_DEPTH = 8
_ROW_SEEDS = tuple(int(x) for x in
                   np.random.default_rng(0x2545F491).integers(1, 1 << 32, _MAX_DEPTH))
# Seed decorrelating the HLL register stream from every count-min row.
_HLL_SEED = 0x5BD1E995


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


def cm_build(hashes, counts, spec: CountMinSpec):
    """Build a [depth, width] int32 count-min table from an item stream."""
    buckets = cm_buckets(hashes, spec)
    if isinstance(hashes, torch.Tensor):
        table = torch.zeros((spec.depth, spec.width), dtype=torch.int32,
                            device=hashes.device)
        src = counts.to(torch.int32).expand(spec.depth, -1)
        return table.scatter_add_(1, buckets.to(torch.int64), src)
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


def _hll_build_torch(hashes: torch.Tensor, spec: HLLSpec, live):
    h = u32_wide(mix32(hashes, _HLL_SEED))
    idx = h >> (32 - spec.p)
    suffix = (h << spec.p) & 0xFFFFFFFF  # suffix bits now at the top
    rank = torch.ones(h.shape, dtype=torch.int32, device=h.device)
    found = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for b in range(32 - spec.p):
        bit_set = ((suffix >> (31 - b)) & 1) != 0
        rank = torch.where(~found & ~bit_set, rank + 1, rank)
        found = found | bit_set
    if live is not None:
        rank = torch.where(live, rank, 0)
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
        return _hll_build_torch(hashes, spec, live)
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
