"""The stack dictionary's batch probe: CUDA kernel wrapper and plain version.

Counterpart of parca_agent_tpu/aggregator/pallas_probe.py:make_batch_probe
(and of the probe loop inside aggregator/dict.py:make_feed). Two entry
points, each with a plain PyTorch version beside it:

  batch_probe(table, h1, h2, h3) -> found_id
      up to PROBES linear-probe steps at (h1 + k) & (cap - 1) into the
      resident table; found_id = stored id on a full (h1, h2, h3) match,
      -1 on an empty-slot stop or a chain past the bound.
  feed_accumulate(table, acc, touch, blk, h1, h2, h3, cnt) -> found_id
      the probe fused with the feed's accumulate: every live row
      (cnt > 0) that hits adds cnt to acc[id] and sets touch[id // blk].
      acc and touch are updated in place.

Dispatch is by the tensors' device, and only by it: CUDA tensors launch
the kernel of csrc/feed_probe.cu (a failed build or launch raises), CPU
tensors run the plain version. Nothing falls back.

u32 lanes: the table and the hash lanes are uint32 values carried in int32
tensors bit for bit (a numpy uint32 array viewed as int32 on the way in);
equality on those bits is u32 equality, and the one piece of u32
arithmetic (the probe index) widens to int64 and masks to 32 bits.
"""

from __future__ import annotations

import torch

from parca_agent_tpu_torch.ops import kernels

# Linear-probe bound (csrc/feed_probe.cu kProbes; the JAX package's _PROBES).
PROBES = 16
_U32 = 0xFFFFFFFF

# Kernel launches per entry point: each wrapper adds one where it launches
# its CUDA kernel and nowhere else (the plain version counts nothing).
LAUNCHES = {"batch_probe": 0, "feed_accumulate": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_lanes(table, *lanes) -> None:
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != 4 or not table.is_contiguous():
        raise ValueError("table must be a contiguous int32 [cap, 4] tensor "
                         "(uint32 bits)")
    cap = table.shape[0]
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"table capacity {cap} is not a power of two")
    n = lanes[0].shape[0]
    for x in lanes:
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n \
                or not x.is_contiguous():
            raise ValueError("hash/count lanes must be contiguous int32 [n] "
                             "tensors of one length (uint32 bits)")
        if x.device != table.device:
            raise ValueError(f"lane on {x.device}, table on {table.device}")


# -- plain versions ----------------------------------------------------------


def batch_probe_plain(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                      h3: torch.Tensor) -> torch.Tensor:
    """The probe in plain PyTorch ops (the lax loop of make_feed, step by
    step): int32 [n] found ids."""
    mask = table.shape[0] - 1
    h1w = h1.to(torch.int64) & _U32
    found = torch.full(h1.shape, -1, dtype=torch.int32, device=h1.device)
    done = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    for k in range(PROBES):
        row = table[(h1w + k) & mask]
        occ = row[:, 3] != 0
        hit = occ & (row[:, 0] == h1) & (row[:, 1] == h2) & (row[:, 2] == h3)
        found = torch.where(hit & ~done, row[:, 3] - 1, found)
        done = done | hit | ~occ
    return found


def feed_accumulate_plain(table, acc, touch, blk: int, h1, h2, h3,
                          cnt) -> torch.Tensor:
    """Plain version of feed_accumulate (make_feed's probe + scatter-add
    + touch marking; out-of-range ids dropped like mode="drop")."""
    found = batch_probe_plain(table, h1, h2, h3)
    hit = (found >= 0) & (cnt > 0)
    ids = found[hit].to(torch.int64)
    keep = ids < acc.shape[0]
    acc.index_add_(0, ids[keep], cnt[hit][keep])
    if touch is not None:
        b = ids // blk
        touch[b[b < touch.shape[0]]] = 1
    return found


# -- CUDA kernel wrappers ----------------------------------------------------


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def batch_probe(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                h3: torch.Tensor) -> torch.Tensor:
    """found_id int32 [n]; CUDA tensors launch the kernel, CPU tensors run
    batch_probe_plain."""
    _check_lanes(table, h1, h2, h3)
    if table.device.type == "cpu":
        return batch_probe_plain(table, h1, h2, h3)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    lib = kernels.load("feed_probe")
    n = h1.shape[0]
    found = torch.empty(n, dtype=torch.int32, device=table.device)
    code = lib.pa_batch_probe(
        table.data_ptr(), table.shape[0], h1.data_ptr(), h2.data_ptr(),
        h3.data_ptr(), found.data_ptr(), n, _stream_ptr(table.device))
    kernels.check_launch(lib, code, "batch_probe")
    LAUNCHES["batch_probe"] += 1
    return found


def feed_accumulate(table: torch.Tensor, acc: torch.Tensor,
                    touch: torch.Tensor | None, blk: int, h1: torch.Tensor,
                    h2: torch.Tensor, h3: torch.Tensor,
                    cnt: torch.Tensor) -> torch.Tensor:
    """found_id int32 [n], with acc (int32 [id_cap]) and touch (int32
    [n_blocks] or None) updated in place; CUDA tensors launch the fused
    kernel, CPU tensors run feed_accumulate_plain."""
    _check_lanes(table, h1, h2, h3, cnt)
    for name, t in (("acc", acc), ("touch", touch)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != table.device:
            raise ValueError(f"{name} must be a contiguous int32 [n] tensor "
                             f"on {table.device}")
    if touch is not None and blk <= 0:
        raise ValueError("touch tracking needs a block size > 0")
    if table.device.type == "cpu":
        return feed_accumulate_plain(table, acc, touch, blk, h1, h2, h3, cnt)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    lib = kernels.load("feed_probe")
    n = h1.shape[0]
    found = torch.empty(n, dtype=torch.int32, device=table.device)
    code = lib.pa_feed_accumulate(
        table.data_ptr(), table.shape[0], acc.data_ptr(), acc.shape[0],
        touch.data_ptr() if touch is not None else None,
        touch.shape[0] if touch is not None else 0, max(blk, 1),
        h1.data_ptr(), h2.data_ptr(), h3.data_ptr(), cnt.data_ptr(),
        found.data_ptr(), n, _stream_ptr(table.device))
    kernels.check_launch(lib, code, "feed_accumulate")
    LAUNCHES["feed_accumulate"] += 1
    return found
