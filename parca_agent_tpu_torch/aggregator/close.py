"""The dictionary's window close: CUDA kernel wrappers and plain versions.

Counterpart of parca_agent_tpu/aggregator/dict.py:make_close and
make_close_delta, and of aggregator/sharded.py:_sharded_close_program,
bit for bit. All pack the window's accumulator to uint{4,8,16} with an
exact (id, count) overflow sideband and leave it intact, so the host can
re-pack it wider on a misprediction:

  close_pack(acc, n_fetch, width, n_over_buf) -> int32 buffer
  close_pack_delta(acc, touch, n_fetch, width, n_over_buf, n_blk_buf,
                   blk) -> int32 buffer
  close_pack_sharded(acc, n_fetch, width, n_over_buf) -> int32 buffer
      acc int32 [n_shards, id_cap]: close_pack of the int32 sum over the
      shards (wrapping, as the JAX program's psum)

The buffers' layouts are in the plain versions' docstrings (uint32 bits in
int32 tensors, the port's device convention).

Dispatch is by the tensors' device, and only by it: CUDA tensors launch
the kernel of csrc/close_pack.cu, one launch a call (a failed build or
launch raises), CPU tensors run the plain versions, chains of torch ops.
Nothing falls back. The delta kernel takes 128-id touch blocks only (the
dictionary's); the plain delta version takes any block size.
"""

from __future__ import annotations

import torch

from parca_agent_tpu_torch.ops import kernels
from parca_agent_tpu_torch.ops.hashing import u32_bits

_U32 = 0xFFFFFFFF
# The delta kernel's touch block (csrc/close_pack.cu kBlk).
KERNEL_BLOCK = 128

# Kernel launches per entry point: each wrapper adds one where it launches
# its CUDA kernel and nowhere else (the plain versions count nothing).
LAUNCHES = {"close_pack": 0, "close_pack_delta": 0,
            "close_pack_sharded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions ----------------------------------------------------------


def _pack_lanes(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Pack uint{width} values (int64, already clamped) little-endian into
    u32 lanes (int64 [n * width / 32], each < 2^32)."""
    per32 = 32 // width
    shifts = torch.arange(per32, dtype=torch.int64,
                          device=vals.device) * width
    return ((vals & _U32).reshape(-1, per32) << shifts[None, :]).sum(
        dim=1) & _U32


def _compact_into(n_buf: int, mask: torch.Tensor, src: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """Row-order compaction without a host sync: out[j] = src of the j-th
    True lane of `mask` for j < n_buf, `fill` past the True count (lanes
    past n_buf are dropped, as JAX's scatter mode="drop" drops them)."""
    tgt = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask & (tgt < n_buf), tgt, n_buf)
    out = torch.full((n_buf + 1,), fill, dtype=src.dtype, device=src.device)
    out.scatter_(0, tgt, src)
    return out[:n_buf]


def close_pack_plain(acc: torch.Tensor, n_fetch: int, width: int,
                     n_over_buf: int) -> torch.Tensor:
    """Window close, full form, in plain torch ops. Packs acc[:n_fetch]
    to uint{width} with an exact (id, count) overflow sideband; acc is
    left intact. Returns ONE int32 tensor of uint32 bits:
      [ n_fetch*width/32 lanes : packed counts, little-endian within u32
      | n_over_buf             : overflow ids (n_fetch = none)
      | n_over_buf             : overflow counts
      | 1                      : n_overflow (may exceed n_over_buf: retry)
      | 1                      : count mass beyond n_fetch (guard; 0) ]"""
    assert width in (4, 8, 16)
    sentinel = (1 << width) - 1
    dev = acc.device
    head = acc[:n_fetch].to(torch.int64)
    over = head > sentinel - 1
    lanes = _pack_lanes(torch.where(over, sentinel, head), width)
    ids = torch.arange(n_fetch, dtype=torch.int64, device=dev)
    over_id = _compact_into(n_over_buf, over, ids, n_fetch)
    over_val = _compact_into(n_over_buf, over, head & _U32, 0)
    n_over = over.sum().reshape(1)
    tail = acc[n_fetch:].sum(dtype=torch.int64).reshape(1)
    return u32_bits(torch.cat([lanes, over_id, over_val, n_over, tail]))


def close_pack_sharded_plain(acc: torch.Tensor, n_fetch: int, width: int,
                             n_over_buf: int) -> torch.Tensor:
    """The sharded close in plain torch ops: the per-shard accumulators
    (int32 [n_shards, id_cap]) summed in int32, then close_pack_plain's
    buffer of the sum."""
    return close_pack_plain(acc.sum(0, dtype=torch.int32), n_fetch, width,
                            n_over_buf)


def close_pack_delta_plain(acc: torch.Tensor, touch: torch.Tensor,
                           n_fetch: int, width: int, n_over_buf: int,
                           n_blk_buf: int, blk: int) -> torch.Tensor:
    """Window close, delta form, in plain torch ops. Packs ONLY the
    touched blocks; acc is left intact. Returns ONE int32 tensor of uint32
    bits:
      [ n_blk_buf*blk*width/32 lanes : packed counts of touched blocks
      | n_blk_buf                    : touched block ids (nb_prefix = none)
      | n_over_buf                   : overflow GLOBAL ids (n_fetch = none)
      | n_over_buf                   : overflow counts
      | 1 : n_touched blocks (may exceed n_blk_buf: grow / full retry)
      | 1 : n_overflow (may exceed n_over_buf: grow-then-widen retry)
      | 1 : count mass in UNTOUCHED prefix blocks (exactness guard; 0)
      | 1 : count mass beyond n_fetch (guard; 0) ]"""
    assert width in (4, 8, 16)
    assert n_fetch % blk == 0
    sentinel = (1 << width) - 1
    nb_prefix = n_fetch // blk
    dev = acc.device
    t = touch[:nb_prefix] > 0
    n_touched = t.sum().reshape(1)
    blk_ids = _compact_into(
        n_blk_buf, t, torch.arange(nb_prefix, dtype=torch.int64, device=dev),
        nb_prefix)
    live_b = blk_ids < nb_prefix
    safe = torch.clamp(blk_ids, max=nb_prefix - 1)
    gidx = (safe[:, None] * blk
            + torch.arange(blk, dtype=torch.int64, device=dev)[None, :])
    vals = torch.where(live_b[:, None], acc[gidx].to(torch.int64),
                       0).reshape(-1)
    over = vals > sentinel - 1
    lanes = _pack_lanes(torch.where(over, sentinel, vals), width)
    over_id = _compact_into(n_over_buf, over, gidx.reshape(-1), n_fetch)
    over_val = _compact_into(n_over_buf, over, vals & _U32, 0)
    n_over = over.sum().reshape(1)
    # Exactness guards: untouched prefix blocks and the tail beyond
    # n_fetch must both carry zero mass; a nonzero guard sends the host to
    # the full fetch.
    blk_mass = acc[:n_fetch].to(torch.int64).reshape(nb_prefix, blk).sum(1)
    untouched = torch.where(t, 0, blk_mass).sum().reshape(1)
    tail = acc[n_fetch:].sum(dtype=torch.int64).reshape(1)
    return u32_bits(torch.cat([lanes, blk_ids, over_id, over_val,
                               n_touched, n_over, untouched, tail]))


# -- CUDA kernel wrappers ----------------------------------------------------


def _check(acc: torch.Tensor, touch, n_fetch: int, width: int,
           n_over_buf: int) -> None:
    for name, x in (("acc", acc), ("touch", touch)):
        if x is not None and (x.dtype != torch.int32 or x.dim() != 1
                              or not x.is_contiguous()
                              or x.device != acc.device):
            raise ValueError(f"{name} must be a contiguous int32 [n] tensor "
                             f"on {acc.device}")
    if width not in (4, 8, 16):
        raise ValueError(f"width {width} is not 4, 8 or 16")
    if not 0 < n_fetch <= acc.shape[0] or n_fetch % (32 // width):
        raise ValueError(f"n_fetch {n_fetch} must be in (0, {acc.shape[0]}] "
                         f"and a multiple of {32 // width}")
    if n_over_buf < 1:
        raise ValueError(f"n_over_buf {n_over_buf} is not positive")


# One scratch per (device, stream, id_cap), zeroed once when it is created
# and kept: the kernel's status records carry an epoch that the scratch
# holds itself, so it is never cleared between calls. Keyed by the stream,
# so calls on one scratch are in stream order and never overlap.
_SCRATCH: dict = {}


def _scratch(lib, dev: torch.device, stream, id_cap: int) -> torch.Tensor:
    key = (dev.index, stream.cuda_stream, id_cap)
    buf = _SCRATCH.get(key)
    if buf is None:  # zeroed on `stream`, the current one
        buf = _SCRATCH.setdefault(key, torch.zeros(
            lib.pa_close_scratch_words(id_cap), dtype=torch.int32,
            device=dev))
    return buf


def _launch(name: str, acc: torch.Tensor, n_out: int, *args) -> torch.Tensor:
    """Launch the C entry point `name` of csrc/close_pack.cu with `args`,
    then the cached scratch (of acc's last dimension, its ids), an int32
    [n_out] output and the stream."""
    lib = kernels.load("close_pack")
    dev = acc.device
    stream = torch.cuda.current_stream(dev)
    scratch = _scratch(lib, dev, stream, acc.shape[-1])
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    code = getattr(lib, name)(*args, scratch.data_ptr(), out.data_ptr(),
                              stream.cuda_stream)
    kernels.check_launch(lib, code, name)
    return out


def close_pack(acc: torch.Tensor, n_fetch: int, width: int,
               n_over_buf: int) -> torch.Tensor:
    """The full close buffer (close_pack_plain's layout); CUDA tensors
    launch the kernel (one a call), CPU tensors run close_pack_plain."""
    _check(acc, None, n_fetch, width, n_over_buf)
    if acc.device.type == "cpu":
        return close_pack_plain(acc, n_fetch, width, n_over_buf)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    out = _launch("pa_close_pack", acc,
                  n_fetch * width // 32 + 2 * n_over_buf + 2,
                  acc.data_ptr(), acc.shape[0], n_fetch, width, n_over_buf)
    LAUNCHES["close_pack"] += 1
    return out


def close_pack_delta(acc: torch.Tensor, touch: torch.Tensor, n_fetch: int,
                     width: int, n_over_buf: int, n_blk_buf: int,
                     blk: int) -> torch.Tensor:
    """The delta close buffer (close_pack_delta_plain's layout); CUDA
    tensors launch the kernel (one a call; blk must be 128), CPU tensors
    run close_pack_delta_plain."""
    _check(acc, touch, n_fetch, width, n_over_buf)
    if blk < 1 or n_fetch % blk or touch.shape[0] < n_fetch // blk:
        raise ValueError(f"n_fetch {n_fetch} must be a multiple of blk {blk} "
                         f"and touch must flag its {n_fetch // max(blk, 1)} "
                         "blocks")
    if n_blk_buf < 1:
        raise ValueError(f"n_blk_buf {n_blk_buf} is not positive")
    if acc.device.type == "cpu":
        return close_pack_delta_plain(acc, touch, n_fetch, width, n_over_buf,
                                      n_blk_buf, blk)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    if blk != KERNEL_BLOCK:
        raise ValueError(f"the delta close kernel takes {KERNEL_BLOCK}-id "
                         f"blocks, not {blk}")
    out = _launch("pa_close_pack_delta", acc,
                  n_blk_buf * blk * width // 32 + n_blk_buf
                  + 2 * n_over_buf + 4,
                  acc.data_ptr(), touch.data_ptr(), acc.shape[0], n_fetch,
                  width, n_over_buf, n_blk_buf)
    LAUNCHES["close_pack_delta"] += 1
    return out


def close_pack_sharded(acc: torch.Tensor, n_fetch: int, width: int,
                       n_over_buf: int) -> torch.Tensor:
    """The full close buffer of the sum of acc's rows (int32 [n_shards,
    id_cap]); CUDA tensors launch the kernel, which sums the shards as it
    loads each id (one launch a call), CPU tensors run
    close_pack_sharded_plain."""
    if acc.dtype != torch.int32 or acc.dim() != 2 or acc.shape[0] < 1 \
            or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous int32 [n_shards, id_cap] "
                         "tensor")
    _check(acc[0], None, n_fetch, width, n_over_buf)
    if acc.device.type == "cpu":
        return close_pack_sharded_plain(acc, n_fetch, width, n_over_buf)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    out = _launch("pa_close_pack_sharded", acc,
                  n_fetch * width // 32 + 2 * n_over_buf + 2,
                  acc.data_ptr(), acc.shape[0], acc.stride(0), acc.shape[1],
                  n_fetch, width, n_over_buf)
    LAUNCHES["close_pack_sharded"] += 1
    return out
