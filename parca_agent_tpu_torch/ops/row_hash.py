"""The one-shot window's row hash: CUDA kernel wrapper and plain version.

Counterpart of step 1 of parca_agent_tpu/aggregator/tpu.py:_window_kernel:
hash families 0 and 1 (ops/hashing.py) of every padded stack row, over the
lanes [hi x S | lo x S | pid | ulen | klen]:

  row_hash(shi, slo, pid, ulen, klen) -> (h1, h2)
      shi/slo int32 [n, S] and pid int32 [n] are uint32 bits, ulen/klen
      int32 [n]; h1/h2 int32 [n] are uint32 bits.

Dispatch is by the tensors' device, and only by it: CUDA tensors launch
the kernel of csrc/row_hash.cu (a failed build or launch raises), CPU
tensors run row_hash_plain. Nothing falls back. The kernel reads four
frames of a row with one 16-byte load, so on the card S must be a
multiple of 4 and shi/slo 16-byte aligned (STACK_SLOTS = 128 and
PyTorch's allocations are); the wrapper raises on anything else.

The kernel sums each row only up to its depth (ulen + klen): zero lanes
add nothing to a multilinear hash, so it equals the full-width hash of
the plain version for every row that is zero past its depth, which is
what WindowSnapshot's padding contract and pack_window_inputs keep.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from parca_agent_tpu_torch.ops import kernels
from parca_agent_tpu_torch.ops.hashing import (
    fold_u64_rows,
    hash_params,
    multilinear_hash_u32,
)

# Kernel launches: the wrapper adds one where it launches its CUDA kernel
# and nowhere else (the plain version counts nothing).
LAUNCHES = {"row_hash": 0}

# Rows per chunk of the plain version: its [rows, 2S+3] int64 lane matrix
# and the product temporaries stay near 100 MB each at S = 128.
_CHUNK_ROWS = 1 << 15


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(shi, slo, pid, ulen, klen) -> None:
    if shi.dim() != 2 or slo.shape != shi.shape:
        raise ValueError("shi/slo must be [n, S] tensors of one shape")
    n = shi.shape[0]
    for x in (shi, slo, pid, ulen, klen):
        if x.dtype != torch.int32 or not x.is_contiguous() \
                or x.device != shi.device:
            raise ValueError("row hash lanes must be contiguous int32 "
                             "tensors on one device (uint32 bits)")
    for x in (pid, ulen, klen):
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError("pid/ulen/klen must be int32 [n]")


def row_hash_plain(shi: torch.Tensor, slo: torch.Tensor, pid: torch.Tensor,
                   ulen: torch.Tensor, klen: torch.Tensor):
    """The row hash in plain PyTorch ops (fold_u64_rows +
    multilinear_hash_u32 families 0 and 1), over the full width of every
    row, in chunks of rows so that its memory stays bounded."""
    n = shi.shape[0]
    h1 = torch.empty(n, dtype=torch.int32, device=shi.device)
    h2 = torch.empty(n, dtype=torch.int32, device=shi.device)
    for lo in range(0, n, _CHUNK_ROWS):
        hi = min(n, lo + _CHUNK_ROWS)
        lanes = fold_u64_rows(shi[lo:hi], slo[lo:hi],
                              extra=[pid[lo:hi], ulen[lo:hi], klen[lo:hi]])
        h1[lo:hi] = multilinear_hash_u32(lanes, 0)
        h2[lo:hi] = multilinear_hash_u32(lanes, 1)
    return h1, h2


@functools.lru_cache(maxsize=8)
def _coef_table(device: torch.device, slots: int):
    """Families 0 and 1's coefficients u32 [2, 2*slots+3] on `device`, as
    int32 bits, and their two biases."""
    coefs, biases = hash_params(2, slots)
    return (torch.from_numpy(coefs.view(np.int32).copy()).to(device),
            int(biases[0]), int(biases[1]))


def row_hash(shi: torch.Tensor, slo: torch.Tensor, pid: torch.Tensor,
             ulen: torch.Tensor, klen: torch.Tensor):
    """(h1, h2) int32 [n] uint32 bits; CUDA tensors launch the kernel,
    CPU tensors run row_hash_plain."""
    _check(shi, slo, pid, ulen, klen)
    dev = shi.device
    if dev.type == "cpu":
        return row_hash_plain(shi, slo, pid, ulen, klen)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, slots = shi.shape
    if slots % 4 or shi.data_ptr() % 16 or slo.data_ptr() % 16:
        raise ValueError("the row hash kernel reads 4 frames a load: S "
                         f"must be a multiple of 4 (is {slots}) and "
                         "shi/slo 16-byte aligned")
    lib = kernels.load("row_hash")
    coefs, b0, b1 = _coef_table(dev, slots)
    h1 = torch.empty(n, dtype=torch.int32, device=dev)
    h2 = torch.empty(n, dtype=torch.int32, device=dev)
    code = lib.pa_row_hash(
        shi.data_ptr(), slo.data_ptr(), pid.data_ptr(), ulen.data_ptr(),
        klen.data_ptr(), n, slots, coefs.data_ptr(), b0, b1, h1.data_ptr(),
        h2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(lib, code, "row_hash")
    LAUNCHES["row_hash"] += 1
    return h1, h2
