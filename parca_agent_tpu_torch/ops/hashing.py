"""Row hashing: the 96-bit stack identity the dictionary keys on, and the
window row hash of the one-shot aggregator (numpy and torch).

Everything works on uint32 lanes; 64-bit addresses travel as (hi, lo)
uint32 pairs. The workhorse is a multilinear hash family
h(x) = b + sum_i a_i * x_i (mod 2^32) with fixed random odd coefficients:
pairwise collision probability <= 2^-32 per independent hash. The
coefficient tables come from fixed numpy seeds, so hashes are stable
across processes, hosts and packages: parca_agent_tpu's row hash (its
numpy path and its native kernel) gives the same bits for the same rows.

mix32, multilinear_hash_u32 and fold_u64_rows take numpy arrays or torch
tensors and answer in kind, as parca_agent_tpu's take numpy or jax arrays.
Torch has no uint32 arithmetic to rely on (int32 ``>>`` is arithmetic,
and an int64 product of two u32 lanes overflows), so the torch paths
widen each lane to int64 in [0, 2^32), split every product into 16-bit
halves that are masked before they are summed, and return u32 values as
int32 tensors of the same bits (the port's device convention).
"""

from __future__ import annotations

import numpy as np
import torch

# Enough coefficient lanes for [hi | lo | pid | user_len | kernel_len].
_MAX_LANES = 2 * 128 + 8
# Independent hash families: 3 for the dictionary aggregator's 96-bit
# identity (its bucket index is family 0), one spare. Each family draws
# from its OWN seeded stream so adding families can never shift another
# family's constants.
N_FAMILIES = 4


def _family_rng(k: int) -> np.random.Generator:
    return np.random.default_rng([0x9E3779B9, k])


# Odd coefficients make x -> a*x a bijection mod 2^32.
_COEFS = np.stack([
    _family_rng(k).integers(0, 1 << 32, _MAX_LANES, dtype=np.uint64)
    .astype(np.uint32) | np.uint32(1)
    for k in range(N_FAMILIES)
])
_BIASES = np.array([
    int(np.random.default_rng([0x2545F491, k]).integers(
        0, 1 << 32, dtype=np.uint64))
    for k in range(N_FAMILIES)
], np.uint32)


_U32 = 0xFFFFFFFF


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32, as int32 tensors of the same bits."""
    x = x & _U32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def u32_wide(x: torch.Tensor) -> torch.Tensor:
    """u32 lanes (int32 bits, or any integer tensor taken mod 2^32) as
    int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _U32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for int64 a, b in [0, 2^32), with no product past
    2^49: b splits into 16-bit halves and the high half's product is
    masked to 16 bits before it is shifted up."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _U32


def _mix32_torch(x: torch.Tensor, seed: int) -> torch.Tensor:
    x = u32_wide(x) ^ (seed & _U32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return u32_bits(x)


def mix32(x, seed: int = 0):
    """fmix32 finalizer (murmur3-style): avalanche a uint32 lane."""
    if isinstance(x, torch.Tensor):
        return _mix32_torch(x, seed)
    x = x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def multilinear_hash_u32(lanes, which: int):
    """Hash uint32 lane matrix [N, K] -> uint32 [N] with hash family `which`.

    Modular arithmetic wraps naturally in uint32; the final mix decorrelates
    the low bits so the result can be truncated for bucket indices. A torch
    tensor (int32 bits or int64) gives an int32 tensor of the same bits.
    """
    k = lanes.shape[-1]
    if k > _MAX_LANES:
        raise ValueError(f"too many lanes to hash: {k} > {_MAX_LANES}")
    if isinstance(lanes, torch.Tensor):
        c = torch.from_numpy(_COEFS[which, :k].astype(np.int64)).to(
            lanes.device)
        # Products below 2^32, summed over at most _MAX_LANES lanes.
        acc = _mul32(u32_wide(lanes), c).sum(-1)
        return _mix32_torch(acc + int(_BIASES[which]), 0)
    coefs = _COEFS[which, :k]
    acc = (lanes.astype(np.uint32) * coefs[None, :]).sum(axis=-1,
                                                         dtype=np.uint32)
    return mix32(acc + _BIASES[which])


def fold_u64_rows(hi, lo, extra=None):
    """Interleave (hi, lo) uint32 matrices [N, S] (+ optional scalar columns
    [N] each) into one lane matrix for multilinear_hash_u32 (torch: int64
    lanes in [0, 2^32))."""
    if isinstance(hi, torch.Tensor):
        cols = [u32_wide(hi), u32_wide(lo)]
        if extra:
            cols.append(torch.stack([u32_wide(c) for c in extra], dim=-1))
        return torch.cat(cols, dim=-1)
    cols = [hi.astype(np.uint32), lo.astype(np.uint32)]
    if extra:
        cols.append(np.stack([c.astype(np.uint32) for c in extra], axis=-1))
    return np.concatenate(cols, axis=-1)


def hash_params(n_hashes: int, slots: int):
    """Contiguous (coefs [n_hashes, 2*slots+3], biases [n_hashes]) slices
    of the seeded multilinear family — the tables a capture source that
    stamps h1/h2/h3 at drain time installs so its carry matches
    row_hash_np bit for bit."""
    if not 1 <= n_hashes <= N_FAMILIES:
        raise ValueError(f"n_hashes out of range: {n_hashes}")
    k = 2 * slots + 3
    if k > _MAX_LANES:
        raise ValueError(f"too many lanes to hash: {k} > {_MAX_LANES}")
    return (np.ascontiguousarray(_COEFS[:n_hashes, :k]),
            np.ascontiguousarray(_BIASES[:n_hashes]))


def row_hash_np(stacks_u64: np.ndarray, pids, user_len, kernel_len,
                n_hashes: int = 2):
    """Hash every padded snapshot row [pid | user_len | kernel_len |
    frames] with families 0..n_hashes-1; returns a tuple of uint32 [N]."""
    stacks_u64 = np.asarray(stacks_u64, np.uint64)
    hi = (stacks_u64 >> np.uint64(32)).astype(np.uint32)
    lo = stacks_u64.astype(np.uint32)
    lanes = fold_u64_rows(
        hi,
        lo,
        extra=[
            np.asarray(pids, np.uint32),
            np.asarray(user_len, np.uint32),
            np.asarray(kernel_len, np.uint32),
        ],
    )
    return tuple(multilinear_hash_u32(lanes, k) for k in range(n_hashes))
