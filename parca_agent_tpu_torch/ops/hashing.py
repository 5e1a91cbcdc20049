"""Row hashing: the 96-bit stack identity the dictionary keys on (numpy).

Everything works on uint32 lanes; 64-bit addresses travel as (hi, lo)
uint32 pairs. The workhorse is a multilinear hash family
h(x) = b + sum_i a_i * x_i (mod 2^32) with fixed random odd coefficients:
pairwise collision probability <= 2^-32 per independent hash. The
coefficient tables come from fixed numpy seeds, so hashes are stable
across processes, hosts and packages: parca_agent_tpu's row hash (its
numpy path and its native kernel) gives the same bits for the same rows.
"""

from __future__ import annotations

import numpy as np

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


def mix32(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """fmix32 finalizer (murmur3-style): avalanche a uint32 lane."""
    x = x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def multilinear_hash_u32(lanes: np.ndarray, which: int) -> np.ndarray:
    """Hash uint32 lane matrix [N, K] -> uint32 [N] with hash family `which`.

    Modular arithmetic wraps naturally in uint32; the final mix decorrelates
    the low bits so the result can be truncated for bucket indices.
    """
    k = lanes.shape[-1]
    if k > _MAX_LANES:
        raise ValueError(f"too many lanes to hash: {k} > {_MAX_LANES}")
    coefs = _COEFS[which, :k]
    acc = (lanes.astype(np.uint32) * coefs[None, :]).sum(axis=-1,
                                                         dtype=np.uint32)
    return mix32(acc + _BIASES[which])


def fold_u64_rows(hi, lo, extra=None) -> np.ndarray:
    """Interleave (hi, lo) uint32 matrices [N, S] (+ optional scalar columns
    [N] each) into one lane matrix for multilinear_hash_u32."""
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
