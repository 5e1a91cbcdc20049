"""Vectorized protobuf varint primitives and ragged-array helpers (numpy,
no per-value Python).

The window encoder (pprof/window_encoder.py) batch-encodes tens of
millions of varints a window with whole-array passes: compute every
varint's byte length, cumsum to positions, then write byte k of every
value in pass k (at most 10 passes; the selection shrinks geometrically
because most varints are short).

These helpers implement exactly the proto wire contract of
proto.put_varint (unsigned LEB128; int64 negatives are encoded by the
caller pre-masking to two's-complement uint64, as proto.put_varint does).
They are numpy only: parca_agent_tpu's native emission kernel
(native/vecenc.cc) has no copy here.
"""

from __future__ import annotations

import numpy as np

# varint byte-length thresholds: value >= 2^(7k) needs more than k bytes.
_THRESHOLDS = np.array([1 << (7 * k) for k in range(1, 10)], np.uint64)


def varint_len(vals: np.ndarray) -> np.ndarray:
    """int32 [N] byte length of each value's varint encoding (1..10)."""
    vals = np.ascontiguousarray(vals, np.uint64)
    lens = np.ones(len(vals), np.int32)
    for t in _THRESHOLDS:
        # Thresholds are increasing: once nothing clears one, nothing
        # clears the rest.
        more = vals >= t
        if not more.any():
            break
        lens += more.astype(np.int32)
    return lens


def _check_positions(pos: np.ndarray, n_vals: int) -> None:
    """A short `pos` or a negative position would write the wrong bytes
    (numpy wraps negative indices): reject both."""
    if len(pos) != n_vals:
        raise IndexError(f"pos has {len(pos)} entries for {n_vals} values")
    if len(pos) and int(np.min(pos)) < 0:
        raise IndexError("negative varint position")


def put_varints(out: np.ndarray, pos: np.ndarray, vals: np.ndarray,
                lens: np.ndarray | None = None) -> None:
    """Scatter varint encodings of vals into uint8 buffer `out` at byte
    positions `pos` (each value's encoding occupies pos[i]..pos[i]+len-1).

    Caller guarantees the regions were sized with varint_len and do not
    overlap. Byte k of every encoding is written in one vectorized pass.
    """
    vals = np.ascontiguousarray(vals, np.uint64)
    pos = np.ascontiguousarray(pos, np.int64)
    _check_positions(pos, len(vals))
    if lens is None:
        lens = varint_len(vals)
    sel = np.arange(len(vals))
    k = 0
    while len(sel):
        v = vals[sel]
        b = ((v >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (lens[sel] > k + 1)
        out[pos[sel] + k] = b | (cont.astype(np.uint8) << 7)
        sel = sel[cont]
        k += 1


def put_varints_padded(out: np.ndarray, pos: np.ndarray, vals: np.ndarray,
                       width: int) -> None:
    """Scatter FIXED-WIDTH varint encodings: every value occupies exactly
    `width` bytes via non-minimal encoding (continuation bit set on all but
    the last byte; trailing zero septets are legal protobuf and decode to
    the same value). A fixed width makes a serialized message's layout
    independent of the values, which is what lets the window encoder patch
    counts into a cached template instead of re-serializing. Caller must
    pick width >= varint_len(max value) (5 covers uint32, 10 covers any
    uint64)."""
    if not 1 <= width <= 10:
        raise ValueError(f"padded varint width must be in 1..10, got {width}")
    vals = np.ascontiguousarray(vals, np.uint64)
    pos = np.ascontiguousarray(pos, np.int64)
    _check_positions(pos, len(vals))
    for k in range(width):
        b = ((vals >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        if k < width - 1:
            b |= np.uint8(0x80)
        out[pos + k] = b


def encode_varint_stream(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode values back-to-back: (flat uint8 buffer, int64 offsets[N+1])."""
    lens = varint_len(vals)
    offs = np.zeros(len(vals) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    out = np.empty(int(offs[-1]), np.uint8)
    put_varints(out, offs[:-1], vals, lens)
    return out, offs


def ragged_gather(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  out: np.ndarray | None = None,
                  out_starts: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Gather variable-length runs flat[starts[i] : starts[i]+lens[i]] into
    one contiguous buffer (or scatter them to caller-chosen out_starts).

    Returns (out, out_offsets[N+1]) where out_offsets is the packed layout
    (exclusive cumsum of lens); when out_starts is given the runs land
    there instead and out_offsets is out_starts re-returned unchanged.
    """
    lens = np.ascontiguousarray(lens, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    packed = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=packed[1:])
    n_total = int(packed[-1])
    if out_starts is None:
        offs = packed
        dst = packed[:-1]
        total = n_total
    else:
        offs = out_starts
        dst = np.ascontiguousarray(out_starts, np.int64)
        total = int((dst + lens).max(initial=0))
    if out is None:
        out = np.empty(total, flat.dtype)
    if n_total:
        # within-run index for every output element, then one fancy gather.
        within = np.arange(n_total, dtype=np.int64) - np.repeat(
            packed[:-1], lens)
        src = np.repeat(starts, lens) + within
        if out_starts is None:
            out[:n_total] = flat[src]
        else:
            out[np.repeat(dst, lens) + within] = flat[src]
    return out, offs
