"""Vectorized ragged-array helpers (numpy, no per-run Python)."""

from __future__ import annotations

import numpy as np


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
