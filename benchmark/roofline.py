"""The yardstick's peaks and byte counts.

Peaks are NVIDIA's H100 SXM data sheet's (the rate at the full 700 W
power limit; a card set lower reads lower shares, so each run prints its
power limit). Bytes count what the inputs need, whatever implements the
work: each input byte read once and each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

# A drain row as the dictionary's feed needs it: the 12-byte identity
# key (three 32-bit hashes) and its 32-bit count read once, and the
# stack's 32-bit window count read and written once.
FEED_KEY_BYTES = 16
FEED_COUNT_BYTES = 8
# A window's close: each stack's 32-bit count read once, and its (32-bit
# id, 32-bit count) pair written once to the packed buffer.
CLOSE_READ_BYTES = 4
CLOSE_WRITE_BYTES = 8


def feed_bytes(rows: int) -> int:
    """Least bytes a feed of `rows` distinct drain rows moves."""
    return rows * (FEED_KEY_BYTES + FEED_COUNT_BYTES)


def close_bytes(stacks: int) -> int:
    """Least bytes a close of `stacks` accumulated stacks moves."""
    return stacks * (CLOSE_READ_BYTES + CLOSE_WRITE_BYTES)


def share_pct(nbytes: int, device_s: float) -> float | None:
    """Percent of the bandwidth roofline: the least time the bytes need
    over the device time taken; None without device time."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return nbytes / HBM_BYTES_PER_S / device_s * 100.0
