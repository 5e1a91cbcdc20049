"""Cadence-invariant window-clock conversions (the port's own copy of
parca_agent_tpu/runtime/window_clock.py).

Window-count knobs (such as the dictionary's cold-stack rotation age)
were tuned at the reference agent's 10-second profiling duration. They
are wall-time commitments expressed in reference windows: convert them
with windows_for, so "6 windows" stays ~60 seconds at any
--profiling-duration. At 10 s the conversion is the identity.
"""

from __future__ import annotations

# The cadence every window-count knob was tuned at: the reference
# agent's 10-second profiling duration.
REFERENCE_WINDOW_S = 10.0


def check_window_s(window_s: float) -> float:
    """A usable window length, or ValueError."""
    w = float(window_s)
    if not w > 0.0:
        raise ValueError(f"window_s must be > 0, got {window_s!r}")
    return w


def windows_for(n, window_s: float) -> int:
    """A reference-window count ``n`` as a count of ``window_s``-long
    windows covering the same wall time, never below one window
    (``windows_for(n, 10.0) == n`` for integer ``n``)."""
    w = check_window_s(window_s)
    return max(1, round(float(n) * REFERENCE_WINDOW_S / w))


def per_window(rate, window_s: float) -> float:
    """A per-reference-window budget ``rate`` as a per-``window_s``
    budget (same per-second rate). Exact identity at the reference
    cadence."""
    w = check_window_s(window_s)
    return float(rate) * w / REFERENCE_WINDOW_S
