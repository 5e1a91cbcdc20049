"""Capture layer: window snapshot contracts and sample sources.

A WindowSnapshot is the drained state of one aggregation window:
fixed-width, zero-padded arrays that map directly onto device layouts,
produced by pluggable sources (synthetic, replay).
"""

from parca_agent_tpu_torch.capture.formats import (  # noqa: F401
    KERNEL_ADDR_START,
    MAX_STACK_DEPTH,
    STACK_SLOTS,
    MappingTable,
    WindowSnapshot,
    load_snapshot,
    save_snapshot,
)
