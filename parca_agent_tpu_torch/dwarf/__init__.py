"""DWARF call-frame information (reference internal/dwarf/frame, layer L3).

The port's copy of parca_agent_tpu's dwarf/__init__.py.
"""

from parca_agent_tpu_torch.dwarf.frame import (
    CIE,
    FDE,
    FrameError,
    RegRule,
    Row,
    RuleType,
    execute_fde,
    parse_eh_frame,
)

__all__ = [
    "CIE", "FDE", "FrameError", "RegRule", "Row", "RuleType",
    "execute_fde", "parse_eh_frame",
]
