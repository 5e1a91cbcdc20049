"""Debuginfo extract/find/upload (reference pkg/debuginfo, layer L4).

The port's copy of parca_agent_tpu's debuginfo/__init__.py.
"""

from parca_agent_tpu_torch.debuginfo.find import Finder
from parca_agent_tpu_torch.debuginfo.extract import extract_debuginfo, KEEP_SECTIONS
from parca_agent_tpu_torch.debuginfo.manager import (
    DebuginfoClient,
    DebuginfoManager,
    NoopClient,
)

__all__ = [
    "Finder", "extract_debuginfo", "KEEP_SECTIONS",
    "DebuginfoClient", "DebuginfoManager", "NoopClient",
]
