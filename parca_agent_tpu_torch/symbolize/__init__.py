"""Address -> symbol resolution (reference layer L2).

Agent-side symbolization covers only what cannot be done server-side:
kernel functions (kallsyms) and JITed code (perf maps); everything else
ships normalized addresses + build ids and is symbolized by the server.

The port's copy of parca_agent_tpu's symbolize/__init__.py.
"""

from parca_agent_tpu_torch.symbolize.ksym import KsymCache
from parca_agent_tpu_torch.symbolize.perfmap import PerfMapCache, PerfMapError
from parca_agent_tpu_torch.symbolize.symbolizer import Symbolizer

__all__ = ["KsymCache", "PerfMapCache", "PerfMapError", "Symbolizer"]
