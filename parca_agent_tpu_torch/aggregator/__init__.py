"""Window aggregation.

  CPUAggregator   vectorized numpy path (aggregator/cpu.py); the oracle
  DictAggregator  stateful stack dictionary resident on the device; a
                  steady window is one batched probe+accumulate kernel per
                  feed and one pack per close (aggregator/dict.py)
"""

from parca_agent_tpu_torch.aggregator.base import (  # noqa: F401
    Aggregator,
    PidProfile,
    ProfileMapping,
    WindowProfiles,
)
from parca_agent_tpu_torch.aggregator.cpu import CPUAggregator  # noqa: F401
