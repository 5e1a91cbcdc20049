"""Window aggregation.

  NaiveAggregator dict-based oracle, line by line (aggregator/cpu.py)
  CPUAggregator   vectorized numpy path (aggregator/cpu.py); the oracle
  DictAggregator  stateful stack dictionary resident on the device; a
                  steady window is one batched probe+accumulate kernel per
                  feed and one pack per close (aggregator/dict.py)
  ShardedDictAggregator  the stack dictionary split into home sub-tables
                  (aggregator/sharded.py)
  TPUAggregator   one-shot window program on the device: row hash and
                  location-table kernels, sorts and joins in torch
                  (aggregator/tpu.py)
"""

from parca_agent_tpu_torch.aggregator.base import (  # noqa: F401
    Aggregator,
    PidProfile,
    ProfileMapping,
    WindowProfiles,
)
from parca_agent_tpu_torch.aggregator.cpu import (  # noqa: F401
    CPUAggregator,
    NaiveAggregator,
)
from parca_agent_tpu_torch.aggregator.tpu import TPUAggregator  # noqa: F401
