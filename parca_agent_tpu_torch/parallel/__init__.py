"""Distributed fleet merge (the port of parca_agent_tpu/parallel/).

Per-node window streams merged into one cluster-wide view: count-min and
HLL sketches (summed, max'd) and the exact per-stack counts (grouped by
key: partitioned by the key's top bits, each bucket reduced), in one
process over the leading node axis of [n_nodes, R] tensors on one device
(fleet.py, mesh.py), or across agent processes
over a torch.distributed group (distributed.py), with the runtime merge
actor FleetWindowMerger (BASELINE config #5).
"""

from parca_agent_tpu_torch.parallel.distributed import (
    CollectiveTimeout,
    FleetJoinError,
    FleetWindowMerger,
    fleet_initialize,
    fleet_merge_exact64_dist,
    fleet_merge_sketches_dist,
    local_fleet_mesh,
)
from parca_agent_tpu_torch.parallel.fleet import (
    FleetMergeSpec,
    fleet_merge_exact,
    fleet_merge_sketches,
)
from parca_agent_tpu_torch.parallel.mesh import fleet_mesh

__all__ = [
    "FleetMergeSpec",
    "fleet_merge_sketches",
    "fleet_merge_exact",
    "fleet_mesh",
    "CollectiveTimeout",
    "FleetJoinError",
    "FleetWindowMerger",
    "fleet_initialize",
    "fleet_merge_exact64_dist",
    "fleet_merge_sketches_dist",
    "local_fleet_mesh",
]
