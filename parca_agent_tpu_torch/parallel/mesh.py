"""The fleet's node axis.

The port's counterpart of parca_agent_tpu/parallel/mesh.py. There, one
logical axis, "node", is a 1-D mesh of devices: each position plays the
role one parca-agent daemon plays in the reference's deployment (a
DaemonSet pod per machine) and owns one machine's capture window. In one
process of the port the node axis is the leading dimension of
[n_nodes, R] tensors on one device, as the sharded dictionary keeps its
shards on one card (aggregator/sharded.py); across processes a node is a
process of the torch.distributed group (parallel/distributed.py).
"""

from __future__ import annotations

import dataclasses

import torch

from parca_agent_tpu_torch.utils.device import resolve_device

# The node axis's name, as the JAX package's mesh axis.
FLEET_AXIS = "node"


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """n_nodes positions along FLEET_AXIS, all on `device`."""

    device: torch.device
    n_nodes: int


def fleet_mesh(n_nodes: int, device: str | torch.device = "cuda"
               ) -> FleetMesh:
    """The node axis of `n_nodes` positions on `device` (resolved by
    utils/device.resolve_device: asking for cuda with no card raises).

    Unlike parca_agent_tpu's fleet_mesh, n_nodes is not capped at the
    number of devices: a node here is a row of the stream tensors, not a
    device, so one card holds any number of them (their merge is one
    kernel over all the rows)."""
    if n_nodes < 1:
        raise ValueError(f"a fleet has at least one node, not {n_nodes}")
    return FleetMesh(resolve_device(device), int(n_nodes))
