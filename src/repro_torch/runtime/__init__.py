"""Runtime layer: the multi-tenant service, replica-sharded serving,
fault tolerance and straggler mitigation."""

from repro_torch.runtime.fault import FaultTolerantLoop, SimulatedFailure
from repro_torch.runtime.mesh import (
    LoadBalancedPlacement,
    MeshTickStats,
    PlacementPolicy,
    RoundRobinPlacement,
    ShardedSearchService,
    build_mesh_slot_tick,
)
from repro_torch.runtime.service import ContinuousSearchService
from repro_torch.runtime.straggler import TickCoalescer
