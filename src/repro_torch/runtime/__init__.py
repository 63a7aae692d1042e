"""Runtime layer: the multi-tenant service, fault tolerance and
straggler mitigation."""

from repro_torch.runtime.fault import FaultTolerantLoop, SimulatedFailure
from repro_torch.runtime.service import ContinuousSearchService
from repro_torch.runtime.straggler import TickCoalescer
