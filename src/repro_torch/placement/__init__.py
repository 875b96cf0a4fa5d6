"""[PyTorch port: a copy of ``repro.placement``, kept here so the port imports
nothing of the JAX package.]

NUMA-aware slot placement, migration accounting, and adaptive concurrency.

The serving stack's allocation layer, built on ``repro.core.topology``:

  ``freelists``   domain-partitioned slot pools with distance-ordered spill
                  (per-socket NUMA allocator free lists);
  ``policy``      pluggable placement: ``lowest_free`` | ``home_domain`` |
                  ``nearest_spill``, pricing misses via ``xfer_cycles``;
  ``controller``  GCR-style ``AdaptiveController`` driving
                  ``RestrictedDiscipline.max_active`` from observed handover
                  latency — shared by the lock simulator and the scheduler;
  ``telemetry``   per-domain occupancy/migration/handover counters surfaced
                  through ``SchedulerMetrics.placement``.
"""

from .controller import AdaptiveController
from .freelists import DomainFreeLists
from .policy import (
    POLICIES,
    HomeDomain,
    LowestFree,
    NearestSpill,
    Placement,
    PlacementPolicy,
    get_policy,
)
from .telemetry import PlacementTelemetry

__all__ = [
    "AdaptiveController",
    "DomainFreeLists",
    "POLICIES",
    "HomeDomain",
    "LowestFree",
    "NearestSpill",
    "Placement",
    "PlacementPolicy",
    "PlacementTelemetry",
    "get_policy",
]
