"""[PyTorch port: a copy of ``repro.placement.policy``, kept here so the port imports
nothing of the JAX package.]

Pluggable slot-placement policies over ``DomainFreeLists``.

Where the admission scheduler decides *when* a request runs (the paper's
lock-handover order), the placement policy decides *where* its decode cache
lives.  A slot in the request's KV/prefix home domain costs nothing extra; a
slot elsewhere charges a distance-aware migration (the prefix/KV blocks move
across the fabric once, at claim time) priced by ``Topology.xfer_cycles`` —
the same local/remote/cross ladder the lock simulator charges for cache-line
transfers.

Policies:

  ``lowest_free``     the seed baseline: globally lowest free slot, blind to
                      domains (kept as the benchmarks' control arm);
  ``home_domain``     home pool first, otherwise fall back to the global
                      lowest slot (locality when easy, no search otherwise);
  ``nearest_spill``   home pool first, then nearest-domain spill in
                      (distance, index) order — the NUMA-allocator rule.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.numasim import TWO_SOCKET, CostModel

from .freelists import DomainFreeLists


@dataclass(frozen=True)
class Placement:
    """One placement decision: where the slot landed and what the miss cost."""

    slot: int
    slot_domain: int
    home_domain: int
    distance: int
    migration_cycles: int

    @property
    def local(self) -> bool:
        return self.distance == 0


class PlacementPolicy:
    """Strategy interface: pick a free slot for a request homed in ``home``."""

    name = "base"

    def pick(self, pools: DomainFreeLists, home: int) -> tuple[int, int] | None:
        raise NotImplementedError

    def place(
        self, pools: DomainFreeLists, home: int, cm: CostModel | None = None
    ) -> Placement | None:
        """Claim a slot for ``home`` and price the migration; None when full."""
        out = self.pick(pools, home)
        if out is None:
            return None
        slot, dom = out
        topo = pools.topology
        dist = topo.distance(home, dom)
        cycles = 0 if dist == 0 else topo.xfer_cycles(cm or TWO_SOCKET, home, dom)
        return Placement(slot, dom, home, dist, cycles)


class LowestFree(PlacementPolicy):
    name = "lowest_free"

    def pick(self, pools: DomainFreeLists, home: int):
        return pools.claim_lowest()


class HomeDomain(PlacementPolicy):
    name = "home_domain"

    def pick(self, pools: DomainFreeLists, home: int):
        slot = pools.claim_in(home)
        if slot is not None:
            return slot, home
        return pools.claim_lowest()


class NearestSpill(PlacementPolicy):
    name = "nearest_spill"

    def pick(self, pools: DomainFreeLists, home: int):
        return pools.claim_nearest(home)


POLICIES = {cls.name: cls for cls in (LowestFree, HomeDomain, NearestSpill)}


def get_policy(spec) -> PlacementPolicy:
    """Coerce a PlacementPolicy | registry name | class to a policy instance."""
    if isinstance(spec, PlacementPolicy):
        return spec
    if isinstance(spec, type) and issubclass(spec, PlacementPolicy):
        return spec()
    if isinstance(spec, str):
        try:
            return POLICIES[spec]()
        except KeyError:
            raise KeyError(f"unknown placement policy {spec!r}; have {sorted(POLICIES)}") from None
    raise TypeError(f"cannot interpret {spec!r} as a placement policy")
