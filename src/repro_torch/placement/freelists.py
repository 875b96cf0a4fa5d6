"""[PyTorch port: a copy of ``repro.placement.freelists``, kept here so the port imports
nothing of the JAX package.]

Domain-partitioned free lists over a ``Topology``.

A NUMA allocator does not keep one global free list: each socket owns a pool
of local pages, and an allocation that cannot be satisfied locally spills to
the *nearest* socket (Linux's zonelist fallback order).  This module is that
structure for decode-cache slots: every slot has a fixed home domain (the
topology's placement rule — round-robin or block, exactly how the simulator
places threads on sockets), each domain keeps its free slots in a min-heap,
and ``claim_nearest`` walks domains in precomputed (distance, index) order.

The heaps keep claims O(log n_slots); release is a heap push plus an O(1)
double-free check against a free-slot *set* kept alongside the heaps (an
earlier version scanned the home pool's heap list for membership, an O(n)
walk that contradicted this bound).  Lowest-slot-first within a domain keeps
placement deterministic for tests.
"""

from __future__ import annotations

import heapq

from repro_torch.core.topology import Topology, get_topology


class DomainFreeLists:
    """Per-domain slot pools with distance-ordered spill."""

    def __init__(self, n_slots: int, topology: Topology, slot_domain=None) -> None:
        self.topology = get_topology(topology)
        self.n_slots = n_slots
        if slot_domain is None:
            slot_domain = [self.topology.domain_of(s) for s in range(n_slots)]
        else:
            slot_domain = list(slot_domain)
            if len(slot_domain) != n_slots:
                raise ValueError("slot_domain must have one entry per slot")
            bad = [d for d in slot_domain if not 0 <= d < self.topology.n_domains]
            if bad:
                raise ValueError(f"slot_domain references unknown domains: {bad}")
        self.slot_domain = tuple(slot_domain)
        self._pools: list[list[int]] = [[] for _ in range(self.topology.n_domains)]
        for slot in range(n_slots):
            heapq.heappush(self._pools[self.slot_domain[slot]], slot)
        # mirror of the heaps' contents: O(1) membership for the release-path
        # double-free check (and the free count)
        self._free_set: set[int] = set(range(n_slots))
        # Linux-zonelist-style fallback order: for each home domain, every
        # domain sorted by (distance from home, domain index).
        n = self.topology.n_domains
        self.spill_order = tuple(
            tuple(sorted(range(n), key=lambda d: (self.topology.distance(home, d), d)))
            for home in range(n)
        )

    def __len__(self) -> int:
        return len(self._free_set)

    @property
    def domain_capacity(self) -> tuple[int, ...]:
        """Total slots homed in each domain (free or claimed) — the capacity
        the shed coupling compares occupancy against."""
        caps = [0] * self.topology.n_domains
        for d in self.slot_domain:
            caps[d] += 1
        return tuple(caps)

    def free_count(self, domain: int) -> int:
        return len(self._pools[domain])

    def free_slots(self) -> list[int]:
        """All free slots, ascending (introspection/tests; not the hot path)."""
        return sorted(self._free_set)

    def _pop(self, domain: int) -> int:
        slot = heapq.heappop(self._pools[domain])
        self._free_set.discard(slot)
        return slot

    def claim_in(self, domain: int) -> int | None:
        """Pop the lowest free slot homed in ``domain`` (None if exhausted)."""
        if not self._pools[domain]:
            return None
        return self._pop(domain)

    def claim_nearest(self, home: int) -> tuple[int, int] | None:
        """Pop a free slot from the nearest non-empty domain to ``home``;
        returns ``(slot, slot_domain)`` or None when everything is claimed."""
        for dom in self.spill_order[home]:
            if self._pools[dom]:
                return self._pop(dom), dom
        return None

    def claim_lowest(self) -> tuple[int, int] | None:
        """Pop the globally lowest free slot (the seed baseline's rule),
        regardless of domain; returns ``(slot, slot_domain)``."""
        best = None
        for dom, pool in enumerate(self._pools):
            if pool and (best is None or pool[0] < self._pools[best][0]):
                best = dom
        if best is None:
            return None
        return self._pop(best), best

    def release(self, slot: int) -> int:
        """Return ``slot`` to its home pool; returns that domain.  The
        double-free check is O(1) against the free set, not a pool scan."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free_set:
            raise ValueError(f"slot {slot} is already free")
        dom = self.slot_domain[slot]
        heapq.heappush(self._pools[dom], slot)
        self._free_set.add(slot)
        return dom
