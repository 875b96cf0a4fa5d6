"""[PyTorch port: a copy of ``repro.core.topology``, kept here so the port imports
nothing of the JAX package.]

Locality topologies: the one place that maps ids to domains and domains
to distances.

The paper's machines are flat socket sets (every remote socket equally far),
so the seed code hardcoded ``tid % n_sockets`` in three places.  This module
replaces that with named topologies so the same discipline core can serve

  * the paper's machines        — ``two_socket`` / ``four_socket`` / ``flat(n)``,
  * hierarchical fabrics        — ``pod(n_pods, sockets_per_pod)``: sockets
    grouped into pods, cross-pod transfers costlier than cross-socket,
  * arbitrary test schedules    — ``table(assignments)``: an explicit id ->
    domain map (used by the grant-order equivalence tests).

A ``Topology`` answers exactly two questions:

  ``domain_of(tid)``    which leaf locality domain an id lands on
                        (thread -> socket in the lock; request -> KV/prefix
                        home in the serving scheduler);
  ``distance(a, b)``    0 = same domain, 1 = sibling domain (same group),
                        2 = cross-group.  ``xfer_cycles`` maps distances to
                        the cost model's local/remote/cross latencies.

The CNA discipline itself only ever compares domains for equality (the paper's
``socket == my_socket``); distances matter to the *drivers* that charge
transfer costs (``numasim``) or migration penalties (serving engine).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Topology:
    """Leaf domains, their grouping, and the id -> domain placement rule."""

    name: str
    n_domains: int
    # parent group of each domain; flat topologies put every domain in group 0
    # (all sockets mutually "remote", the paper's model).
    group_of: tuple[int, ...]
    # ids map round-robin over domains in blocks of ``block`` (block=1 is the
    # seed's tid % n mapping; block=k places k consecutive ids per domain,
    # i.e. "cores fill a socket before spilling").
    block: int = 1
    # explicit id -> domain table (cycled); overrides the round-robin rule.
    assignment: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if len(self.group_of) != self.n_domains:
            raise ValueError("group_of must have one entry per domain")
        if self.assignment is not None:
            bad = [d for d in self.assignment if not 0 <= d < self.n_domains]
            if bad:
                raise ValueError(f"assignment references unknown domains: {bad}")

    def domain_of(self, tid: int) -> int:
        if self.assignment is not None:
            return self.assignment[tid % len(self.assignment)]
        return (tid // self.block) % self.n_domains

    def distance(self, a: int, b: int) -> int:
        if a == b:
            return 0
        return 1 if self.group_of[a] == self.group_of[b] else 2

    def xfer_cycles(self, cm, a: int, b: int) -> int:
        """Distance-aware cache-line/migration transfer cost under ``cm``."""
        d = self.distance(a, b)
        if d == 0:
            return cm.c_local_xfer
        if d == 1:
            return cm.c_remote_xfer
        return cm.c_cross_xfer


def flat(n_domains: int, name: str | None = None) -> Topology:
    """``n_domains`` mutually-remote domains — the paper's socket model."""
    return Topology(name or f"flat{n_domains}", n_domains, (0,) * n_domains)


def pod(n_pods: int, sockets_per_pod: int, cores_per_socket: int = 1) -> Topology:
    """Two-level fabric: sockets nested in pods.  Same-pod transfers cost
    ``c_remote_xfer``; cross-pod ``c_cross_xfer``.  ``cores_per_socket`` > 1
    switches placement to block mode (consecutive ids share a socket)."""
    n = n_pods * sockets_per_pod
    return Topology(
        f"pod{n_pods}x{sockets_per_pod}",
        n,
        tuple(d // sockets_per_pod for d in range(n)),
        block=cores_per_socket,
    )


def region(n_regions: int, fleets_per_region: int, name: str | None = None) -> Topology:
    """Third hierarchy level: whole fleets nested in geographic regions.

    Structurally a ``pod`` topology one level up — the *domains* are fleets
    and the *groups* are regions — so ``distance`` answers the region
    ladder: 0 = same fleet, 1 = sibling fleet (intra-region fabric),
    2 = cross-region (the expensive hop ``ShipCostModel.fabric_ladder``
    prices separately).  ``repro.region.RegionRouter`` disciplines dispatch
    over this exactly as ``ReplicaRouter`` does over replica topologies."""
    n = n_regions * fleets_per_region
    return Topology(
        name or f"region{n_regions}x{fleets_per_region}",
        n,
        tuple(f // fleets_per_region for f in range(n)),
    )


def table(assignment, n_domains: int | None = None, name: str = "table") -> Topology:
    """Explicit id -> domain schedule (cycled past its length)."""
    assignment = tuple(assignment)
    n = n_domains if n_domains is not None else max(assignment) + 1
    return Topology(name, n, (0,) * n, assignment=assignment)


TWO_SOCKET_TOPO = flat(2, "two_socket")
FOUR_SOCKET_TOPO = flat(4, "four_socket")

TOPOLOGIES = {
    "two_socket": TWO_SOCKET_TOPO,
    "four_socket": FOUR_SOCKET_TOPO,
}


def get_topology(spec) -> Topology:
    """Coerce a Topology | registry name | int (-> flat(n)) to a Topology."""
    if isinstance(spec, Topology):
        return spec
    if isinstance(spec, str):
        try:
            return TOPOLOGIES[spec]
        except KeyError:
            raise KeyError(f"unknown topology {spec!r}; have {sorted(TOPOLOGIES)}") from None
    if isinstance(spec, int):
        return flat(spec)
    raise TypeError(f"cannot interpret {spec!r} as a topology")
