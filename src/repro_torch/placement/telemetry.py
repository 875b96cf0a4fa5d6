"""[PyTorch port: a copy of ``repro.placement.telemetry``, kept here so the port imports
nothing of the JAX package.]

Per-domain placement/migration/handover counters.

One telemetry object rides with a placement-aware ``SlotCache`` and is
surfaced through ``SchedulerMetrics.placement`` so serving benchmarks can put
locality, spill behaviour, and migration spend next to the admission-side
counters they already report.  Everything is a plain counter — no wall clock,
no sampling — so runs stay deterministic and comparable.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PlacementTelemetry:
    n_domains: int = 1
    placements: int = 0
    local_placements: int = 0
    sibling_spills: int = 0        # distance 1: same group, different domain
    cross_spills: int = 0          # distance 2: crossed a group boundary
    migration_cycles: int = 0
    releases: int = 0
    handover_samples: int = 0
    handover_cycles: int = 0
    # controller-coupled shedding: admissions re-homed to a sibling because
    # the derived home was saturated (shed-before-spill)
    sheds: int = 0
    # prefix-index coupling: how often homes were derived (vs caller-given)
    # and what fraction of prompt tokens the index had cached
    derived_homes: int = 0
    prefix_hit_tokens: int = 0
    prefix_lookup_tokens: int = 0
    per_domain_placements: dict = field(default_factory=dict)
    per_domain_occupancy: dict = field(default_factory=dict)  # live claims
    peak_occupancy: dict = field(default_factory=dict)
    # releases for domains with no live recorded placement (double release or
    # a release routed to the wrong domain); counted, never applied — the
    # derived-home tie-breaks read per_domain_occupancy and a negative entry
    # would bias them toward a domain that was never occupied
    unmatched_releases: int = 0

    @property
    def locality(self) -> float:
        return self.local_placements / max(1, self.placements)

    @property
    def spills(self) -> int:
        return self.sibling_spills + self.cross_spills

    @property
    def mean_handover(self) -> float:
        return self.handover_cycles / max(1, self.handover_samples)

    def record_placement(self, placement) -> None:
        self.placements += 1
        dom = placement.slot_domain
        self.per_domain_placements[dom] = self.per_domain_placements.get(dom, 0) + 1
        occ = self.per_domain_occupancy.get(dom, 0) + 1
        self.per_domain_occupancy[dom] = occ
        self.peak_occupancy[dom] = max(self.peak_occupancy.get(dom, 0), occ)
        if placement.distance == 0:
            self.local_placements += 1
        elif placement.distance == 1:
            self.sibling_spills += 1
        else:
            self.cross_spills += 1
        self.migration_cycles += placement.migration_cycles

    def record_release(self, slot_domain: int) -> None:
        self.releases += 1
        occ = self.per_domain_occupancy.get(slot_domain, 0)
        if occ <= 0:
            self.unmatched_releases += 1
            return
        self.per_domain_occupancy[slot_domain] = occ - 1

    def record_shed(self) -> None:
        self.sheds += 1

    def record_handover(self, latency) -> None:
        self.handover_samples += 1
        self.handover_cycles += int(latency)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of derived-home prompt tokens the index had cached."""
        return self.prefix_hit_tokens / max(1, self.prefix_lookup_tokens)

    def record_derived_home(self, matched_len: int, prompt_len: int) -> None:
        self.derived_homes += 1
        self.prefix_hit_tokens += matched_len
        self.prefix_lookup_tokens += prompt_len

    def fairness_factor(self) -> float:
        """Top-half share of placements across domains (same convention as
        ``SimResult.fairness_factor``; 1/n_domains-ish = balanced)."""
        counts = sorted(self.per_domain_placements.values(), reverse=True)
        tot = sum(counts)
        if not counts or tot == 0:
            return 1.0
        half = max(1, len(counts) // 2)
        return sum(counts[:half]) / tot

    def register_into(self, registry, prefix: str = "placement") -> None:
        """Expose this surface through a ``repro.obs.MetricsRegistry`` as
        thin live views (no counter moves; the registry reads through)."""
        registry.adopt(
            prefix, self,
            props=("locality", "spills", "mean_handover", "prefix_hit_rate"),
        )
        registry.gauge(f"{prefix}_fairness_factor", fn=self.fairness_factor)
