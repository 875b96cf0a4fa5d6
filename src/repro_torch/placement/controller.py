"""[PyTorch port: a copy of ``repro.placement.controller``, kept here so the port imports
nothing of the JAX package.]

GCR-style adaptive concurrency controller.

"Avoiding Scalability Collapse by Restricting Concurrency" (Dice & Kogan
2019) does not pick the active-set size offline: it watches the lock's own
handover latency and shrinks the active set when handovers start eating
scheduling quanta (the grantee was descheduled), growing it back when they
run at cache-transfer speed.  ``AdaptiveController`` is that feedback loop as
a standalone object so *one implementation* drives both

  * the lock simulator (``repro.core.locks_sim.AdaptiveRCNASim`` — samples
    are handover cycles incl. any preemption penalty), and
  * the serving scheduler (``CNAScheduler(max_active=controller)`` — samples
    are admission-stall ticks: domain-switch + slot-migration cost).

``RestrictedDiscipline`` reads ``controller.cap`` as its live ``max_active``;
drivers feed ``controller.observe(latency)`` after every handover.

Mechanism (deterministic, no wall clock):

  * ``floor`` tracks the cheapest *positive* handover seen, with a slow
    multiplicative relaxation so a one-off lucky sample cannot pin it
    forever — this is the "uncontested handover" baseline, and makes the
    controller scale-free (cycles in the simulator, ticks in the scheduler:
    same code).  Zero-latency samples (a home-domain admission with no
    switch) are trivially cheap: they never count as stalls and never touch
    the floor — a zero floor would otherwise classify *every* positive
    sample as a stall and ratchet the cap to ``min_active``.
  * a handover is a *stall* when it exceeds ``stall_factor * floor +
    deadband`` — in the simulator a preemption adds ``c_preempt`` (~500x a
    local transfer), so the classifier has a wide margin.  ``ewma`` smooths
    the raw latencies (gain ``alpha``) and gates *growth*: a stall-free
    window only raises the cap while the smoothed latency itself sits below
    the stall threshold, so the cap does not creep up while a collapse
    episode is still draining out of the average.
  * every ``window`` samples: shrink the cap by one when stalls exceeded
    ``tolerance``, grow it by one when the window was stall-free.  One slot
    per window is GCR's gentle ramp; it converges from either side and then
    oscillates within one slot of the boundary.  A *majority*-stalled window
    means outright collapse (deep oversubscription: nearly every grantee was
    descheduled), and waiting for -1 steps would take longer than the run —
    the cap shrinks multiplicatively (``collapse_factor``) instead, the AIMD
    shape: gentle probing near the boundary, decisive retreat far above it.

The cap trajectory (one entry per window decision) is recorded for
telemetry, benchmarks, and the cross-driver equivalence test.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AdaptiveController:
    """Adaptive ``max_active`` from observed handover latencies.

    Scale-free by design: samples are whatever unit the driver charges in
    (cycles in the lock simulator, scheduler ticks in the serving engine,
    router ticks in the fleet controller) — only *ratios* against the
    tracked floor matter.  The shrink decision is **windowed stall counts**
    (``window`` samples, ``tolerance`` forgiven); the EWMA does not shrink
    anything — it only *gates growth*, so a stall-free window cannot raise
    the cap while a collapse episode still dominates the smoothed average.
    ``cap`` is a count of concurrently active waiters/admissions."""

    initial: int = 8
    min_active: int = 1
    max_cap: int = 1 << 30
    # EWMA gain for the smoothed-latency growth gate; the shrink decision is
    # windowed stall counts so one outlier cannot flap the cap.
    alpha: float = 1 / 16
    window: int = 32
    stall_factor: float = 8.0
    deadband: float = 0.0
    tolerance: int = 1          # stalls per window forgiven before shrinking
    collapse_factor: float = 0.75  # multiplicative shrink on majority-stalled windows
    floor_relax: float = 1.001  # per-sample upward drift of the floor
    # -- controller-coupled shedding (ROADMAP "controller-coupled placement"):
    # when wired with a live per-domain occupancy view, per-domain slot
    # capacities, and a topology, ``shed_home`` re-homes an admission whose
    # home domain is saturated onto the least-occupied same-group sibling
    # with headroom — load sheds sideways *before* the placement policy's
    # nearest_spill is forced to go cross-group.  All three default to None
    # (shedding off); ``DecodeEngine`` auto-wires them when it runs both a
    # placement-aware slot cache and an adaptive controller.
    occupancy: "object | None" = None      # zero-arg callable -> {domain: claims}
    domain_capacity: "tuple | None" = None  # slots homed per domain
    shed_topology: "object | None" = None   # repro.core.topology.Topology

    cap: int = field(init=False)
    samples: int = field(init=False, default=0)
    stalls: int = field(init=False, default=0)
    ewma: float = field(init=False, default=0.0)
    floor: float = field(init=False, default=0.0)  # 0 = no positive baseline yet
    trajectory: list = field(init=False, default_factory=list)
    _window_stalls: int = field(init=False, default=0)

    def __post_init__(self) -> None:
        if self.min_active < 1:
            raise ValueError("min_active must be >= 1")
        if not self.min_active <= self.initial <= self.max_cap:
            raise ValueError("need min_active <= initial <= max_cap")
        self.cap = self.initial

    def is_stall(self, latency: float) -> bool:
        # no positive baseline yet, or a zero-latency sample: trivially cheap
        if self.floor <= 0.0 or latency <= 0.0:
            return False
        return latency > self.stall_factor * self.floor + self.deadband

    def observe(self, latency: float) -> int:
        """Feed one handover latency sample; returns the (possibly updated)
        cap so call sites can use it inline."""
        if self.samples == 0:
            self.ewma = float(latency)
        else:
            self.ewma += self.alpha * (latency - self.ewma)
        if latency > 0.0:
            if self.floor <= 0.0:
                self.floor = float(latency)
            else:
                self.floor = min(self.floor * self.floor_relax, float(latency))
        self.samples += 1
        if self.is_stall(latency):
            self.stalls += 1
            self._window_stalls += 1
        if self.samples % self.window == 0:
            if 2 * self._window_stalls > self.window:
                self.cap = max(self.min_active, min(self.cap - 1, int(self.cap * self.collapse_factor)))
            elif self._window_stalls > self.tolerance:
                self.cap = max(self.min_active, self.cap - 1)
            elif self._window_stalls == 0 and not self.is_stall(self.ewma):
                self.cap = min(self.max_cap, self.cap + 1)
            self.trajectory.append(self.cap)
            self._window_stalls = 0
        return self.cap

    # -- controller-coupled shedding ------------------------------------------
    def shed_home(self, home: int) -> int:
        """Where a new admission homed at ``home`` should actually go: ``home``
        while it has free capacity, else the least-occupied *same-group*
        sibling with headroom (ties toward the lower domain index).  When the
        whole group is saturated the home is returned unchanged — cross-group
        traffic is the spill policy's decision, priced as a migration, not a
        silent re-home.  No-op (returns ``home``) until occupancy, capacities,
        and a topology are wired."""
        topo = self.shed_topology
        if self.occupancy is None or self.domain_capacity is None or topo is None:
            return home
        occ = self.occupancy()
        if occ.get(home, 0) < self.domain_capacity[home]:
            return home
        siblings = [
            d
            for d in range(topo.n_domains)
            if topo.distance(home, d) == 1 and occ.get(d, 0) < self.domain_capacity[d]
        ]
        if not siblings:
            return home
        return min(siblings, key=lambda d: (occ.get(d, 0), d))

    @property
    def stall_rate(self) -> float:
        return self.stalls / max(1, self.samples)

    def settled_cap(self, tail: float = 0.25) -> int:
        """Median cap over the last ``tail`` fraction of window decisions —
        the "converged" value benchmarks compare to the best static cap."""
        if not self.trajectory:
            return self.cap
        n = max(1, int(len(self.trajectory) * tail))
        last = sorted(self.trajectory[-n:])
        return last[len(last) // 2]
