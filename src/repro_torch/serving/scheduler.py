"""[PyTorch port: a copy of ``repro.serving.scheduler``, kept here so the port imports
nothing of the JAX package.]

CNA continuous-batching admission scheduler.

This is the paper's algorithm carried verbatim into the serving runtime via
``repro.core.policy.CNAAdmissionQueue`` (itself a thin adapter over the shared
``repro.core.discipline`` core):

  paper                      | serving
  ---------------------------+------------------------------------------
  lock                       | a free decode slot (the serialised resource)
  thread                     | a queued request
  NUMA socket of a thread    | the locality domain of the request — the pod
                             | holding its prefix/KV-cache home (caller-given,
                             | or derived from the longest cached prefix by
                             | ``repro.serving.prefixindex`` when a request
                             | is submitted with ``domain=None``)
  socket of the lock holder  | the engine's *current* domain (domain of the
                             | most recently admitted request)
  main queue                 | CNA main queue (arrivals always join it)
  secondary queue            | CNA secondary queue (remote-domain requests
                             | parked by find_successor)
  keep_lock_local threshold  | fairness_threshold (starvation bound)
  remote cache miss          | domain switch => KV/prefix migration cost
  machine topology           | ``repro.core.topology.Topology``: domains are
                             | named positions in a fabric, and a switch's
                             | cost scales with inter-domain *distance*
                             | (same pod vs cross pod), not a constant

State is compact by construction (two deques + a counter), the paper's
argument against per-domain ("cohort") scheduler structures.

``max_active`` enables GCR-style concurrency restriction (admission control):
only that many queued requests circulate in the CNA queues, the rest wait on
a passivation list until slots of the active set drain.  Passing an
``repro.placement.AdaptiveController`` instead of an int turns the cap into
the GCR feedback loop: the engine (or any driver) feeds
``observe_handover(latency)`` after each admission and the cap tracks the
observed handover cost — the *same* controller implementation the lock
simulator's ``cna_rcr_adapt`` drives.

``SchedulerMetrics`` counts domain switches and per-domain service so
benchmarks can reproduce the paper's throughput/fairness trade-off curves in
the serving setting (benchmarks/serving_bench.py); ``metrics.placement``
carries the slot-placement telemetry when the engine runs a placement-aware
``SlotCache``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.policy import CNAAdmissionQueue, FIFOAdmissionQueue
from repro_torch.core.topology import Topology, get_topology
from repro_torch.obs import NULL_TRACER, BoundedHistogram, trace_key


@dataclass
class SchedulerMetrics:
    admitted: int = 0
    local_admits: int = 0
    domain_switches: int = 0
    switch_distance: int = 0   # sum of topology distances over switches
    per_domain: dict = field(default_factory=dict)
    # bounded wait-time reservoir: list-compatible (append/len/index/iterate)
    # but capped, so a long-running serve can't leak one entry per admission;
    # exact quantiles while under the cap (every bench stays under it)
    waits: BoundedHistogram = field(default_factory=BoundedHistogram)
    # slot-placement telemetry (repro.placement.PlacementTelemetry) when the
    # engine runs a placement-aware SlotCache; None otherwise
    placement: object = None

    @property
    def locality(self) -> float:
        return self.local_admits / max(1, self.admitted)

    def fairness_factor(self) -> float:
        """Paper Section 7.1.1, over domains instead of threads."""
        counts = sorted(self.per_domain.values(), reverse=True)
        tot = sum(counts)
        if not counts or tot == 0:
            return 1.0
        half = max(1, len(counts) // 2)
        return sum(counts[:half]) / tot

    def register_into(self, registry, prefix: str = "sched") -> None:
        """Expose this surface through a ``repro.obs.MetricsRegistry`` as
        thin live views — the dataclass stays the single source of truth."""
        registry.adopt(prefix, self, props=("locality",))
        registry.gauge(f"{prefix}_fairness_factor", fn=self.fairness_factor)
        if self.placement is not None:
            self.placement.register_into(registry, prefix=f"{prefix}_placement")


class _BaseScheduler:
    def __init__(self, queue, topology: Topology | None = None, tracer=None):
        self._q = queue
        self.topology = get_topology(topology) if topology is not None else None
        self.current_domain = 0
        self.metrics = SchedulerMetrics()
        self._clock = 0
        # causal span sink (repro.obs.Tracer); NULL_TRACER is falsy, so every
        # instrumentation site below is one truthiness check when disabled
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # distance of the most recent admission's switch (0 when local);
        # the engine charges migration cost from this instead of recomputing
        self.last_admit_distance = 0
        # per-grant distances of the most recent next_batch (see next_batch)
        self.last_batch_distances: list[int] = []

    @property
    def now(self) -> int:
        """Current scheduler tick (public: callers must not poke _clock)."""
        return self._clock

    @property
    def controller(self):
        """The adaptive concurrency controller, or None under a static cap."""
        return self._q.controller

    @property
    def max_active(self) -> int | None:
        return self._q.max_active

    def observe_handover(self, latency) -> None:
        """Feed one admission-handover latency sample (domain-switch stall +
        slot-migration cost, in engine time units) to the adaptive controller;
        no-op without one.  Records into placement telemetry when present."""
        self._q.observe_handover(latency)
        if self.metrics.placement is not None:
            self.metrics.placement.record_handover(latency)

    def fast_ready(self) -> bool:
        """True when the next admission is an uncontended fissile fast-path
        grant (always False without ``fissile=True``) — callers such as the
        fleet router gate their own pipeline bypasses on this, so a skipped
        side effect can only coincide with a grant the discipline core never
        saw either."""
        f = getattr(self._q, "fast_ready", None)
        return f() if f is not None else False

    def fast_peek(self):
        """The ``(request, domain)`` an uncontended fissile fast-path grant
        would admit next, or None — lets the router confirm headroom at the
        request's home before committing to its bypass."""
        f = getattr(self._q, "fast_peek", None)
        out = f() if f is not None else None
        if out is None:
            return None
        (request, _t_submit), domain = out
        return request, domain

    def distance_to(self, domain: int) -> int:
        """Distance of a hypothetical switch from the current domain: 0 when
        local, 1 under a flat (or absent) topology, 2 across groups."""
        if domain == self.current_domain:
            return 0
        if self.topology is None:
            return 1
        return self.topology.distance(self.current_domain, domain)

    def submit(self, request, domain: int):
        if self.topology is not None and not 0 <= domain < self.topology.n_domains:
            raise ValueError(
                f"domain {domain} out of range for topology "
                f"{self.topology.name!r} ({self.topology.n_domains} domains)"
            )
        self._q.push((request, self._clock), domain)

    def __len__(self):
        return len(self._q)

    def next_request(self):
        """Admit the next request into a free slot (or None)."""
        out = self._q.pop(self.current_domain)
        if out is None:
            return None
        (request, t_submit), domain = out
        self.metrics.admitted += 1
        self.metrics.waits.append(self._clock - t_submit)
        self.metrics.per_domain[domain] = self.metrics.per_domain.get(domain, 0) + 1
        local = domain == self.current_domain
        if local:
            self.metrics.local_admits += 1
            self.last_admit_distance = 0
        else:
            self.metrics.domain_switches += 1
            self.last_admit_distance = self.distance_to(domain)
            self.metrics.switch_distance += self.last_admit_distance
            self.current_domain = domain
        if self.tracer:
            g = getattr(self._q, "last_grant", None)
            sp = self.tracer.span(
                "queue_wait", trace_key(request), t_submit, self._clock,
                domain=domain, local=local, distance=self.last_admit_distance,
                kind=getattr(g, "kind", None),
            )
            if g is not None:
                self.tracer.discipline_events(sp, g.events, self._clock)
        return request

    def next_batch(self, k: int) -> list:
        """Grant up to ``k`` requests in admission order — the packer's pack.

        Each grant goes through ``next_request`` so metrics, fairness and
        the current-domain walk are identical to one-at-a-time admission;
        the per-grant switch distances (``last_admit_distance`` snapshots,
        which a batch caller would otherwise lose) are kept in
        ``last_batch_distances`` aligned with the returned list."""
        out = []
        self.last_batch_distances = []
        while len(out) < k:
            req = self.next_request()
            if req is None:
                break
            out.append(req)
            self.last_batch_distances.append(self.last_admit_distance)
        return out

    def tick(self):
        self._clock += 1


class CNAScheduler(_BaseScheduler):
    def __init__(
        self,
        *,
        fairness_threshold: int = 0xFFFF,
        shuffle_reduction: bool = False,
        seed: int = 0xC0A,
        topology: Topology | None = None,
        max_active=None,  # int | repro.placement.AdaptiveController | None
        rotate_after: int = 64,
        fissile: bool = False,  # fissile fast path over the discipline stack
        tracer=None,  # repro.obs.Tracer | None (None => zero-cost off)
    ):
        super().__init__(
            CNAAdmissionQueue(
                threshold=fairness_threshold,
                shuffle_reduction=shuffle_reduction,
                seed=seed,
                max_active=max_active,
                rotate_after=rotate_after,
                fissile=fissile,
            ),
            topology=topology,
            tracer=tracer,
        )


class FIFOScheduler(_BaseScheduler):
    """MCS-admission baseline: strict arrival order, domain-oblivious.

    Takes exactly the kwargs that keep the baseline comparable to
    ``CNAScheduler`` — the topology and the GCR restriction knobs (honoured
    via ``RestrictedDiscipline`` over the FIFO core).  Anything else raises:
    an earlier ``**_`` swallowed unknown kwargs, so ``controller=...`` or a
    misspelled ``fairness_threshold=`` silently ran a different experiment."""

    def __init__(
        self,
        *,
        topology: Topology | None = None,
        max_active=None,  # int | repro.placement.AdaptiveController | None
        rotate_after: int = 64,
        tracer=None,  # repro.obs.Tracer | None (None => zero-cost off)
    ):
        super().__init__(
            FIFOAdmissionQueue(max_active=max_active, rotate_after=rotate_after),
            topology=topology,
            tracer=tracer,
        )
