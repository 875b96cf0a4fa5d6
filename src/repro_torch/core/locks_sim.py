"""[PyTorch port: a copy of ``repro.core.locks_sim``, kept here so the port imports
nothing of the JAX package.]

Lock disciplines implemented against the discrete-event NUMA simulator.

Implemented locks (paper Section 7 evaluates this exact menagerie):

  * ``TASSim``        — test-and-set, global spinning (related work §2)
  * ``TicketSim``     — FIFO ticket lock, global spinning
  * ``HBOSim``        — hierarchical backoff lock (Radovic & Hagersten)
  * ``MCSSim``        — MCS queue lock: the paper's baseline
  * ``CNASim``        — the paper's contribution (two queues + fairness threshold)
  * ``CNAOptSim``     — CNA + Section-6 shuffle-reduction optimization
  * ``FissileCNASim`` — CNA behind a fissile fast path (arXiv 2003.05025):
                        uncontended grants bypass the two-queue core
  * ``RCNASim``       — CNA under GCR-style concurrency restriction
  * ``AdaptiveRCNASim`` — RCNA with the cap driven online by the shared
                        ``repro.placement.AdaptiveController``
  * ``CohortSim``     — C-BO-MCS: per-socket MCS under a global backoff-TAS
  * ``HMCSSim``       — hierarchical MCS (Chabbi et al.)

Each lock charges handover latencies through ``sim.charge_xfer`` (which also
feeds the remote-transfer counters behind the paper's LLC-miss-rate figure).
The CNA variants are thin drivers of ``repro.core.discipline``: the queue
splicing lives in the shared core, and this module only consumes its typed
events to charge ``c_scan_*`` / transfer costs into the simulator — which is
what makes CNASim's grant order *identical* (not just similar) to
``repro.core.cna.CNALock`` and ``repro.core.policy.CNAAdmissionQueue`` on a
common schedule and seed (tests/test_discipline.py).
"""

from __future__ import annotations

from collections import deque

from .discipline import (
    THRESHOLD,
    THRESHOLD2,
    CNADiscipline,
    Park,
    RestrictedDiscipline,
    Scan,
    SecondaryFlush,
    Shuffle,
    Unpark,
)
from .numasim import LockSim


class MCSSim(LockSim):
    name = "mcs"

    def __init__(self, sim) -> None:
        super().__init__(sim)
        self.queue: deque[int] = deque()
        self.holder: int | None = None

    def arrive(self, tid: int):
        if self.holder is None and not self.queue:
            self.holder = tid
            return self.cm.c_atomic
        self.queue.append(tid)
        return None

    def release(self, tid: int):
        if not self.queue:
            self.holder = None
            return None
        nxt = self.queue.popleft()
        self.holder = nxt
        cost = self.sim.charge_xfer(self.socket(tid), self.socket(nxt))
        return nxt, cost


class CNASim(LockSim):
    """Driver of the shared CNA core: the event loop's only jobs are the
    uncontended fast path and turning the core's typed events into cycle
    charges (``Scan`` -> ``c_scan_*`` + remote-transfer counters,
    ``Shuffle``/``SecondaryFlush`` -> queue-restructuring stats)."""

    name = "cna"
    shuffle_reduction = False

    def __init__(self, sim, threshold: int = THRESHOLD, threshold2: int = THRESHOLD2) -> None:
        super().__init__(sim)
        # the core draws from the simulator's RNG so runs stay bit-reproducible
        self.core = self._make_core(
            CNADiscipline(
                threshold=threshold,
                shuffle_reduction=self.shuffle_reduction,
                threshold2=threshold2,
                rng=sim.rng,
            )
        )
        self.holder: int | None = None

    def _make_core(self, inner):
        return inner

    def arrive(self, tid: int):
        if self.holder is None and not len(self.core):
            # Lock word free: single SWAP, exactly MCS's uncontended path.
            # (CNA's extra fields are touched only under contention — L10.)
            self.holder = tid
            return self.cm.c_atomic
        self._consume(self.core.arrive(tid, self.socket(tid)))
        return None

    def _consume(self, events) -> int:
        """Fold core events into simulator accounting; returns extra cycles."""
        cost = 0
        for ev in events:
            if isinstance(ev, Scan):
                # find_successor touches each inspected waiter's cache line
                cost += ev.n_local * self.cm.c_scan_local + ev.n_remote * self.cm.c_scan_remote
                self.sim.result.remote_transfers += ev.n_remote
            elif isinstance(ev, (Shuffle, SecondaryFlush)):
                self.sim.result.shuffles += 1
            elif isinstance(ev, Park):
                self.parked.add(ev.item)
            elif isinstance(ev, Unpark):
                self.parked.discard(ev.item)
        return cost

    def release(self, tid: int):
        g = self.core.release(self.socket(tid))
        if g is None:
            self.holder = None
            return None
        extra = self._consume(g.events)
        self.holder = g.item
        return g.item, extra + self.sim.charge_xfer(self.socket(tid), self.socket(g.item))


class CNAOptSim(CNASim):
    name = "cna_opt"
    shuffle_reduction = True


class FissileCNASim(CNASim):
    """CNA behind the fissile fast path (Dice & Kogan, arXiv 2003.05025): the
    core is ``FissileDiscipline(CNADiscipline)``, so an uncontended waiter
    occupies the single fast slot and is granted without a ``decide()`` call
    (zero RNG draws, zero scan charges), and the first contended arrival
    inflates to the full two-queue state.  At saturation the wrapper is
    bitwise-identical to ``CNASim`` on the same seed — the fourth column of
    the cross-driver grant-order contract (tests/test_discipline.py)."""

    name = "cna_fissile"

    def _make_core(self, inner):
        from .discipline import FissileDiscipline

        return FissileDiscipline(inner)


class RCNASim(CNASim):
    """CNA + GCR-style concurrency restriction: at most ``max_active`` waiters
    spin in the CNA queues; the rest park (non-runnable, so they don't count
    against ``n_cores`` in the simulator's oversubscription model).  Defaults
    leave two cores of headroom for the holder and threads in their
    non-critical sections."""

    name = "cna_rcr"

    def __init__(
        self,
        sim,
        threshold: int = THRESHOLD,
        threshold2: int = THRESHOLD2,
        max_active: int | None = None,
        rotate_after: int = 64,
    ) -> None:
        if max_active is None:
            max_active = max(1, (sim.n_cores or 10) - 2)
        self._max_active = max_active
        self._rotate_after = rotate_after
        super().__init__(sim, threshold=threshold, threshold2=threshold2)

    def _make_core(self, inner):
        return RestrictedDiscipline(
            inner, max_active=self._max_active, rotate_after=self._rotate_after
        )


class AdaptiveRCNASim(RCNASim):
    """RCNA whose ``max_active`` is driven online by an ``AdaptiveController``
    (repro.placement) instead of a static cap: the event loop reports every
    handover's total latency (``observe_handover``), the controller classifies
    preemption-stalled handovers against its cheap-handover floor, and the
    active-set cap walks toward the collapse boundary from either side.  The
    same controller object (and code path) drives ``CNAScheduler``, which is
    what the cross-driver cap-trajectory test pins down."""

    name = "cna_rcr_adapt"

    def __init__(
        self,
        sim,
        threshold: int = THRESHOLD,
        threshold2: int = THRESHOLD2,
        controller=None,
        rotate_after: int = 64,
    ) -> None:
        if controller is None:
            from repro_torch.placement.controller import AdaptiveController

            # start unrestricted: GCR's default posture is "no cap until the
            # handover latencies say otherwise"
            controller = AdaptiveController(initial=sim.n_threads, max_cap=sim.n_threads)
        self.controller = controller
        super().__init__(
            sim,
            threshold=threshold,
            threshold2=threshold2,
            max_active=controller,
            rotate_after=rotate_after,
        )

    def observe_handover(self, cycles: int) -> None:
        self.controller.observe(cycles)


class TASSim(LockSim):
    """Global-spinning test-and-set.  Handover suffers a coherence storm that
    grows with the spinner count; the winner is biased to the releaser's
    socket (the line lands in that LLC first) => unfair."""

    name = "tas"
    local_bias = 4.0
    storm_scale = 1.0

    def __init__(self, sim) -> None:
        super().__init__(sim)
        self.spinners: list[int] = []
        self.holder: int | None = None

    def arrive(self, tid: int):
        if self.holder is None and not self.spinners:
            self.holder = tid
            return self.cm.c_atomic
        self.spinners.append(tid)
        return None

    def _pick(self, releaser_socket: int) -> int:
        weights = [
            self.local_bias if self.socket(t) == releaser_socket else 1.0
            for t in self.spinners
        ]
        total = sum(weights)
        r = self.rng.random() * total
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if r <= acc:
                return i
        return len(self.spinners) - 1

    def release(self, tid: int):
        if not self.spinners:
            self.holder = None
            return None
        s = self.socket(tid)
        idx = self._pick(s)
        nxt = self.spinners.pop(idx)
        self.holder = nxt
        n = len(self.spinners)
        # every spinner re-fetches the line => storm; remote spinners miss.
        remote_spin = sum(1 for t in self.spinners if self.socket(t) != s)
        self.sim.result.remote_transfers += remote_spin
        self.sim.result.local_transfers += n - remote_spin
        cost = self.sim.charge_xfer(s, self.socket(nxt)) + int(
            self.cm.c_storm * self.storm_scale * n
        )
        return nxt, cost


class TicketSim(TASSim):
    """FIFO grant order, but still global spinning => storms without bias."""

    name = "ticket"

    def release(self, tid: int):
        if not self.spinners:
            self.holder = None
            return None
        s = self.socket(tid)
        nxt = self.spinners.pop(0)
        self.holder = nxt
        n = len(self.spinners)
        remote_spin = sum(1 for t in self.spinners if self.socket(t) != s)
        self.sim.result.remote_transfers += remote_spin
        self.sim.result.local_transfers += n - remote_spin
        cost = self.sim.charge_xfer(s, self.socket(nxt)) + int(self.cm.c_storm * n)
        return nxt, cost


class HBOSim(TASSim):
    """Hierarchical backoff (Radovic & Hagersten): remote spinners back off to
    long waits => strong same-socket bias, reduced storm, poor fairness, and a
    polling-latency penalty when the lock does cross sockets."""

    name = "hbo"
    storm_scale = 0.35

    def _pick(self, releaser_socket: int) -> int:
        # Exponential backoff on remote spinners => a remote thread wins only
        # when no same-socket spinner exists at release time.  This is the
        # starvation behaviour the paper (and HBO's authors) report.
        local = [i for i, t in enumerate(self.spinners) if self.socket(t) == releaser_socket]
        if local:
            return self.rng.choice(local)
        return self.rng.randrange(len(self.spinners))

    def release(self, tid: int):
        out = super().release(tid)
        if out is None:
            return None
        nxt, cost = out
        if self.socket(nxt) != self.socket(tid):
            cost += 2 * self.cm.c_remote_xfer  # missed backoff polling window
        return nxt, cost


class CohortSim(LockSim):
    """C-BO-MCS cohort lock: per-socket MCS queues under a global backoff-TAS.

    The uncontended path takes two atomics (local MCS swap + global TAS), which
    is exactly why the paper's Fig. 6 shows hierarchical locks losing to
    MCS/CNA at one thread."""

    name = "c-bo-mcs"
    batch_limit = 64

    def __init__(self, sim, batch_limit: int | None = None) -> None:
        super().__init__(sim)
        self.local: dict[int, deque[int]] = {s: deque() for s in range(sim.n_sockets)}
        self.owner_socket: int | None = None
        self.holder: int | None = None
        self.batch = 0
        if batch_limit is not None:
            self.batch_limit = batch_limit

    def arrive(self, tid: int):
        if self.holder is None and all(not q for q in self.local.values()):
            self.holder = tid
            self.owner_socket = self.socket(tid)
            self.batch = 1
            return 2 * self.cm.c_atomic + self.cm.c_l1
        self.local[self.socket(tid)].append(tid)
        return None

    def _pick_next_socket(self, releaser_socket: int) -> int | None:
        # The global lock is a *backoff* test-and-set: when the batch limit
        # forces a global release, a waiter on the releaser's own socket
        # re-acquires it before remote sockets finish their backoff window —
        # this is exactly the starvation behaviour the paper observes for
        # C-BO-MCS (fairness factor near 1, Fig. 8).
        sockets = [s for s, q in self.local.items() if q]
        if not sockets:
            return None
        if releaser_socket in sockets:
            return releaser_socket
        return self.rng.choice(sockets)

    def release(self, tid: int):
        s = self.socket(tid)
        q = self.local[s]
        if q and self.batch < self.batch_limit:
            nxt = q.popleft()
            self.holder = nxt
            self.batch += 1
            return nxt, self.sim.charge_xfer(s, s)
        nxt_socket = self._pick_next_socket(s)
        if nxt_socket is None:
            self.holder = None
            self.owner_socket = None
            return None
        nxt = self.local[nxt_socket].popleft()
        self.holder = nxt
        self.owner_socket = nxt_socket
        self.batch = 1
        cost = self.sim.charge_xfer(s, nxt_socket) + self.cm.c_remote_xfer  # backoff window
        return nxt, cost


class HMCSSim(CohortSim):
    """HMCS: per-socket MCS queues under a global MCS of sockets (FIFO across
    sockets) => cohort-like throughput with near-MCS fairness."""

    name = "hmcs"

    def __init__(self, sim, batch_limit: int | None = None) -> None:
        super().__init__(sim, batch_limit)
        self.socket_fifo: deque[int] = deque()

    def arrive(self, tid: int):
        out = super().arrive(tid)
        s = self.socket(tid)
        if out is None and s not in self.socket_fifo and self.owner_socket != s:
            self.socket_fifo.append(s)
        return out

    def release(self, tid: int):
        s = self.socket(tid)
        q = self.local[s]
        if q and self.batch < self.batch_limit:
            nxt = q.popleft()
            self.holder = nxt
            self.batch += 1
            return nxt, self.sim.charge_xfer(s, s)
        # pass the global MCS to the next socket in FIFO order
        while self.socket_fifo:
            nxt_socket = self.socket_fifo.popleft()
            if self.local[nxt_socket]:
                nxt = self.local[nxt_socket].popleft()
                self.holder = nxt
                self.owner_socket = nxt_socket
                self.batch = 1
                if q:  # our socket still has waiters: requeue it
                    self.socket_fifo.append(s)
                # two-level handover: global MCS link + local grant
                cost = self.sim.charge_xfer(s, nxt_socket) + self.cm.c_local_xfer
                return nxt, cost
        if q:
            nxt = q.popleft()
            self.holder = nxt
            self.batch = 1
            return nxt, self.sim.charge_xfer(s, s)
        self.holder = None
        self.owner_socket = None
        return None


ALL_LOCKS = {
    cls.name: cls
    for cls in [
        TASSim, TicketSim, HBOSim, MCSSim, CNASim, CNAOptSim, FissileCNASim,
        RCNASim, AdaptiveRCNASim, CohortSim, HMCSSim,
    ]
}
